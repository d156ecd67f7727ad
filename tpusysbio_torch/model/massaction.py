"""Mass-action reaction networks, batched over a leading member dimension.

Port of ``tpusysbio/model/massaction.py``. A network is two small integer
matrices:

- ``reactants`` (n_reactions, n_species): exponents of the rate monomials,
- ``stoich``    (n_species, n_reactions): net stoichiometry,

and the RHS is ``S @ (k * prod(y ** R))``. Every function here takes a
leading batch dimension: ``y`` is ``(B, n)``, ``p`` is ``(B, n_reactions)``
and ``t`` is ``(B,)``; results are ``(B, ...)``. They follow the device and
dtype of ``y``.

As in the reference, the monomials use branchless repeated multiplication
(exponents 0..3) instead of ``pow``, so ``0^0 = 1``, and the exclusive
product over the other species uses forward/backward cumulative products
with no division, exact at zero concentrations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class MassActionNetwork:
    """Static description of a mass-action network.

    ``reactants[j, i]`` = exponent of species i in reaction j's rate law;
    ``stoich[i, j]``    = net change of species i in reaction j.
    Rate constant of reaction j is ``p[:, j]`` (one parameter per reaction).
    Both matrices are int64 tensors; the functions below use copies on the
    device of their inputs (cached per device).
    """

    species: Tuple[str, ...]
    reaction_names: Tuple[str, ...]
    reactants: torch.Tensor   # (n_reactions, n_species) int64
    stoich: torch.Tensor      # (n_species, n_reactions) int64
    _cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_species(self) -> int:
        return len(self.species)

    @property
    def n_reactions(self) -> int:
        return self.reactants.shape[0]

    def _mats(self, y: torch.Tensor):
        """``(R, S)`` on ``y``'s device, ``S`` in ``y``'s dtype."""
        key = (y.device, y.dtype)
        if key not in self._cache:
            self._cache[key] = (self.reactants.to(y.device),
                                self.stoich.to(device=y.device,
                                               dtype=y.dtype))
        return self._cache[key]

    @staticmethod
    def _term(R, y):
        """``y_i ** R[j, i]`` for R in 0..3 -> (B, rx, n)."""
        yb = y[:, None, :].expand(y.shape[0], *R.shape)
        one = torch.ones((), dtype=y.dtype, device=y.device)
        return torch.where(R == 0, one,
                           torch.where(R == 1, yb,
                                       torch.where(R == 2, yb * yb,
                                                   yb * yb * yb)))

    @staticmethod
    def _dterm(R, y):
        """d/dy_i of y_i ** R: 0, 1, 2y, 3y^2 -> (B, rx, n)."""
        yb = y[:, None, :].expand(y.shape[0], *R.shape)
        zero = torch.zeros((), dtype=y.dtype, device=y.device)
        one = torch.ones((), dtype=y.dtype, device=y.device)
        return torch.where(R == 0, zero,
                           torch.where(R == 1, one,
                                       torch.where(R == 2, 2.0 * yb,
                                                   3.0 * yb * yb)))

    def rate_grad(self) -> Callable:
        """``(y, p) -> (monomials (B, rx), M (B, rx, n))`` with
        ``M[b, j, i] = ∂rate_j/∂y_i``. Then ``J = S @ M`` and the
        sensitivity RHS is ``S @ (M @ Sens + diag(monomials))``."""

        def grads(y, p):
            R, _ = self._mats(y)
            term = self._term(R, y)
            dterm = self._dterm(R, y)
            ones = torch.ones(term.shape[:2] + (1,), dtype=y.dtype,
                              device=y.device)
            fwd = torch.cat([ones, torch.cumprod(term, dim=2)[..., :-1]],
                            dim=2)
            bwd = torch.cat(
                [torch.cumprod(term.flip(2), dim=2).flip(2)[..., 1:], ones],
                dim=2)
            prod_exc = fwd * bwd                    # Π_{l≠i} term[b,j,l]
            mono = torch.prod(term, dim=2)          # (B, rx)
            M = p[:, :, None] * dterm * prod_exc    # (B, rx, n)
            return mono, M

        return grads

    def jac(self) -> Callable:
        """Closed-form state Jacobian ``(t, y, p) -> (B, n, n)``."""
        grads = self.rate_grad()

        def j(t, y, p):
            del t
            _, S = self._mats(y)
            _, M = grads(y, p.to(y.dtype))
            return S @ M

        return j

    def sens_rhs(self) -> Callable:
        """Closed-form forward-sensitivity RHS ``(t, y, Sens, p) ->
        (B, n, m)`` w.r.t. ALL rate constants (m = n_reactions)."""
        grads = self.rate_grad()

        def fs(t, y, Sens, p):
            del t
            _, S = self._mats(y)
            mono, M = grads(y, p.to(y.dtype))
            inner = M @ Sens + torch.diag_embed(mono)   # (B, rx, m)
            return S @ inner

        return fs

    def sens_rhs_dir(self) -> Callable:
        """Reduced sensitivity RHS ``(t, y, Sens, p, C) -> (B, n, G)``
        along parameter directions ``C`` (B, m, G) or (m, G)."""
        grads = self.rate_grad()

        def fs_dir(t, y, Sens, p, C):
            del t
            _, S = self._mats(y)
            mono, M = grads(y, p.to(y.dtype))
            inner = M @ Sens + mono[:, :, None] * C.to(y.dtype)
            return S @ inner

        return fs_dir

    def rhs(self) -> Callable:
        """``f(t, y, p) -> dy/dt`` (B, n), p = rate constants (B, rx)."""
        if self.reactants.numel() and int(self.reactants.max()) > 3:
            raise ValueError("reaction order > 3 not supported")

        def f(t, y, p):
            del t
            R, S = self._mats(y)
            rates = p.to(y.dtype) * torch.prod(self._term(R, y), dim=2)
            return rates @ S.T

        return f


class NetworkBuilder:
    """Incrementally assemble a MassActionNetwork by named reactions."""

    def __init__(self):
        self._species: List[str] = []
        self._index = {}
        self._rows_R: List[dict] = []
        self._rows_S: List[dict] = []
        self._names: List[str] = []

    def species(self, name: str) -> int:
        if name not in self._index:
            self._index[name] = len(self._species)
            self._species.append(name)
        return self._index[name]

    def reaction(self, name: str, reactants: Sequence[str],
                 products: Sequence[str]):
        """Add elementary reaction ``sum(reactants) -> sum(products)`` with
        mass-action rate ``k * prod(reactant concentrations)``."""
        r_cnt: dict = {}
        s_cnt: dict = {}
        for sp in reactants:
            i = self.species(sp)
            r_cnt[i] = r_cnt.get(i, 0) + 1
            s_cnt[i] = s_cnt.get(i, 0) - 1
        for sp in products:
            i = self.species(sp)
            s_cnt[i] = s_cnt.get(i, 0) + 1
        self._rows_R.append(r_cnt)
        self._rows_S.append(s_cnt)
        self._names.append(name)

    def catalytic(self, enzyme: str, substrate: str, product: str,
                  tag: str = ""):
        """Michaelis-Menten mechanism as 3 elementary reactions
        (bind / unbind / catalyze) — 3 rate constants in order (a, d, k)."""
        complex_name = f"{enzyme}:{substrate}"
        tag = tag or f"{enzyme}+{substrate}"
        self.reaction(f"{tag}.bind", [enzyme, substrate], [complex_name])
        self.reaction(f"{tag}.unbind", [complex_name], [enzyme, substrate])
        self.reaction(f"{tag}.cat", [complex_name], [enzyme, product])

    def build(self, device="cuda") -> MassActionNetwork:
        from tpusysbio_torch import resolve_device

        device = resolve_device(device)
        n_sp = len(self._species)
        n_rx = len(self._rows_R)
        R = np.zeros((n_rx, n_sp), dtype=np.int64)
        S = np.zeros((n_sp, n_rx), dtype=np.int64)
        for j, (rc, sc) in enumerate(zip(self._rows_R, self._rows_S)):
            for i, v in rc.items():
                R[j, i] = v
            for i, v in sc.items():
                S[i, j] = v
        return MassActionNetwork(
            species=tuple(self._species), reaction_names=tuple(self._names),
            reactants=torch.as_tensor(R, device=device),
            stoich=torch.as_tensor(S, device=device))
