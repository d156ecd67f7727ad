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
product over the other species takes no division, so it is exact at zero
concentrations. Where it is formed:

- on a CUDA device, the three consumers of the rate gradient (``jac``,
  ``sens_rhs``, ``sens_rhs_dir``) are one launch each of the hand-written
  kernel K4 (``linalg/csrc/massaction.cu``), in f32 or f64: it multiplies
  each reaction's other reactant terms directly, per (reaction, species),
  and skips the zeros of the network's matrices while keeping the
  non-finite entries that the dense products give. Each launch counts
  ``massaction.<epilogue>`` in ``trace.counters()``. A call the kernel
  cannot take there (another dtype, a network whose member tiles do not
  fit a block's shared memory, ``vmap`` over its inputs) raises; under
  autograd or ``torch.func.jvp`` the kernel gives the value and, where an
  input carries a gradient or a tangent, the plain twin gives those,
  counted as ``massaction.plain`` (``linalg/kernels.py``'s ``call``);
- on the CPU the plain twins (``jac_plain`` and its siblings) build it
  from forward and backward cumulative products.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from tpusysbio_torch.linalg import kernels

# The kernel's epilogues, in the order of its epilogue codes.
EPILOGUES = ("jac", "sens", "sens_dir")
_TWINS = dict(jac="jac_plain", sens="sens_rhs_plain",
              sens_dir="sens_rhs_dir_plain")
_TOO_LARGE = -1   # the kernel's code for member tiles that do not fit


def _plan(R: np.ndarray, S: np.ndarray) -> np.ndarray:
    """The network's tables for K4, as int32 words (layout in
    ``csrc/massaction.cu``)."""
    rx, n = R.shape
    rj, ri = np.nonzero(R)                   # by reaction, then species
    rptr = np.searchsorted(rj, np.arange(rx + 1))
    rent = ri * 4 + R[rj, ri]
    by_col = np.argsort(ri, kind="stable")   # by species, then reaction
    cptr = np.searchsorted(ri[by_col], np.arange(n + 1))
    sk, sj = np.nonzero(S)                   # S by row
    sptr = np.searchsorted(sk, np.arange(n + 1))
    qj, qk = np.nonzero(S.T)                 # S by column
    qptr = np.searchsorted(qj, np.arange(rx + 1))
    return np.concatenate([
        [n, rx, len(rj), len(sk)], rptr, rent, cptr, rj[by_col], by_col,
        sptr, sj, S[sk, sj], qptr, qk, S[qk, qj]]).astype(np.int32)


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
        sensitivity RHS is ``S @ (M @ Sens + diag(monomials))``.

        The plain form, the one the CPU runs: the exclusive product
        ``Π_{l≠i} y_l^R[j,l]`` as the product of a forward and a backward
        cumulative product over the species, with no division. On the card
        ``jac``, ``sens_rhs`` and ``sens_rhs_dir`` call it only for a
        gradient or a tangent: K4 forms the same product per (reaction,
        species) from the reactant terms alone, also with no division."""

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

    def _plan_on(self, device):
        """K4's tables on ``device``, with their count, R's and S's
        nonzeros, built once per device."""
        key = ("plan", device)
        if key not in self._cache:
            if self.reactants.numel() and int(self.reactants.max()) > 3:
                raise ValueError("reaction order > 3 not supported")
            words = _plan(self.reactants.cpu().numpy(),
                          self.stoich.cpu().numpy())
            self._cache[key] = (torch.as_tensor(words, device=device),
                                len(words), int(words[2]), int(words[3]))
        return self._cache[key]

    def _k4(self, epilogue, plain):
        """``plain``'s function ``(t, y, ...)`` by K4's ``epilogue``
        through :func:`kernels.call`: the twin on the CPU, one launch on
        the card (``t`` is not read)."""
        launch = functools.partial(self._launch, epilogue)
        twin = functools.partial(plain, None)
        message = (f"massaction.{epilogue}: K4 cannot run under vmap over "
                   f"its inputs; call the network's {_TWINS[epilogue]}() "
                   f"instead")

        def f(t, *xs):
            return kernels.call(launch, twin, xs,
                                plain_counter="massaction.plain",
                                vmap_message=message)

        return f

    def _launch(self, epilogue, y, *xs):
        """One launch of K4's ``epilogue`` on ``y``'s device and dtype;
        ``xs`` are the arguments after ``y`` of the epilogue's function:
        ``(p,)``, ``(Sens, p)`` or ``(Sens, p, C)``."""
        if epilogue == "jac":
            (p,), sens, C = xs, None, None
        else:
            sens, p, C = (*xs, None)[:3]
        dt = y.dtype
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"massaction.{epilogue}: K4 takes float32 or "
                            f"float64, got {dt}")
        B, n = y.shape
        rx = self.n_reactions
        m = 0 if sens is None else sens.shape[-1]
        if (n != self.n_species or (sens is not None and sens.shape != (
                B, n, m)) or (epilogue == "sens" and m != rx)
                or (C is not None and (C.shape[-2:] != (rx, m) or not (
                    C.ndim == 2 or (C.ndim == 3 and C.shape[0] in (1, B)))))):
            raise ValueError(
                f"massaction.{epilogue}: shapes y {tuple(y.shape)}, Sens "
                f"{None if sens is None else tuple(sens.shape)}, C "
                f"{None if C is None else tuple(C.shape)} do not fit a "
                f"network of {self.n_species} species and {rx} reactions")
        out = torch.empty((B, n, n if sens is None else m), dtype=dt,
                          device=y.device)
        if B == 0 or out.numel() == 0:
            return out
        y = y.contiguous()
        p = p.to(dt).expand(B, rx).contiguous()
        sens = None if sens is None else sens.to(dt).contiguous()
        c_stride = 0
        if C is not None:
            C = C.to(dt)
            if C.ndim == 3 and (C.shape[0] == 1 or C.stride(0) == 0):
                C = C[0]
            C = C.contiguous()
            if C.ndim == 3:
                c_stride = C.shape[1] * C.shape[2]
        words, n_words, nnz_r, nnz_s = self._plan_on(y.device)
        if kernels.launch(
                "tsb_massaction_f32" if dt == torch.float32
                else "tsb_massaction_f64", EPILOGUES.index(epilogue),
                words.data_ptr(), n_words, n, rx, nnz_r, nnz_s, y.data_ptr(),
                p.data_ptr(), 0 if sens is None else sens.data_ptr(),
                0 if C is None else C.data_ptr(), c_stride, out.data_ptr(), B,
                m, device=y.device, counter="massaction." + epilogue,
                known=(_TOO_LARGE,)):
            raise RuntimeError(
                f"massaction.{epilogue}: one member's tiles ({n} species, "
                f"{rx} reactions, {nnz_r} reactant entries) do not fit a "
                f"block's shared memory on {y.device}")
        return out

    def jac_plain(self) -> Callable:
        """Plain twin of :meth:`jac`: ``S @ M`` from :meth:`rate_grad`."""
        grads = self.rate_grad()

        def j(t, y, p):
            del t
            _, S = self._mats(y)
            _, M = grads(y, p.to(y.dtype))
            return S @ M

        return j

    def jac(self) -> Callable:
        """Closed-form state Jacobian ``(t, y, p) -> (B, n, n)``: K4 on
        the card, :meth:`jac_plain` on the CPU."""
        return self._k4("jac", self.jac_plain())

    def sens_rhs_plain(self) -> Callable:
        """Plain twin of :meth:`sens_rhs`."""
        grads = self.rate_grad()

        def fs(t, y, Sens, p):
            del t
            _, S = self._mats(y)
            mono, M = grads(y, p.to(y.dtype))
            inner = M @ Sens + torch.diag_embed(mono)   # (B, rx, m)
            return S @ inner

        return fs

    def sens_rhs(self) -> Callable:
        """Closed-form forward-sensitivity RHS ``(t, y, Sens, p) ->
        (B, n, m)`` w.r.t. ALL rate constants (m = n_reactions): K4 on the
        card, :meth:`sens_rhs_plain` on the CPU."""
        return self._k4("sens", self.sens_rhs_plain())

    def sens_rhs_dir_plain(self) -> Callable:
        """Plain twin of :meth:`sens_rhs_dir`."""
        grads = self.rate_grad()

        def fs_dir(t, y, Sens, p, C):
            del t
            _, S = self._mats(y)
            mono, M = grads(y, p.to(y.dtype))
            inner = M @ Sens + mono[:, :, None] * C.to(y.dtype)
            return S @ inner

        return fs_dir

    def sens_rhs_dir(self) -> Callable:
        """Reduced sensitivity RHS ``(t, y, Sens, p, C) -> (B, n, G)``
        along parameter directions ``C`` (B, m, G) or (m, G): K4 on the
        card, :meth:`sens_rhs_dir_plain` on the CPU."""
        return self._k4("sens_dir", self.sens_rhs_dir_plain())

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
