"""Global ↔ per-experiment parameter mapping in log space.

Port of ``tpusysbio/project/mapping.py``. A global vector θ holds shared
parameters (one entry, used by every experiment) and experiment-local ones
(one entry per experiment); each experiment's full model-parameter vector
is assembled from θ plus per-experiment fixed values (condition settings,
knockouts). Rate constants are fitted in log space.

The mapping is two static tensors — ``map_idx`` (E, P) with the θ index
feeding each model parameter (-1 = fixed) and ``fixed`` (E, P) values — so
assembly is one gather + ``where`` and the θ-Jacobian chain rule is a
one-hot product: for ``p = exp(θ[idx])``,
``dp_i/dθ_g = p_i · [map_idx[i] == g]``. θ carries a leading start
dimension N.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from tpusysbio_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ParameterMap:
    """θ (log space, (N, G)) -> per-experiment model parameters (N, E, P)."""

    map_idx: torch.Tensor   # (E, P) int32, -1 = fixed
    fixed: torch.Tensor     # (E, P) values used where map_idx < 0
    n_global: int
    theta_names: Tuple[str, ...] = ()

    @property
    def n_experiments(self) -> int:
        return self.map_idx.shape[0]

    @property
    def n_model_params(self) -> int:
        return self.map_idx.shape[1]

    def expand(self, theta: torch.Tensor) -> torch.Tensor:
        """θ (N, G) -> (N, E, P) linear-space model parameters."""
        idx = torch.clamp(self.map_idx, min=0).long()
        mapped = torch.exp(theta)[:, idx]
        return torch.where(self.map_idx >= 0, mapped,
                           self.fixed.to(theta.dtype))

    def chain(self, theta: torch.Tensor) -> torch.Tensor:
        """d p_e / d θ as (N, E, P, G): the log-transform chain-rule factor
        ``dp[n, e, i, g] = p[n, e, i] * [map_idx[e, i] == g]``."""
        p = self.expand(theta)
        g = torch.arange(self.n_global, device=theta.device)
        onehot = (self.map_idx[..., None] == g).to(theta.dtype)  # -1 -> 0
        return onehot * p[..., None]

    @staticmethod
    def create(param_names: Sequence[str], n_experiments: int,
               shared: Sequence[str] = (), local: Sequence[str] = (),
               fixed: Union[Dict[str, float], None] = None,
               grouped: Union[Dict[str, Sequence], None] = None,
               dtype=torch.float64, device="cuda") -> "ParameterMap":
        """Build a map from name lists, its tensors on ``device``.

        ``shared``: one θ entry each; ``local``: E θ entries each (named
        ``"{name}[e]"``); ``grouped``: parameters shared across SUBSETS
        of experiments — ``{"k1": ["wt", "wt", "mut"]}`` (one label per
        experiment) fits one θ entry per distinct label, named
        ``"{name}[{label}]"``; everything else must appear in ``fixed``
        (scalar or length-E sequence — per-experiment condition settings).
        """
        dev = resolve_device(device)
        fixed = dict(fixed or {})
        grouped = dict(grouped or {})
        P = len(param_names)
        E = n_experiments
        map_idx = np.full((E, P), -1, dtype=np.int32)
        fixed_arr = np.zeros((E, P), dtype=np.float64)
        theta_names = []

        for name in shared:
            theta_names.append(name)
        local_base = len(theta_names)
        for name in local:
            for e in range(E):
                theta_names.append(f"{name}[{e}]")
        group_idx: Dict[str, list] = {}  # name -> per-experiment θ index
        for name, labels in grouped.items():
            if name in shared or name in local or name in fixed:
                raise ValueError(f"parameter {name!r} is grouped AND "
                                 "shared/local/fixed")
            labels = list(labels)
            if len(labels) != E:
                raise ValueError(
                    f"grouped[{name!r}] needs one label per experiment "
                    f"({E}), got {len(labels)}")
            idx_of = {}
            per_exp = []
            for lab in labels:
                if lab not in idx_of:
                    idx_of[lab] = len(theta_names)
                    theta_names.append(f"{name}[{lab}]")
                per_exp.append(idx_of[lab])
            group_idx[name] = per_exp

        for i, name in enumerate(param_names):
            if name in shared:
                map_idx[:, i] = shared.index(name)
            elif name in local:
                li = list(local).index(name)
                for e in range(E):
                    map_idx[e, i] = local_base + li * E + e
            elif name in group_idx:
                map_idx[:, i] = group_idx[name]
            elif name in fixed:
                v = fixed[name]
                v = np.broadcast_to(np.asarray(v, dtype=np.float64), (E,))
                fixed_arr[:, i] = v
            else:
                raise ValueError(f"parameter {name!r} is neither shared, "
                                 "local, grouped, nor fixed")

        return ParameterMap(
            map_idx=torch.as_tensor(map_idx, device=dev),
            fixed=torch.as_tensor(fixed_arr, dtype=dtype, device=dev),
            n_global=len(theta_names), theta_names=tuple(theta_names))

    def pack(self, values: Dict[str, float]) -> torch.Tensor:
        """Named linear-space values -> θ (G,) in log space, on the map's
        device."""
        out = np.zeros(self.n_global)
        for i, name in enumerate(self.theta_names):
            base = name.split("[")[0]
            if name in values:
                out[i] = np.log(values[name])
            elif base in values:
                v = values[base]
                if np.ndim(v) > 0:
                    e = int(name.split("[")[1].rstrip("]"))
                    out[i] = np.log(v[e])
                else:
                    out[i] = np.log(v)
            else:
                raise KeyError(f"no value for θ entry {name!r}")
        return torch.as_tensor(out, dtype=self.fixed.dtype,
                               device=self.fixed.device)
