"""Parameter and scale-factor priors as least-squares rows.

Port of ``tpusysbio/project/priors.py``. A ``Priors`` spec contributes one
row per θ entry and one row per scale-factor group, weight 0 disabling a
row (rows are always present, so the residual vector's length never
depends on values).

Math (θ is log-space, mapping.py):

- parameter prior, log-normal with median ``m`` and log-σ ``s``:
  row ``(θ_g − log m)/s``, Jacobian ``e_g/s`` — a Gaussian in θ;
- scale-factor prior on group ``g``: row ``(log B_g − log m)/s`` with
  Jacobian ``(dB_g/dθ)/(B_g · s)``. This row keeps a fit from
  "explaining" bad parameters with an absurd normalization.

Every row function takes a leading start dimension N.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpusysbio_torch import resolve_device

# B below this is treated as degenerate: the log-prior row saturates
# instead of producing -inf/NaN (a failed member must not poison the
# batch).
_B_FLOOR = 1e-30


@dataclasses.dataclass(frozen=True)
class Priors:
    """Static-shape prior spec for a :class:`Project` (tensors on one
    device). Build with :meth:`create`."""

    theta_mu: torch.Tensor   # (G,) log-space prior means
    theta_w: torch.Tensor    # (G,) 1/σ weights; 0 ⇒ no prior on that entry
    scale_mu: torch.Tensor   # (Gp,) log-space means, Gp = max(n_groups, 1)
    scale_w: torch.Tensor    # (Gp,) 1/σ; 0 ⇒ no prior on that group
    has_theta: bool
    has_scale: bool

    @property
    def n_rows(self) -> int:
        n = self.theta_mu.shape[0] if self.has_theta else 0
        return n + (self.scale_mu.shape[0] if self.has_scale else 0)

    @staticmethod
    def create(pmap, batch=None,
               params: Optional[Dict[str, Tuple[float, float]]] = None,
               scales: Optional[Dict[str, Tuple[float, float]]] = None,
               dtype=torch.float64, device="cuda") -> "Priors":
        """Named priors → static spec on ``device``.

        Args:
          pmap: the project's ``ParameterMap`` (for θ-entry names).
          batch: the project's ``ExperimentBatch`` (required when
            ``scales`` is given, for group names).
          params: ``{θ name: (median, log_sigma)}`` — log-normal priors
            in LINEAR space. A bare parameter name covers all its local
            ``name[e]`` entries.
          scales: ``{scale group name: (median, log_sigma)}``.
        """
        dev = resolve_device(device)
        G = pmap.n_global
        t_mu = np.zeros(G)
        t_w = np.zeros(G)
        for name, (median, sigma) in (params or {}).items():
            if median <= 0 or sigma <= 0:
                raise ValueError(f"prior on {name!r}: median and sigma "
                                 "must be positive (log-normal)")
            idxs = [i for i, tn in enumerate(pmap.theta_names)
                    if tn == name or tn.split("[")[0] == name]
            if not idxs:
                raise KeyError(f"no θ entry named {name!r} "
                               f"(have {pmap.theta_names})")
            for i in idxs:
                t_mu[i] = np.log(median)
                t_w[i] = 1.0 / sigma

        n_groups = 0 if batch is None else batch.n_groups
        s_mu = np.zeros(max(n_groups, 1))
        s_w = np.zeros(max(n_groups, 1))
        for name, (median, sigma) in (scales or {}).items():
            if batch is None:
                raise ValueError("scale priors need the ExperimentBatch")
            if median <= 0 or sigma <= 0:
                raise ValueError(f"scale prior on {name!r}: median and "
                                 "sigma must be positive")
            if name not in batch.group_names:
                raise KeyError(f"no scale group named {name!r} "
                               f"(have {batch.group_names})")
            g = batch.group_names.index(name)
            s_mu[g] = np.log(median)
            s_w[g] = 1.0 / sigma

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        return Priors(theta_mu=t(t_mu), theta_w=t(t_w), scale_mu=t(s_mu),
                      scale_w=t(s_w), has_theta=bool(params),
                      has_scale=bool(scales))

    # ------------------------------------------------------------------
    def rows(self, theta, B, dB=None):
        """Prior residual rows (and Jacobian rows when ``dB`` is given).

        Args:
          theta: (N, G) current fit vectors.
          B: (N, Gp) fitted scale factors (ignored unless has_scale).
          dB: (N, Gp, G) scale-factor gradient, or None for
            residuals-only evaluation.

        Returns:
          ``(r_rows (N, n_rows), J_rows (N, n_rows, G))``; ``J_rows`` is
          None when ``dB`` is None.
        """
        N, G = theta.shape
        with_jac = dB is not None
        r_parts, j_parts = [], []
        if self.has_theta:
            r_parts.append(self.theta_w * (theta - self.theta_mu))
            if with_jac:
                j_parts.append(torch.diag(self.theta_w).to(theta.dtype)
                               .expand(N, G, G))
        if self.has_scale:
            Bc = torch.clamp(B.to(theta.dtype), min=_B_FLOOR)
            r_parts.append(self.scale_w * (torch.log(Bc) - self.scale_mu))
            if with_jac:
                j_parts.append((self.scale_w / Bc)[..., None]
                               * dB.to(theta.dtype))
        if not r_parts:
            z = theta.new_zeros((N, 0))
            return z, (theta.new_zeros((N, 0, G)) if with_jac else None)
        r = torch.cat(r_parts, dim=1)
        J = torch.cat(j_parts, dim=1) if with_jac else None
        return r, J
