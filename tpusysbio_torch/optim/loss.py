"""Robust loss functions for TRF (``scipy.optimize.least_squares`` parity).

Port of ``tpusysbio/optim/loss.py``. Semantics are SciPy's
(``scipy/optimize/_lsq/least_squares.py`` ``construct_loss_function`` and
``scipy/optimize/_lsq/common.py`` ``scale_for_robust_loss_function``):

- ``z = (r / f_scale)²``; robust cost ``0.5 · f_scale² · Σ ρ(z)``;
- per-iteration rescaling ``J_s = √(ρ' + 2 ρ'' z) · J``,
  ``r_s = ρ' / √(ρ' + 2 ρ'' z) · r`` so the scaled Gauss–Newton model
  carries the robust curvature.

All four SciPy losses: ``huber``, ``soft_l1``, ``cauchy``, ``arctan``
(+ ``linear`` = plain least squares). Everything is elementwise
``torch.where``, so a batch of residual rows (N, R) is scaled row by row.
The Huber tail is computed on ``max(z, 1)``: exact, since the tail branch
is selected only for z > 1, and no ``0 ** 1.5`` is ever formed.
"""

from __future__ import annotations

import torch

LOSSES = ("linear", "huber", "soft_l1", "cauchy", "arctan")


def _rho(loss: str, z):
    """ρ(z), ρ'(z), ρ''(z) elementwise (SciPy's IMPLEMENTED_LOSSES)."""
    if loss == "huber":
        zs = torch.clamp(z, min=1.0)       # tail branch only
        sq = torch.sqrt(zs)
        tail = z > 1
        rho0 = torch.where(tail, 2.0 * sq - 1.0, z)
        rho1 = torch.where(tail, 1.0 / sq, torch.ones_like(z))
        rho2 = torch.where(tail, -0.5 / (zs * sq), torch.zeros_like(z))
    elif loss == "soft_l1":
        t = 1.0 + z
        sq = torch.sqrt(t)
        rho0 = 2.0 * (sq - 1.0)
        rho1 = 1.0 / sq
        rho2 = -0.5 / (t * sq)
    elif loss == "cauchy":
        t = 1.0 + z
        rho0 = torch.log1p(z)
        rho1 = 1.0 / t
        rho2 = -1.0 / (t * t)
    elif loss == "arctan":
        t = 1.0 + z * z
        rho0 = torch.arctan(z)
        rho1 = 1.0 / t
        rho2 = -2.0 * z / (t * t)
    else:
        raise ValueError(f"unknown loss {loss!r}; expected one of {LOSSES}")
    return rho0, rho1, rho2


def make_loss(loss: str, f_scale: float):
    """Build ``(cost_fn, scale_fn)`` for a robust loss.

    ``cost_fn(r (..., R)) -> (...)`` is the robust cost of each row;
    ``scale_fn(r (..., R), J (..., R, G)) -> (r_s, J_s)`` rescales
    residuals and Jacobian so the quadratic model matches the robust
    objective. ``loss='linear'`` returns ``(None, None)``: callers keep
    their plain least-squares path.
    """
    if loss == "linear":
        return None, None
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; expected one of {LOSSES}")
    if f_scale <= 0:
        raise ValueError("f_scale must be positive")

    def cost_fn(r):
        z = (r / f_scale) ** 2
        rho0, _, _ = _rho(loss, z)
        return 0.5 * f_scale * f_scale * torch.sum(rho0, dim=-1)

    def scale_fn(r, J):
        z = (r / f_scale) ** 2
        _, rho1, rho2 = _rho(loss, z)
        # common.py: J_scale = ρ' + 2 ρ'' z, floored at eps
        j_scale = torch.clamp(rho1 + 2.0 * rho2 * z,
                              min=torch.finfo(r.dtype).eps)
        root = torch.sqrt(j_scale)
        return r * (rho1 / root), J * root[..., None]

    return cost_fn, scale_fn
