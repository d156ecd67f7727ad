"""Forward sensitivity equations derived from the RHS by ``torch.func.jvp``.

Port of ``tpusysbio/sens/forward.py``. Each sensitivity column's time
derivative ``dS_k/dt = (∂f/∂y) S_k + ∂f/∂p_k`` is one forward-mode
directional derivative of the batched RHS, which never materializes the
state Jacobian or ``∂f/∂p``; ``torch.func.vmap`` runs the columns as one
batch. The stepper (solvers/bdf.py) carries the columns beside the state
and shares its Newton factorization with them.

Shapes: ``y`` (B, n), ``p`` (B, m), ``S`` (B, n, m) for the full form,
``C`` (B, m, G) and ``S`` (B, n, G) for the reduced one; ``t`` is (B,).
Both follow the dtype of ``y``: ``p`` and ``C`` are cast to it, so the
stepper's f32 modes get f32 columns.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpusysbio_torch import trace


def _columns(rhs: Callable, t, y, p, S, D):
    """``jvp(rhs(t, ·, ·), (y, p), (S[..., k], D[..., k]))`` for every k,
    stacked on the last axis: one span ``ad.sens`` a call, counted as one
    jvp a column (``ad.jvps``)."""

    def col(s_col, d_col):
        return torch.func.jvp(lambda yy, pp: rhs(t, yy, pp), (y, p),
                              (s_col, d_col))[1]

    trace.count("ad.jvps", S.shape[-1])
    with trace.span("ad.sens"):
        return torch.func.vmap(col, in_dims=(2, 2), out_dims=2)(S, D)


def _primal(x: torch.Tensor, dtype) -> torch.Tensor:
    # forward-mode AD refuses a primal whose elements share memory (an
    # expanded view), so such an input is copied once
    x = x.to(dtype)
    return x if x.is_contiguous() else x.contiguous()


def make_sens_rhs(rhs: Callable, p: torch.Tensor) -> Callable:
    """Build ``(t, y, S) -> dS/dt`` for ``dy/dt = rhs(t, y, p)``.

    ``S`` is (B, n, m) with column k = dy/dp_k; the column's derivative is
    the jvp of ``rhs`` at ``(y, p)`` along ``(S[..., k], e_k)``.
    """
    B, m = p.shape

    def sens_rhs(t, y, S):
        pc = _primal(p, y.dtype)
        E = torch.eye(m, dtype=y.dtype, device=y.device).expand(B, m, m)
        return _columns(rhs, t, y, pc, S, E)

    return sens_rhs


def make_sens_rhs_dir(rhs: Callable, p: torch.Tensor,
                      C: torch.Tensor) -> Callable:
    """Build the reduced ``(t, y, S) -> dS/dt`` along the parameter
    directions ``C`` (B, m, G), e.g. ``C = dp/dθ`` for G fit parameters:
    column g is the jvp along ``(S[..., g], C[..., g])``, so only G columns
    ride the stepper instead of m."""

    def sens_rhs(t, y, S):
        return _columns(rhs, t, y, _primal(p, y.dtype), S, C.to(y.dtype))

    return sens_rhs
