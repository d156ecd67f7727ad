"""Shared stepper infrastructure, port of ``tpusysbio/solvers/common.py``.

Everything is per member: inputs carry a leading batch dimension B and
reductions (norms) run over the remaining dimensions only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

STATUS_RUNNING = 0
STATUS_DONE = 1
STATUS_TOO_SMALL_STEP = 2   # h underflowed machine spacing
STATUS_NONFINITE = 3        # RHS produced non-finite values
STATUS_MAX_STEPS = 4        # step budget exhausted
STATUS_SS_FAIL = 5          # algebraic steady-state Newton did not converge
STATUS_STIFF = 6            # explicit stepper detected stiffness
STATUS_EVENT = 7            # a terminal event fired (successful stop)


def rms_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(x^2)) per member: over all dimensions but the first."""
    return torch.sqrt(torch.mean(torch.square(x.reshape(x.shape[0], -1)),
                                 dim=1))


def batched_jacobian(fn, y: torch.Tensor) -> torch.Tensor:
    """Per-member Jacobian ``∂fn(y)/∂y`` (B, n_out, n) of a batched
    ``fn: (B, n) -> (B, n_out)`` by forward-mode AD: one jvp per basis
    direction, vmapped over the n directions. The directions take the
    dtype of ``y``; the result takes that of ``fn``'s output (f64 when the
    RHS mixes an f64 time into an f32 state, as the reference's
    ``jax.jacfwd`` does)."""
    B, n = y.shape
    basis = torch.eye(n, dtype=y.dtype, device=y.device)[:, None, :]
    cols = torch.func.vmap(
        lambda v: torch.func.jvp(fn, (y,), (v,))[1])(basis.expand(n, B, n))
    return cols.permute(1, 2, 0)


class IntegrateResult(NamedTuple):
    """Dense output at ``t_eval`` plus per-member diagnostics.

    ``ys``: (B, T, n); ``sens``: (B, T, n, m) (m = 0 without
    sensitivities); every counter is (B,) int32 and ``order_hist`` is
    (B, MAX_ORDER+1)."""

    ys: torch.Tensor
    sens: torch.Tensor
    status: torch.Tensor
    nsteps: torch.Tensor
    naccepted: torch.Tensor
    nrejected: torch.Tensor
    nfev: torch.Tensor
    njev: torch.Tensor
    nlu: torch.Tensor
    order_hist: Optional[torch.Tensor] = None
    t_final: Optional[torch.Tensor] = None
    y_final: Optional[torch.Tensor] = None

    @property
    def success(self):
        return (self.status == STATUS_DONE) | (self.status == STATUS_EVENT)


def select_initial_step(f, t0, y0, f0, t_bound, max_step, rtol, atol,
                        order):
    """Hairer-Wanner initial step size per member (direction +1).

    ``t0``/``t_bound`` are (B,), ``y0``/``f0`` (B, n); returns (B,)."""
    dtype = y0.dtype
    scale = atol + torch.abs(y0) * rtol
    d0 = rms_norm(y0 / scale)
    d1 = rms_norm(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    interval = torch.abs(t_bound - t0)
    # zero-length intervals must not divide by h0 = 0
    empty = interval <= 0
    h0 = torch.where(empty, torch.ones_like(h0),
                     torch.minimum(h0, 0.5 * interval))

    y1 = y0 + h0[:, None] * f0
    f1 = f(t0 + h0, y1)
    d2 = rms_norm((f1 - f0) / scale) / h0

    tiny = (d1 <= 1e-15) & (d2 <= 1e-15)
    h1 = torch.where(
        tiny, torch.maximum(torch.full_like(h0, 1e-6), h0 * 1e-3),
        (0.01 / torch.maximum(d1, d2)) ** (1.0 / (order + 1.0)))
    cap = torch.minimum(interval, torch.full_like(interval, float(max_step)))
    h = torch.minimum(torch.minimum(100 * h0, h1), cap)
    return torch.where(empty, torch.ones((), dtype=dtype, device=h.device),
                       h)


def status_init(t0, t_bound):
    """Initial status per member: DONE for an empty interval."""
    return torch.where(t_bound > t0, STATUS_RUNNING,
                       STATUS_DONE).to(torch.int32)


def interp_accumulate(t_eval, t_old, t_new, interp_fn, ys_acc):
    """Fold dense output into the ``t_eval`` accumulator after a step.

    ``t_eval`` is (T,) shared by the batch or (B, T) per member,
    ``t_old``/``t_new`` (B,); ``interp_fn(t_eval) -> (B, T, ...)`` takes
    the (B, T) grid; ``ys_acc`` is (B, T, ...). Points with
    ``t_old < t <= t_new`` take the interpolant's value."""
    if t_eval.ndim == 1:
        t_eval = t_eval[None, :].expand(t_old.shape[0], -1)
    mask = (t_eval > t_old[:, None]) & (t_eval <= t_new[:, None])
    vals = interp_fn(t_eval)
    mask_b = mask.reshape(mask.shape + (1,) * (ys_acc.ndim - 2))
    return torch.where(mask_b, vals, ys_acc)
