"""Shared stepper infrastructure, port of ``tpusysbio/solvers/common.py``.

Everything is per member: inputs carry a leading batch dimension B and
reductions (norms) run over the remaining dimensions only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpusysbio_torch import trace

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
    ``jax.jacfwd`` does). One span ``ad.jac`` a call, counted as n jvps
    (``ad.jvps``)."""
    B, n = y.shape
    trace.count("ad.jvps", n)
    with trace.span("ad.jac"):
        basis = torch.eye(n, dtype=y.dtype, device=y.device)[:, None, :]
        cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (y,), (v,))[1])(
            basis.expand(n, B, n))
        return cols.permute(1, 2, 0)


class EventSpec(NamedTuple):
    """State-dependent events ``g(t, y) = 0`` (SciPy's ``solve_ivp(events=)``
    contract) for the BDF stepper, over a batch of members.

    - ``fn(t, y) -> (B, E)`` evaluates all E event functions at once, with
      ``t`` (B,) and ``y`` (B, n); per-member thresholds are closed over as
      (B, ·) tensors, so ``fn`` must keep its rows in member order;
    - a sign change across an accepted step fires an event, honouring
      ``direction``; its root is bisected ``bisect_iters`` times on the
      step's dense-output polynomial;
    - occurrences go into (B, E, capacity) buffers; ``event_count`` keeps
      counting past the capacity;
    - a terminal event stops its member at the earliest terminal root with
      ``STATUS_EVENT``; later roots are discarded and ``y_final`` is the
      interpolated column block at the event time.

    ``direction``: per event +1 (rising), -1 (falling) or 0 (either);
    ``terminal``: per event bool. Empty tuples mean 0 / False for all.
    """

    fn: object
    direction: tuple = ()
    terminal: tuple = ()
    capacity: int = 8
    bisect_iters: int = 48


class IntegrateResult(NamedTuple):
    """Dense output at ``t_eval`` plus per-member diagnostics.

    ``ys``: (B, T, n); ``sens``: (B, T, n, m) (m = 0 without
    sensitivities); every counter is (B,) int32 and ``order_hist`` is
    (B, MAX_ORDER+1). ``t_final`` (B,) and ``y_final`` (B, n, 1+m) are
    where each member stopped.

    Event channel (``EventSpec``): ``event_t`` (B, E, K) times (+inf in
    unfilled slots), ``event_y`` (B, E, K, n) states, ``event_count``
    (B, E). Dense-export channel (``bdf_solve(dense_export=True)``): per
    accepted step the interpolant's ``seg_t``/``seg_h``/``seg_order``
    (B, S) and a tuple of parts ``seg_D`` (B, S, MAX_ORDER+1, n, k_p);
    slots past ``naccepted`` are unfilled."""

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
    event_t: Optional[torch.Tensor] = None
    event_y: Optional[torch.Tensor] = None
    event_count: Optional[torch.Tensor] = None
    seg_t: Optional[torch.Tensor] = None
    seg_h: Optional[torch.Tensor] = None
    seg_order: Optional[torch.Tensor] = None
    seg_D: Optional[tuple] = None

    @property
    def success(self):
        return (self.status == STATUS_DONE) | (self.status == STATUS_EVENT)


def bcast(mask, x):
    """``mask`` (B, ...) reshaped to broadcast against ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def where_members(mask, new, old):
    """Per-member ``torch.where`` over tensors, tuples and dicts: members
    where ``mask`` holds take ``new``. Where one side is None (a
    factorization not made yet) the other is taken whole."""
    if new is None:
        return old
    if old is None:
        return new
    if isinstance(new, dict):
        return {k: where_members(mask, new[k], old[k]) for k in new}
    if isinstance(new, (tuple, list)):
        return type(new)(where_members(mask, a, b)
                         for a, b in zip(new, old))
    return torch.where(bcast(mask, new), new, old)


def prepare_times(t_span, y0, t_eval):
    """The stepper's time inputs per member: ``t0`` and ``t_bound`` (B,)
    from floats or (B,) tensors, and ``t_eval`` (B, T) from (T,) or
    (B, T), all in ``y0``'s dtype and on its device."""
    B = y0.shape[0]
    kw = dict(dtype=y0.dtype, device=y0.device)
    t_eval = torch.as_tensor(t_eval, **kw)
    if t_eval.ndim == 1:
        t_eval = t_eval[None, :].expand(B, -1)
    if t_eval.ndim != 2 or t_eval.shape[0] != B:
        raise ValueError(f"t_eval must be (T,) or ({B}, T); got "
                         f"{tuple(t_eval.shape)}")

    def member_times(x):
        x = torch.as_tensor(x, **kw)
        if x.ndim == 0:
            return x.expand(B).clone()
        if tuple(x.shape) != (B,):
            raise ValueError(f"t_span ends must be floats or ({B},) "
                             f"tensors; got {tuple(x.shape)}")
        # forward-mode AD in t (Rosenbrock) needs one element per member
        return x.contiguous()

    return member_times(t_span[0]), member_times(t_span[1]), t_eval


def augmented_rhs(f, sens_rhs):
    """The column-block RHS ``(t, Y) -> (B, n, k)``: ``f`` on column 0 and
    ``sens_rhs`` on the sensitivity columns 1..m."""
    if sens_rhs is None:
        def faug(t, Y):
            return f(t, Y[..., 0])[..., None]
    else:
        def faug(t, Y):
            y = Y[..., 0]
            return torch.cat([f(t, y)[..., None], sens_rhs(t, y, Y[..., 1:])],
                             dim=-1)
    return faug


def initial_block(y0, s0, sens_rhs):
    """``(Y0, m)``: the column block (B, n, 1+m) and the number of
    sensitivity columns."""
    if sens_rhs is None:
        return y0[..., None], 0
    if s0 is None:
        raise ValueError("sens_rhs requires s0 of shape (B, n, m)")
    return torch.cat([y0[..., None], s0.to(y0.dtype)], dim=-1), s0.shape[-1]


def finite_members(*xs):
    """(B,) bool: every value of every ``x`` (B, ...) is finite."""
    out = None
    for x in xs:
        ok = torch.isfinite(x).reshape(x.shape[0], -1).all(1)
        out = ok if out is None else out & ok
    return out


def step_status(accept, t_new, t_bound, nsteps, max_steps):
    """``(done, status)`` after an attempt: DONE where an accepted step
    reached ``t_bound``, MAX_STEPS once ``nsteps`` spent the budget,
    RUNNING otherwise."""
    done = accept & (t_new >= t_bound)
    status = torch.where(
        done, STATUS_DONE,
        torch.where(nsteps >= max_steps, STATUS_MAX_STEPS, STATUS_RUNNING))
    return done, status.to(torch.int32)


def settle(st, new_st, too_small, running):
    """The state after one attempt: a step-size underflow freezes the
    member's old state with ``STATUS_TOO_SMALL_STEP``, and a member that
    was not running keeps its whole state, as a vmapped ``while_loop``
    freezes its lanes."""
    frozen = dict(st, status=torch.where(
        too_small, STATUS_TOO_SMALL_STEP, st["status"]).to(torch.int32))
    return where_members(running, where_members(too_small, frozen, new_st),
                         st)


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


def interp_accumulate_windowed(t_eval, lo, t_old, t_new, interp_fn, ys_acc,
                               window: int, gate):
    """Windowed :func:`interp_accumulate` (``SolverConfig.dense_window``).

    ``lo`` (B,) is each member's index of the first ``t_eval`` point past
    ``t_old``. The caller caps every step at the (window-1)-th next grid
    point, so the points in ``(t_old, t_new]`` lie in ``[lo, lo +
    window)``: only that (B, window) slice is interpolated and written.
    ``gate`` (B,) (the step's accept flag) folds into the slice's mask.
    ``t_eval`` is (B, T); returns the updated (B, T, ...) accumulator."""
    T = t_eval.shape[1]
    if window >= T:
        return torch.where(bcast(gate, ys_acc),
                           interp_accumulate(t_eval, t_old, t_new,
                                             interp_fn, ys_acc), ys_acc)
    # keep the slice in range; points that shift into view get masked
    lo_s = torch.clamp(lo, max=T - window)
    idx = lo_s[:, None] + torch.arange(window, device=lo.device)[None, :]
    tv = torch.gather(t_eval, 1, idx)
    mask = (tv > t_old[:, None]) & (tv <= t_new[:, None]) & gate[:, None]
    vals = interp_fn(tv)
    idx_b = bcast(idx, ys_acc).expand((-1, -1) + ys_acc.shape[2:])
    acc_slice = torch.gather(ys_acc, 1, idx_b)
    new_slice = torch.where(bcast(mask, ys_acc), vals.to(ys_acc.dtype),
                            acc_slice)
    return ys_acc.scatter(1, idx_b, new_slice)
