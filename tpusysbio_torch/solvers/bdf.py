"""Variable-order BDF/NDF stiff integrator over a batch of members.

Port of ``tpusysbio/solvers/bdf.py`` (itself SciPy's ``_ivp/bdf.py``
algorithm): NDF constants, the difference array ``D`` with the
``change_D``/``compute_R`` rescaling, modified Newton with a reused
factorization and SciPy's reuse quirks (``current_jac`` resets at each
fresh step; an error-test rejection keeps the stale factorization), order
adaptation from ``D[order±1]``, and the ``BdfDenseOutput`` interpolant
evaluated at every ``t_eval`` point after each accepted step.

Batching. The reference gets its ensemble from ``jax.vmap`` over a
``lax.while_loop`` whose body is one step ATTEMPT with branchless
``jnp.where`` merges. Here every quantity carries a leading member
dimension B, and the reference's batching semantics are written out:

- the step loop runs until no member is ``STATUS_RUNNING``; a member that
  is not running keeps its whole state (``torch.where(running, new,
  old)`` on every field), as a vmapped ``while_loop`` freezes its lanes;
- the Newton loop runs the batch union of trips, at most
  ``NEWTON_MAXITER``; a member whose own condition is false keeps its
  whole carry, its trip counter included;
- ``lax.cond(lu_valid, reuse, factor)`` becomes: factor the batch (when
  any running member needs it), then ``where(lu_valid, old, new)``;
- a fatal step-size underflow freezes the member with
  ``STATUS_TOO_SMALL_STEP``.

The column block is a tuple of PARTS with their own dtypes: with
``sens_precision='f32'`` the state column (error control, dense output)
stays f64 and the sensitivity columns live entirely in f32. With
``mixed_precision`` (the screening mode) the whole block is one f32 part:
RHS, Jacobian, factorization, solves, difference arrays and dense output
run in f32, while time, step size, the error norm's comparison and the
order logic stay f64.

Each member has its own interval and output grid: ``t_span`` ends may be
floats or (B,) tensors, ``t_eval`` is (T,) or (B, T).

Channels beside ``t_eval``:

- ``events`` (``common.EventSpec``): sign changes of ``fn`` across each
  accepted step, roots bisected on the step's interpolant for the batch
  when any member fired, (B, E, capacity) buffers, and a terminal stop.
  The ``t_eval`` points of a terminal step are filled from the step's own
  polynomial up to the event time, and only then is the anchor row
  rewritten to the state at the event. The reference fills them after the
  rewrite, which shifts the polynomial and puts those points off by the
  size of the step's last correction; the port does not copy that.
- ``dense_export``: each accepted step's interpolant (``t_new``, ``h``,
  order, ``D[:MAX_ORDER+1]``) into (B, max_steps, ...) buffers for
  ``solvers.dense.OdeSolution``; the buffers are written in place.
- ``config.dense_window``: the step is capped at the (window-1)-th next
  ``t_eval`` point and only that window of the grid is interpolated.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.linalg import make_linear_solver
from tpusysbio_torch.solvers import common
from tpusysbio_torch.solvers.common import (
    STATUS_EVENT,
    STATUS_RUNNING,
    IntegrateResult,
    bcast,
    rms_norm,
    where_members,
)

MAX_ORDER = 5
NEWTON_MAXITER = 4
# Rows of the difference array: D[0..order+2] live, order <= 5 -> 8 rows.
D_ROWS = MAX_ORDER + 3


def _ndf_constants(dtype, device):
    """NDF modification constants (SciPy bdf.py:244-247)."""
    kw = dict(dtype=dtype, device=device)
    kappa = torch.tensor([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0], **kw)
    k = torch.arange(1, MAX_ORDER + 1, **kw)
    gamma = torch.cat([torch.zeros(1, **kw), torch.cumsum(1.0 / k, 0)])
    alpha = (1.0 - kappa) * gamma
    error_const = kappa * gamma + 1.0 / torch.arange(1, MAX_ORDER + 2, **kw)
    return gamma, alpha, error_const


def _compute_R(factor):
    """(B, MAX_ORDER+1, MAX_ORDER+1) difference-rescaling matrices for the
    per-member step ratio ``factor`` (B,), in ``factor``'s dtype."""
    kw = dict(dtype=factor.dtype, device=factor.device)
    i = torch.arange(MAX_ORDER + 1, **kw)[:, None]
    j = torch.arange(MAX_ORDER + 1, **kw)[None, :]
    body = (i - 1.0 - factor[:, None, None] * j) / torch.clamp(i, min=1.0)
    one = torch.ones((), **kw)
    m = torch.where(i == 0, one, torch.where(j == 0, 0.0 * one, body))
    return torch.cumprod(m, dim=1)


def _padded_transform(h_factor, order):
    """change_D's map as a (B, D_ROWS, D_ROWS) matrix ``T`` with
    ``D_new[i] = Σ_j T[i, j] D[j]``: ``(R(f) R(1))ᵀ`` on the leading
    (order+1)² block, identity outside. In ``h_factor``'s dtype."""
    B = h_factor.shape[0]
    P = _compute_R(h_factor) @ _compute_R(torch.ones_like(h_factor))
    rows = torch.arange(D_ROWS, device=h_factor.device)
    i, j = rows[:, None], rows[None, :]
    eye = (i == j).to(h_factor.dtype)
    Ppad = torch.zeros((B, D_ROWS, D_ROWS), dtype=h_factor.dtype,
                       device=h_factor.device)
    Ppad[:, :MAX_ORDER + 1, :MAX_ORDER + 1] = P
    o = order[:, None, None]
    return torch.where((i <= o) & (j <= o), Ppad.transpose(1, 2), eye)


def _wsum(w, D):
    """Weighted sum over the row axis of ``D`` (B, J, ...), in D's dtype.

    ``w`` (B, J) gives ``Σ_j w[:, j] D[:, j]``; ``w`` (B, I, J) gives the
    row mix ``out[:, i] = Σ_j w[:, i, j] D[:, j]``. The terms are added in
    order j = 0, 1, ..., as the reference's elementwise reduction does, so
    the f64 state part rounds the same way in both packages."""
    w = w.to(D.dtype)
    tail = (1,) * (D.ndim - 2)
    if w.ndim == 2:
        out = w[:, 0].reshape(-1, *tail) * D[:, 0]
        for j in range(1, D.shape[1]):
            out = out + w[:, j].reshape(-1, *tail) * D[:, j]
        return out
    out = w[:, :, 0].reshape(*w.shape[:2], *tail) * D[:, None, 0]
    for j in range(1, D.shape[1]):
        out = out + w[:, :, j].reshape(*w.shape[:2], *tail) * D[:, None, j]
    return out




def bdf_solve(
    f: Callable,
    t_span,
    y0: torch.Tensor,
    t_eval: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    sens_rhs: Optional[Callable] = None,
    s0: Optional[torch.Tensor] = None,
    jac: Optional[Callable] = None,
    events: Optional[common.EventSpec] = None,
    dense_export: bool = False,
) -> IntegrateResult:
    """Integrate ``dy/dt = f(t, y)`` for a batch of members, forward.

    Args:
      f: batched RHS ``f(t, y) -> (B, n)`` with ``t`` (B,), ``y`` (B, n);
        parameters closed over; must follow the dtype of ``y``.
      t_span: ``(t0, t1)`` with ``t1 > t0``; each end a float shared by
        the batch or a (B,) tensor of per-member times.
      y0: initial states (B, n).
      t_eval: sorted output times within ``[t0, t1]``: (T,) shared by the
        batch, or (B, T) per member.
      config: solver configuration.
      sens_rhs: optional ``(t, y, S) -> (B, n, m)`` forward-sensitivity
        RHS; requires ``s0`` (B, n, m).
      jac: optional state Jacobian ``(t, y) -> (B, n, n)``; forward-mode
        AD of ``f`` otherwise.
      events: optional ``common.EventSpec``; fills ``event_t``,
        ``event_y`` and ``event_count``, and a terminal event stops its
        member with ``STATUS_EVENT``.
      dense_export: record each accepted step's interpolant into the
        result's ``seg_*`` buffers (B × max_steps × (MAX_ORDER+1) × n ×
        (1+m) values) for ``solvers.dense.OdeSolution``.

    Returns an ``IntegrateResult`` with ``ys`` (B, T, n) and ``sens``
    (B, T, n, m).
    """
    dtype = y0.dtype
    dev = y0.device
    B, n = y0.shape
    t0, t_bound, t_eval = common.prepare_times(t_span, y0, t_eval)
    T = t_eval.shape[1]
    # windowed dense output, active only when the window is a strict
    # subset of the grid
    dw = int(config.dense_window)
    dw = dw if 0 < dw < T else 0
    t_eval_c = t_eval.contiguous() if dw else None
    kw = dict(dtype=dtype, device=dev)

    if sens_rhs is not None:
        if s0 is None:
            raise ValueError("sens_rhs requires s0 of shape (B, n, m)")
        m = s0.shape[-1]
    else:
        m = 0

    if jac is None:
        def jac(t, y):
            return common.batched_jacobian(lambda yy: f(t, yy), y)

    factor_fn, solve_fn = make_linear_solver(config.linear_solver,
                                             config.jac_bandwidth)

    f32 = torch.float32
    # Mixed-precision hot loop: RHS/Jacobian/solves and the storage of the
    # whole column block in f32, time and step control in f64.
    mp = config.mixed_precision and dtype == torch.float64
    cdt = f32 if mp else dtype
    if mp:
        def jac_c(t, y):
            return jac(t, y.to(cdt)).to(cdt)

        def factor_c(a):
            return factor_fn(a.to(cdt))

        def solve_c(fact, b):
            return solve_fn(fact, b.to(cdt))

        def f_c(t, y):
            return f(t.to(cdt), y.to(cdt))
    else:
        jac_c, factor_c, solve_c, f_c = jac, factor_fn, solve_fn, f

    split = (config.sens_precision == "f32" and m > 0 and not mp
             and dtype == torch.float64 and not config.sens_error_control)
    if split:
        parts = ((1, dtype), (m, f32))
    elif mp:
        parts = ((1 + m, f32),)
    else:
        parts = ((1 + m, dtype),)

    def _fact32(fact):
        if isinstance(fact, tuple):
            return tuple(a.to(f32) if a.is_floating_point() else a
                         for a in fact)
        return fact.to(f32)

    if m == 0:
        def faug_b(t, Yb):
            return (f_c(t, Yb[0][..., 0])[..., None],)
    elif split:
        def faug_b(t, Yb):
            y = Yb[0][..., 0]
            return (f(t, y)[..., None],
                    sens_rhs(t.to(f32), y.to(f32), Yb[1]))
    else:
        def faug_b(t, Yb):
            Y = Yb[0]
            y = Y[..., 0]
            tc = t.to(cdt)   # storage is already f32 under mixed_precision
            return (torch.cat([f(tc, y)[..., None],
                               sens_rhs(tc, y, Y[..., 1:])], dim=-1),)

    gamma, alpha, error_const = _ndf_constants(dtype, dev)
    eps = torch.finfo(dtype).eps
    newton_tol = max(10 * eps / config.rtol,
                     min(0.03, config.rtol ** 0.5))
    rtol, atol = config.rtol, config.atol
    max_step = torch.tensor(float(config.max_step), **kw)
    I_n = torch.eye(n, **kw)
    rows = torch.arange(D_ROWS, device=dev)
    gamma_pad = torch.cat([gamma, torch.zeros(D_ROWS - MAX_ORDER - 1, **kw)])
    ks5 = torch.arange(1, MAX_ORDER + 1, device=dev)
    one = torch.ones((), **kw)
    inf = torch.tensor(float("inf"), **kw)

    # --- initialization (SciPy BDF __init__) ----------------------------
    if split:
        Y0b = (y0[..., None], s0.to(f32))
    elif m:
        Y0b = (torch.cat([y0[..., None], s0.to(dtype)], dim=-1).to(cdt),)
    else:
        Y0b = (y0[..., None].to(cdt),)
    F0b = faug_b(t0, Y0b)
    f0 = F0b[0][..., 0].to(dtype)
    if config.debug_checks and not bool(torch.isfinite(f0).all()):
        raise FloatingPointError(
            "non-finite RHS at the initial condition")
    if config.first_step is None:
        h0 = common.select_initial_step(
            f, t0, y0, f0, t_bound, config.max_step, rtol, atol, order=1)
    else:
        h0 = torch.full((B,), float(config.first_step), **kw)
    h0 = torch.minimum(h0, torch.abs(t_bound - t0))

    def d_init(Y0p, F0p):
        D = torch.zeros((B, D_ROWS) + Y0p.shape[1:], dtype=Y0p.dtype,
                        device=dev)
        D[:, 0] = Y0p
        D[:, 1] = F0p * bcast(h0.to(Y0p.dtype), F0p)
        return D

    at_t0 = (t_eval == t0[:, None])[:, :, None, None]
    i32 = dict(dtype=torch.int32, device=dev)
    st = dict(
        t=t0, h_abs=h0, order=torch.ones(B, dtype=torch.int64, device=dev),
        D=tuple(d_init(Yp, Fp) for Yp, Fp in zip(Y0b, F0b)),
        J=jac_c(t0, y0), fact=None,
        lu_valid=torch.zeros(B, dtype=torch.bool, device=dev),
        current_jac=torch.zeros(B, dtype=torch.bool, device=dev),
        last_accepted=torch.ones(B, dtype=torch.bool, device=dev),
        n_equal_steps=torch.zeros(B, **i32),
        status=common.status_init(t0, t_bound),
        ys_acc=tuple(torch.where(at_t0, Yp[:, None],
                                 torch.zeros((B, T) + Yp.shape[1:],
                                             dtype=Yp.dtype, device=dev))
                     for Yp in Y0b),
        nsteps=torch.zeros(B, **i32), naccepted=torch.zeros(B, **i32),
        nrejected=torch.zeros(B, **i32),
        nfev=torch.full((B,), 1 + (0 if config.first_step is not None
                                   else 2), **i32),
        njev=torch.ones(B, **i32), nlu=torch.zeros(B, **i32),
        order_hist=torch.zeros((B, MAX_ORDER + 1), **i32),
    )

    # --- event channel ---
    if events is not None:
        g0 = torch.as_tensor(events.fn(t0, y0), **kw)
        if g0.ndim != 2 or g0.shape[0] != B:
            raise ValueError(f"EventSpec.fn must return ({B}, E); got "
                             f"{tuple(g0.shape)}")
        n_ev = g0.shape[1]
        ev_cap = int(events.capacity)
        ev_dir = torch.as_tensor(events.direction or (0,) * n_ev,
                                 dtype=torch.int32, device=dev)
        ev_term = torch.as_tensor(events.terminal or (False,) * n_ev,
                                  dtype=torch.bool, device=dev)
        if ev_dir.shape != (n_ev,) or ev_term.shape != (n_ev,):
            raise ValueError("EventSpec direction/terminal length must "
                             "match the event vector length")
        st.update(g_old=g0, ev_t=torch.full((B, n_ev, ev_cap), inf, **kw),
                  ev_y=torch.zeros((B, n_ev, ev_cap, n), **kw),
                  ev_count=torch.zeros((B, n_ev), **i32))

    # --- dense-export buffers, written in place per accepted step (a
    #     member that is not running or underflows writes its old value) ---
    if dense_export:
        S = int(config.max_steps)
        seg = dict(t=torch.full((B, S), inf, **kw),
                   h=torch.zeros((B, S), **kw),
                   order=torch.zeros((B, S), **i32),
                   D=tuple(torch.zeros((B, S, MAX_ORDER + 1) + Yp.shape[1:],
                                       dtype=Yp.dtype, device=dev)
                           for Yp in Y0b))
    bi_all = torch.arange(B, device=dev)

    def interp_part(Dp, tv, t_new, h_new, order_new):
        """BdfDenseOutput of part ``Dp`` at times ``tv`` (B, T) ->
        (B, T, n, k). With ``dense_f32`` the correction on top of the exact
        D[0] anchor runs in f32."""
        dt = Dp.dtype
        cdt = f32 if config.dense_f32 else dt
        jj = torch.arange(MAX_ORDER, **kw)
        t_shift = t_new[:, None] - h_new[:, None] * jj
        denom = h_new[:, None] * (1.0 + jj)
        # form x in f64 (the time differences cancel), then the polynomial
        x = (tv[:, :, None] - t_shift[:, None, :]) / denom[:, None, :]
        # running product left to right, as the reference's cumprod (a
        # CPU torch.cumprod associates differently and rounds elsewhere)
        xc = x.to(cdt)
        cols = [xc[..., 0]]
        for j in range(1, MAX_ORDER):
            cols.append(cols[-1] * xc[..., j])
        p = torch.stack(cols, dim=2)
        p = torch.where(ks5 <= order_new[:, None, None], p,
                        torch.zeros((), dtype=cdt, device=dev))
        corr = _wsum(p, Dp[:, 1:MAX_ORDER + 1].to(cdt))
        return Dp[:, None, 0] + corr.to(dt)

    def body(st):
        t, order = st["t"], st["order"]
        orderf = order.to(dtype)
        h_abs = st["h_abs"]
        D = st["D"]
        lu_valid = st["lu_valid"]
        n_equal_steps = st["n_equal_steps"]
        last_accepted = st["last_accepted"]
        running = st["status"] == STATUS_RUNNING
        if config.debug_checks:
            bad = torch.nonzero(~(h_abs > 0) & running)
            if bad.numel():
                i = int(bad[0, 0])
                raise FloatingPointError(
                    f"non-positive step size h={float(h_abs[i])} at "
                    f"t={float(t[i])}")

        # SciPy clamps h into [min_step, max_step] at a fresh step; inside
        # a retry sequence h < min_step is fatal.
        min_step = 10 * eps * torch.abs(t)
        too_small = (h_abs < min_step) & ~last_accepted
        h_clamped = torch.minimum(torch.maximum(h_abs, min_step), max_step)
        pre_clamp = last_accepted & (h_clamped != h_abs)
        pre_factor = torch.where(pre_clamp, h_clamped / h_abs, one)
        n_equal_steps = torch.where(pre_clamp, 0, n_equal_steps)
        h_abs = torch.where(last_accepted, h_clamped, h_abs)

        # clip the final step to t_bound (with dense_window also to the
        # (window-1)-th next t_eval point); the clamp and clip rescalings
        # compose into one change_D
        if dw:
            lo_eval = torch.searchsorted(t_eval_c, t[:, None].contiguous(),
                                         right=True)[:, 0]
            last = torch.clamp(lo_eval + (dw - 1), max=T - 1)
            t_cap = torch.where(
                lo_eval + (dw - 1) < T,
                torch.gather(t_eval, 1, last[:, None])[:, 0], inf)
            bound_eff = torch.minimum(t_bound, t_cap)
        else:
            bound_eff = t_bound
        t_new_raw = t + h_abs
        clipped = t_new_raw > bound_eff
        t_new = torch.where(clipped, bound_eff, t_new_raw)
        h = t_new - t
        clip_factor = torch.where(clipped, h / h_abs, one)
        rescale = pre_clamp | clipped
        if bool((rescale & running).any()):
            f_tot = pre_factor * clip_factor
            D = tuple(where_members(rescale, _wsum(
                _padded_transform(f_tot.to(Dp.dtype), order), Dp), Dp)
                for Dp in D)
        n_equal_steps = torch.where(clipped, 0, n_equal_steps)
        lu_valid = lu_valid & ~clipped
        h_abs = h

        # --- prediction ---
        pred_w = (rows[None, :] <= order[:, None]).to(dtype)
        y_predict = tuple(_wsum(pred_w, Dp) for Dp in D)
        alpha_o = alpha[order]
        psi_w = torch.where((rows[None, :] >= 1)
                            & (rows[None, :] <= order[:, None]),
                            gamma_pad[rows][None, :], 0.0 * one)
        c = h / alpha_o
        psi = tuple(_wsum(psi_w / alpha_o[:, None], Dp) for Dp in D)
        scale_state = atol + rtol * torch.abs(y_predict[0][..., 0])

        # --- factorization (reused while SciPy would reuse it) ---
        fact = st["fact"]
        if bool((running & ~lu_valid).any()):
            new = factor_c(I_n - c[:, None, None] * st["J"].to(dtype))
            fact = new if fact is None else where_members(lu_valid, fact, new)
        nlu = st["nlu"] + (~lu_valid).to(torch.int32)
        fact32 = _fact32(fact) if split else None

        # --- modified Newton, masked; the batch union of trips ---
        c_b = tuple(c.to(dt) for _, dt in parts)
        Y = y_predict
        d = tuple(torch.zeros_like(yp) for yp in y_predict)
        dy_norm_old = torch.zeros(B, **kw)
        n_iter = torch.zeros(B, **i32)
        converged = torch.zeros(B, dtype=torch.bool, device=dev)
        failed = ~running   # members not running take no trips
        it = torch.zeros(B, **i32)
        while True:
            go = (it < NEWTON_MAXITER) & ~(converged | failed)
            if not bool(go.any()):
                break
            Fv = faug_b(t_new, Y)
            nonfinite = ~torch.stack(
                [torch.isfinite(Fp).reshape(B, -1).all(1) for Fp in Fv]
            ).all(0)
            resid = tuple(bcast(cb, Fp) * Fp - pp - dp
                          for cb, Fp, pp, dp in zip(c_b, Fv, psi, d))
            if split:
                dy = (solve_c(fact, resid[0]), solve_fn(fact32, resid[1]))
            else:
                dy = (solve_c(fact, resid[0]),)
            dy_norm = rms_norm(dy[0][..., 0] / scale_state)
            rate = dy_norm / torch.where(dy_norm_old > 0, dy_norm_old, one)
            have_rate = it > 0
            diverged = have_rate & (
                (rate >= 1.0)
                | (rate ** (NEWTON_MAXITER - it).to(dtype) / (1.0 - rate)
                   * dy_norm > newton_tol))
            ok = go & ~nonfinite & ~diverged
            Y = tuple(where_members(ok, Yp + dyp, Yp)
                      for Yp, dyp in zip(Y, dy))
            d = tuple(where_members(ok, dp + dyp, dp)
                      for dp, dyp in zip(d, dy))
            conv_now = ok & ((dy_norm == 0.0)
                             | (have_rate & (rate / (1.0 - rate) * dy_norm
                                             < newton_tol)))
            converged = converged | conv_now
            failed = failed | (go & (nonfinite | diverged))
            n_iter = n_iter + go.to(torch.int32)
            dy_norm_old = torch.where(ok, dy_norm, dy_norm_old)
            it = it + go.to(torch.int32)
        Y_new = Y
        nfev = st["nfev"] + n_iter

        # --- outcome classification ---
        # B: Newton failed with a stale J -> refresh J, retry at same h.
        case_B = ~converged & ~st["current_jac"]
        # C: Newton failed with fresh J -> halve the step.
        case_C = ~converged & st["current_jac"]
        J = st["J"]
        if bool((case_B & running).any()):
            J = where_members(case_B, jac_c(t_new, y_predict[0][..., 0]), J)
        njev = st["njev"] + case_B.to(torch.int32)

        safety = (config.safety * (2 * NEWTON_MAXITER + 1)
                  / (2 * NEWTON_MAXITER + n_iter.to(dtype)))
        scale_new = atol + rtol * torch.abs(Y_new[0][..., 0])
        d0, D0 = d[0], D[0]
        pdt = D0.dtype
        err = bcast(error_const[order].to(pdt), d0) * d0
        if config.sens_error_control and m and not split:
            scale_full = atol + rtol * torch.abs(Y_new[0])
            error_norm = rms_norm(err / scale_full).to(dtype)
        else:
            scale_full = None
            error_norm = rms_norm(err[..., 0] / scale_new).to(dtype)
        # NaN compares false and would ACCEPT a garbage step
        bad_err = ~torch.isfinite(error_norm)
        error_norm = torch.where(bad_err, 2.0 * one, error_norm)
        reject = converged & ((error_norm > 1.0) | bad_err)
        accept = converged & ~reject

        # --- order/step adaptation once n_equal > order ---
        n_equal_acc = n_equal_steps + 1
        do_adapt = accept & (n_equal_acc >= order + 1)
        bi = torch.arange(B, device=dev)
        ec_m = error_const[torch.clamp(order - 1, min=0)].to(pdt)
        ec_p = error_const[torch.clamp(order + 1, max=MAX_ORDER)].to(pdt)
        # D_acc[order] = D[order] + d;  D_acc[order+2] = d - D[order+1]
        err_m = bcast(ec_m, d0) * (D0[bi, order] + d0)
        err_p = bcast(ec_p, d0) * (d0 - D0[bi, order + 1])
        if scale_full is not None:
            em = rms_norm(err_m / scale_full).to(dtype)
            ep = rms_norm(err_p / scale_full).to(dtype)
        else:
            em = rms_norm(err_m[..., 0] / scale_new).to(dtype)
            ep = rms_norm(err_p[..., 0] / scale_new).to(dtype)
        err_m_norm = torch.where(order > 1, em, inf)
        err_p_norm = torch.where(order < MAX_ORDER, ep, inf)
        error_norms = torch.stack([err_m_norm, error_norm, err_p_norm], 1)
        exponents = -1.0 / (orderf[:, None]
                            + torch.arange(3, **kw)[None, :])
        finite_norm = torch.isfinite(error_norms)
        safe_norms = torch.where(finite_norm,
                                 torch.clamp(error_norms, min=eps), one)
        factors = torch.where(finite_norm, safe_norms ** exponents,
                              0.0 * one)
        best = torch.argmax(factors, dim=1)
        order_adapt = torch.clamp(order + best - 1, 1, MAX_ORDER)
        factor_adapt = torch.clamp(safety * torch.amax(factors, dim=1),
                                   max=config.max_factor)

        factor_rej = torch.clamp(
            safety * error_norm ** (-1.0 / (orderf + 1.0)),
            min=config.min_factor)
        h_factor = torch.where(
            case_C, 0.5 * one,
            torch.where(reject, factor_rej,
                        torch.where(do_adapt, factor_adapt, one)))
        change = case_C | reject | do_adapt
        order_new = torch.where(do_adapt, order_adapt, order)

        # Compose (change_D rescale ∘ accept update) into one (D_ROWS,
        # D_ROWS) map W and a rank-one weight v per member:
        # D_new = W @ D + v ⊗ d. The accept update (append d at rows
        # order+1/order+2, then the downward telescoping sweep) is
        #   rows i<=order:  Σ_{j=i}^{order} D[j] + d
        #   row order+1:    d
        #   row order+2:    d - D[order+1]
        #   rows above:     identity
        ri, rj = rows[:, None], rows[None, :]
        o = order[:, None, None]
        eyeD = (ri == rj).to(dtype)
        acc_M = torch.where(
            ri <= o, ((rj >= ri) & (rj <= o)).to(dtype),
            torch.where(ri == o + 2, -(rj == o + 1).to(dtype),
                        ((ri == rj) & (ri > o + 2)).to(dtype)))
        acc_u = (rows[None, :] <= order[:, None] + 2).to(dtype)
        Ma = torch.where(accept[:, None, None], acc_M, eyeD)
        ua = torch.where(accept[:, None], acc_u, 0.0 * one)
        Tc = torch.where(change[:, None, None],
                         _padded_transform(h_factor, order_new), eyeD)
        W = Tc @ Ma
        v = (Tc @ ua[:, :, None])[:, :, 0]
        D_new = tuple(_wsum(W, Dp)
                      + bcast(v.to(Dp.dtype), Dp) * dp[:, None]
                      for Dp, dp in zip(D, d))
        h_new = h_abs * torch.where(change, h_factor, one)

        t_next = torch.where(accept, t_new, t)
        n_equal_new = torch.where(accept & ~do_adapt, n_equal_acc, 0)
        # SciPy keeps the factorization across error-test rejections;
        # only Newton failure, a Jacobian refresh or adaptation drop it.
        lu_valid_new = ~(case_B | case_C | do_adapt)
        current_jac_new = torch.where(
            case_B, True, torch.where(accept, False, st["current_jac"]))

        # --- dense export: this step's interpolant, pre-event-rewrite ---
        if dense_export:
            write = accept & running & ~too_small
            slot = torch.clamp(st["naccepted"], max=S - 1).to(torch.int64)
            for key, val in (("t", t_new), ("h", h_new),
                             ("order", order_new.to(torch.int32))):
                buf = seg[key]
                buf[bi_all, slot] = torch.where(write, val,
                                                buf[bi_all, slot])
            for Dp, buf in zip(D_new, seg["D"]):
                buf[bi_all, slot] = torch.where(
                    bcast(write, Dp[:, :MAX_ORDER + 1]),
                    Dp[:, :MAX_ORDER + 1], buf[bi_all, slot])

        # --- state-dependent events ---
        ev_new = {}
        has_term = None
        t_fill_hi = t_new
        D_fill = D_new
        if events is not None:
            def y_at(tv):
                # state column of this step's interpolant at tv (B, E)
                return interp_part(D_new[0], tv, t_new, h_new,
                                   order_new)[..., 0].to(dtype)

            g_old = st["g_old"]
            g_new = torch.as_tensor(events.fn(t_new, Y_new[0][..., 0]
                                              .to(dtype)), **kw)
            up = (g_old <= 0) & (g_new >= 0)
            down = (g_old >= 0) & (g_new <= 0)
            trig = torch.where(ev_dir > 0, up,
                               torch.where(ev_dir < 0, down, up | down))
            fired = accept[:, None] & trig
            hi = t_new[:, None].expand(B, n_ev)
            if bool((fired & running[:, None]).any()):
                # bisection on the step's polynomial; fn is evaluated once
                # per event at that event's mids, keeping member order
                lo, glo = t[:, None].expand(B, n_ev), g_old
                for _ in range(int(events.bisect_iters)):
                    mid = 0.5 * (lo + hi)
                    ys_mid = y_at(mid)
                    g_mid = torch.stack(
                        [torch.as_tensor(events.fn(mid[:, e],
                                                   ys_mid[:, e]), **kw)[:, e]
                         for e in range(n_ev)], dim=1)
                    same = ((torch.sign(g_mid) == torch.sign(glo))
                            & (g_mid != 0.0))
                    lo = torch.where(same, mid, lo)
                    hi = torch.where(same, hi, mid)
                    glo = torch.where(same, g_mid, glo)
            t_root = torch.where(fired, hi, inf)
            # the earliest terminal root ends the member there; later
            # occurrences of any event are discarded
            t_term = torch.amin(torch.where(fired & ev_term, t_root, inf),
                                dim=1)
            has_term = torch.isfinite(t_term)
            rec = fired & (t_root <= t_term[:, None])
            count = st["ev_count"]
            slot_e = torch.clamp(count, max=ev_cap - 1).to(torch.int64)
            can_store = rec & (count < ev_cap)
            ys_root = y_at(torch.where(torch.isfinite(t_root), t_root,
                                       t_new[:, None]))
            ev_t = st["ev_t"].clone()
            ev_y = st["ev_y"].clone()
            old_t = torch.gather(ev_t, 2, slot_e[..., None])[..., 0]
            ev_t.scatter_(2, slot_e[..., None],
                          torch.where(can_store, t_root, old_t)[..., None])
            idx_y = slot_e[..., None, None].expand(B, n_ev, 1, n)
            old_y = torch.gather(ev_y, 2, idx_y)[:, :, 0]
            ev_y.scatter_(2, idx_y, torch.where(can_store[..., None],
                                                ys_root, old_y)[:, :, None])
            t_term_safe = torch.where(has_term, t_term, t_new)
            ev_new = dict(g_old=torch.where(accept[:, None], g_new, g_old),
                          ev_t=ev_t, ev_y=ev_y,
                          ev_count=count + rec.to(torch.int32))
            # t_eval is filled from the step's own polynomial up to the
            # event time; the anchor row then moves to the event state
            t_fill_hi = t_term_safe
            Y_term = tuple(interp_part(Dp, t_term_safe[:, None], t_new,
                                       h_new, order_new)[:, 0]
                           for Dp in D_new)
            D_new = tuple(torch.cat([torch.where(bcast(has_term, Yt), Yt,
                                                 Dp[:, 0])[:, None],
                                     Dp[:, 1:]], dim=1)
                          for Dp, Yt in zip(D_new, Y_term))

        # --- dense output at t_eval from the post-update D/order/h ---
        t_old_fill = torch.where(accept, t, inf)
        if dw:
            ys_acc = tuple(
                common.interp_accumulate_windowed(
                    t_eval, lo_eval, t_old_fill, t_fill_hi,
                    lambda tv, Dp=Dp: interp_part(Dp, tv, t_new, h_new,
                                                  order_new), acc, dw,
                    gate=accept)
                for Dp, acc in zip(D_fill, st["ys_acc"]))
        else:
            ys_acc = tuple(
                common.interp_accumulate(
                    t_eval, t_old_fill, t_fill_hi,
                    lambda tv, Dp=Dp: interp_part(Dp, tv, t_new, h_new,
                                                  order_new), acc)
                for Dp, acc in zip(D_fill, st["ys_acc"]))

        nsteps = st["nsteps"] + 1
        done, status = common.step_status(accept, t_new, t_bound, nsteps,
                                          config.max_steps)
        if has_term is not None:
            status = torch.where(has_term, STATUS_EVENT, status).to(
                torch.int32)
            t_next = torch.where(has_term, t_term_safe, t_next)

        acc32 = accept.to(torch.int32)
        new_st = dict(
            t=t_next, h_abs=h_new, order=order_new, D=D_new, J=J,
            fact=fact, lu_valid=lu_valid_new, current_jac=current_jac_new,
            last_accepted=accept, n_equal_steps=n_equal_new, status=status,
            ys_acc=ys_acc, nsteps=nsteps,
            naccepted=st["naccepted"] + acc32,
            nrejected=st["nrejected"] + (reject | case_C).to(torch.int32),
            nfev=nfev, njev=njev, nlu=nlu,
            order_hist=st["order_hist"]
            + torch.nn.functional.one_hot(order, MAX_ORDER + 1)
            .to(torch.int32) * acc32[:, None], **ev_new)

        return common.settle(dict(st, fact=fact), new_st, too_small,
                             running)

    while bool((st["status"] == STATUS_RUNNING).any()):
        st = body(st)

    if split:
        ys = st["ys_acc"][0][..., 0]
        sens = st["ys_acc"][1].to(dtype)
    else:
        ys = st["ys_acc"][0][..., 0]
        sens = st["ys_acc"][0][..., 1:]
    y_final = torch.cat([Dp[:, 0].to(dtype) for Dp in st["D"]], dim=-1)
    extra = {}
    if events is not None:
        extra.update(event_t=st["ev_t"], event_y=st["ev_y"],
                     event_count=st["ev_count"])
    if dense_export:
        extra.update(seg_t=seg["t"], seg_h=seg["h"], seg_order=seg["order"],
                     seg_D=seg["D"])
    return IntegrateResult(
        ys=ys, sens=sens, status=st["status"], nsteps=st["nsteps"],
        naccepted=st["naccepted"], nrejected=st["nrejected"],
        nfev=st["nfev"], njev=st["njev"], nlu=st["nlu"],
        order_hist=st["order_hist"], t_final=st["t"], y_final=y_final,
        **extra)
