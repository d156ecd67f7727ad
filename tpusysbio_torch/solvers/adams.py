"""Variable-order Adams–Bashforth–Moulton (PECE) non-stiff integrator over
a batch of members.

Port of ``tpusysbio/solvers/adams.py``: a predictor–corrector Adams method
of order 2..9 in backward-difference form on a quasi-constant step, two
RHS evaluations per step and no factorization. The state carries the
backward differences ``DF[j] = ∇^j f_n`` (ROWS rows, masked by the live
order); a step-size change rescales them with the BDF stepper's
difference transform; the dense output integrates the Newton
backward-difference interpolant of f through the new point. The
coefficient tables (``_adams_gammas``, ``_dense_coeffs``) are host-side
numpy constants.

``stiff_exit=True`` ends a member with ``STATUS_STIFF`` once its pace has
been stability-limited on five consecutive steps (dopri5's detector with
the controller's hypothetical growth factor as the gate), for
``auto_solve``'s warm handoff.

Batching follows ``solvers/bdf.py``: the step loop runs until no member is
running, and a member that is not running keeps its whole state; a
rescaling is computed for the batch when any running member needs it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.solvers import common
from tpusysbio_torch.solvers.common import (
    STATUS_RUNNING,
    STATUS_STIFF,
    IntegrateResult,
    bcast,
    rms_norm,
)
from tpusysbio_torch.solvers.dopri5 import STIFF_STEPS

MAX_Q = 8               # max predictor (AB) order; corrector order MAX_Q+1
ROWS = MAX_Q + 2        # difference rows 0..MAX_Q+1


def _adams_gammas(n_terms: int):
    """AB coefficients γ_j and AM coefficients γ*_j (Hairer, Nørsett &
    Wanner I, III.1): γ_m = 1 − Σ_{i<m} γ_i/(m+1−i), γ*_m = −Σ_{i<m}
    γ*_i/(m+1−i), with γ_0 = γ*_0 = 1."""
    g = np.zeros(n_terms)
    gs = np.zeros(n_terms)
    g[0] = gs[0] = 1.0
    for m in range(1, n_terms):
        g[m] = 1.0 - sum(g[i] / (m + 1 - i) for i in range(m))
        gs[m] = -sum(gs[i] / (m + 1 - i) for i in range(m))
    return g, gs


_GAMMA, _GAMMA_STAR = _adams_gammas(ROWS + 1)


def _dense_coeffs():
    """(ROWS, ROWS+2) matrix C with I_j(θ) = Σ_m C[j, m] θ^m, the
    antiderivative of the Newton backward-difference basis term_j(u) =
    Π_{i<j} (u+i)/(i+1)."""
    C = np.zeros((ROWS, ROWS + 2))
    term = np.array([1.0])
    for j in range(ROWS):
        anti = np.concatenate([[0.0], term / np.arange(1, term.size + 1)])
        C[j, :anti.size] = anti
        term = (np.convolve(term, [j, 1.0])) / (j + 1)
    return C


_DENSE_C = _dense_coeffs()


def _compute_R(factor):
    """(B, ROWS, ROWS) difference-rescaling matrices for ``factor`` (B,)."""
    kw = dict(dtype=factor.dtype, device=factor.device)
    i = torch.arange(ROWS, **kw)[:, None]
    j = torch.arange(ROWS, **kw)[None, :]
    body = (i - 1.0 - factor[:, None, None] * j) / torch.clamp(i, min=1.0)
    one = torch.ones((), **kw)
    m = torch.where(i == 0, one, torch.where(j == 0, 0.0 * one, body))
    return torch.cumprod(m, dim=1)


def _change_DF(DF, order, factor):
    """Rescale ``DF[:order+1]`` per member for a step change: ``(R(f)
    R(1))ᵀ`` on the leading block, identity outside."""
    P = _compute_R(factor) @ _compute_R(torch.ones_like(factor))
    rows = torch.arange(ROWS, device=DF.device)
    i, j = rows[:, None], rows[None, :]
    o = order[:, None, None]
    eye = (i == j).to(DF.dtype)
    T = torch.where((i <= o) & (j <= o), P.transpose(1, 2), eye)
    return torch.einsum("bij,bj...->bi...", T, DF)


def adams_solve(
    f: Callable,
    t_span,
    y0: torch.Tensor,
    t_eval: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    sens_rhs: Optional[Callable] = None,
    s0: Optional[torch.Tensor] = None,
    jac: Optional[Callable] = None,   # unused (no Newton iteration)
    stiff_exit: bool = False,
) -> IntegrateResult:
    """Integrate ``dy/dt = f(t, y)`` forward; same interface as
    ``bdf_solve``, plus ``stiff_exit``. Two RHS evaluations per step."""
    del jac
    dtype, dev = y0.dtype, y0.device
    B, n = y0.shape
    t0, t_bound, t_eval = common.prepare_times(t_span, y0, t_eval)
    T = t_eval.shape[1]
    kw = dict(dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    faug = common.augmented_rhs(f, sens_rhs)
    Y0, m = common.initial_block(y0, s0, sens_rhs)
    k = 1 + m

    gamma = torch.as_tensor(_GAMMA, **kw)
    gamma_star = torch.as_tensor(_GAMMA_STAR, **kw)
    dense_C = torch.as_tensor(_DENSE_C, **kw)
    rtol, atol = config.rtol, config.atol
    max_step = torch.tensor(float(config.max_step), **kw)
    rows = torch.arange(ROWS, device=dev)
    eps = torch.finfo(dtype).eps
    one = torch.ones((), **kw)
    inf = torch.tensor(float("inf"), **kw)
    bi = torch.arange(B, device=dev)

    F0 = faug(t0, Y0)
    if config.first_step is None:
        h0 = common.select_initial_step(
            f, t0, y0, F0[..., 0], t_bound, config.max_step, rtol, atol,
            order=1)
    else:
        h0 = torch.full((B,), float(config.first_step), **kw)
    h0 = torch.minimum(h0, torch.abs(t_bound - t0))

    DF0 = torch.zeros((B, ROWS, n, k), **kw)
    DF0[:, 0] = F0
    at_t0 = (t_eval == t0[:, None])[:, :, None, None]
    st = dict(
        t=t0, y=Y0, DF=DF0, h_abs=h0,
        order=torch.ones(B, dtype=torch.int64, device=dev),
        n_equal_steps=torch.zeros(B, **i32), n_fail=torch.zeros(B, **i32),
        last_accepted=torch.ones(B, dtype=torch.bool, device=dev),
        status=common.status_init(t0, t_bound),
        ys_acc=torch.where(at_t0, Y0[:, None],
                           torch.zeros((B, T, n, k), **kw)),
        nsteps=torch.zeros(B, **i32), naccepted=torch.zeros(B, **i32),
        nrejected=torch.zeros(B, **i32),
        nfev=torch.full((B,), 1 + (0 if config.first_step is not None
                                   else 2), **i32),
        order_hist=torch.zeros((B, 6), **i32),
        stiff_count=torch.zeros(B, **i32))

    def rescale(DF, mask, order, factor, running):
        if bool((mask & running).any()):
            return torch.where(bcast(mask, DF),
                               _change_DF(DF, order, factor), DF)
        return DF

    def body(st):
        t, y, order = st["t"], st["y"], st["order"]
        orderf = order.to(dtype)
        DF = st["DF"]
        h_abs = st["h_abs"]
        n_equal = st["n_equal_steps"]
        running = st["status"] == STATUS_RUNNING

        min_step = 10 * eps * torch.abs(t)
        too_small = (h_abs < min_step) & ~st["last_accepted"]
        h_clamped = torch.minimum(torch.maximum(h_abs, min_step), max_step)
        pre_clamp = st["last_accepted"] & (h_clamped != h_abs)
        DF = rescale(DF, pre_clamp, order, h_clamped / h_abs, running)
        n_equal = torch.where(pre_clamp, 0, n_equal)
        h_abs = torch.where(st["last_accepted"], h_clamped, h_abs)

        # clip the final step to t_bound, rescaling DF
        t_new_raw = t + h_abs
        clipped = t_new_raw > t_bound
        t_new = torch.where(clipped, t_bound, t_new_raw)
        h = t_new - t
        DF = rescale(DF, clipped, order, torch.where(clipped, h / h_abs, one),
                     running)
        n_equal = torch.where(clipped, 0, n_equal)
        h_abs = h
        hb = h[:, None, None]

        # --- P: Adams–Bashforth predictor, order q ---
        pred_w = torch.where(rows[None, :] <= order[:, None] - 1,
                             gamma[rows][None, :], 0.0 * one)
        y_pred = y + hb * torch.einsum("bi,bink->bnk", pred_w, DF)
        f_pred = faug(t_new, y_pred)

        # new-point differences ∇^j f_{n+1} = f_{n+1} − Σ_{i<j} DF[i]
        prefix = torch.cumsum(DF, dim=1)
        prefix_ex = torch.cat([torch.zeros_like(DF[:, :1]), prefix[:, :-1]],
                              dim=1)
        g_q = gamma[order][:, None, None]

        # --- C: Adams–Moulton corrector, order q+1 ---
        y_corr1 = y_pred + hb * g_q * (f_pred - prefix_ex[bi, order])

        # --- E: the evaluation at the corrected point drives error,
        #     history and a second corrector application ---
        f_new = faug(t_new, y_corr1)
        c = f_new[:, None] - prefix_ex
        y_new = y_pred + hb * g_q * c[bi, order]

        scale = atol + rtol * torch.maximum(torch.abs(y[..., 0]),
                                            torch.abs(y_new[..., 0]))
        if config.sens_error_control and m:
            scale_full = atol + rtol * torch.maximum(torch.abs(y),
                                                     torch.abs(y_new))

        def est_norm(p):
            """Scaled LTE norm of corrector order p: h γ*_p ∇^p f_{n+1}."""
            cp = c[bi, torch.clamp(p, 0, ROWS - 1)]
            est = hb * gamma_star[torch.clamp(p, 0, ROWS)][:, None,
                                                           None] * cp
            if config.sens_error_control and m:
                return rms_norm(est / scale_full)
            return rms_norm(est[..., 0] / scale)

        error_norm = est_norm(order + 1)
        finite = common.finite_members(y_new, f_new)
        bad_err = ~torch.isfinite(error_norm) | ~finite
        error_norm = torch.where(bad_err, 2.0 * one, error_norm)
        accept = ~bad_err & (error_norm <= 1.0)

        # --- order adaptation after q+1 equal steps ---
        n_equal_acc = n_equal + 1
        do_adapt = accept & (n_equal_acc >= order + 1)
        err_m = torch.where(order > 1, est_norm(order), inf)
        err_p = torch.where(order < MAX_Q, est_norm(order + 2), inf)
        error_norms = torch.stack([err_m, error_norm, err_p], dim=1)
        exponents = -1.0 / (orderf[:, None] + 1.0
                            + torch.arange(3, **kw)[None, :])
        finite_norm = torch.isfinite(error_norms)
        safe_norms = torch.where(finite_norm,
                                 torch.clamp(error_norms, min=eps), one)
        factors = torch.where(finite_norm, safe_norms ** exponents,
                              0.0 * one)
        best = torch.argmax(factors, dim=1)
        order_adapt = torch.clamp(order + best - 1, 1, MAX_Q)
        factor_adapt = torch.clamp(config.safety * torch.amax(factors, dim=1),
                                   max=config.max_factor)

        factor_rej = torch.where(
            bad_err, 0.5 * one,
            torch.clamp(config.safety
                        * error_norm ** (-1.0 / (orderf + 2.0)),
                        min=config.min_factor))
        h_factor = torch.where(
            accept, torch.where(do_adapt, factor_adapt, one), factor_rej)
        change = ~accept | do_adapt
        # each rejection beyond the first drops one order
        n_fail_new = torch.where(accept, 0, st["n_fail"] + 1).to(torch.int32)
        order_drop = torch.clamp(
            order - torch.clamp(n_fail_new - 1, min=0), min=1)
        order_new = torch.where(
            accept, torch.where(do_adapt, order_adapt, order), order_drop)

        DF_base = torch.where(bcast(accept, DF), c, DF)
        DF_new = rescale(DF_base, change, order_new, h_factor, running)
        h_new = h_abs * torch.where(change, h_factor, one)
        n_equal_new = torch.where(accept & ~do_adapt, n_equal_acc,
                                  0).to(torch.int32)

        # --- dense output (the integrated backward-difference interpolant)
        def interp(tv):
            theta = (tv - t_new[:, None]) / h[:, None]        # (B, T)
            cols = [torch.ones_like(theta), theta]
            for _ in range(ROWS):
                cols.append(cols[-1] * theta)
            pw = torch.stack(cols, dim=2)                     # (B, T, R+2)
            Ij = pw @ dense_C.T                               # (B, T, R)
            Ij = torch.where(rows[None, None, :] <= order[:, None, None],
                             Ij, 0.0 * one)
            return y_new[:, None] + hb[:, None] * torch.einsum(
                "bti,bink->btnk", Ij, c)

        ys_acc = common.interp_accumulate(
            t_eval, torch.where(accept, t, inf), t_new, interp,
            st["ys_acc"])

        nsteps = st["nsteps"] + 1
        done, status = common.step_status(accept, t_new, t_bound, nsteps,
                                          config.max_steps)
        stiff_count = st["stiff_count"]
        if stiff_exit:
            # Adams changes h only at adaptation events, so the gate is
            # the controller's hypothetical growth factor
            t_cur = torch.where(accept, t_new, t)
            projected = (t_bound - t_cur) / torch.maximum(h_new, min_step)
            hypo = config.safety * torch.clamp(error_norm, min=eps) ** (
                -1.0 / (orderf + 2.0))
            would_grow = accept & (hypo > 1.2)
            limited = (~done & ~would_grow
                       & (projected > (config.max_steps - nsteps).to(dtype)))
            stiff_count = torch.where(limited, stiff_count + 1, 0).to(
                torch.int32)
            status = torch.where(stiff_count >= STIFF_STEPS, STATUS_STIFF,
                                 status).to(torch.int32)

        acc32 = accept.to(torch.int32)
        hist_slot = torch.clamp(order + 1, max=5)
        new_st = dict(
            t=torch.where(accept, t_new, t),
            y=torch.where(bcast(accept, y), y_new, y),
            DF=DF_new, h_abs=h_new, order=order_new,
            n_equal_steps=n_equal_new, n_fail=n_fail_new,
            last_accepted=accept, status=status, ys_acc=ys_acc,
            nsteps=nsteps, naccepted=st["naccepted"] + acc32,
            nrejected=st["nrejected"] + (1 - acc32), nfev=st["nfev"] + 2,
            order_hist=st["order_hist"]
            + torch.nn.functional.one_hot(hist_slot, 6).to(torch.int32)
            * acc32[:, None],
            stiff_count=stiff_count)

        return common.settle(st, new_st, too_small, running)

    while bool((st["status"] == STATUS_RUNNING).any()):
        st = body(st)

    zeros = torch.zeros(B, **i32)
    return IntegrateResult(
        ys=st["ys_acc"][..., 0], sens=st["ys_acc"][..., 1:],
        status=st["status"], nsteps=st["nsteps"],
        naccepted=st["naccepted"], nrejected=st["nrejected"],
        nfev=st["nfev"], njev=zeros, nlu=zeros.clone(),
        order_hist=st["order_hist"], t_final=st["t"], y_final=st["y"])
