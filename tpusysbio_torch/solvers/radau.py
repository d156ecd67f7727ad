"""Radau IIA order-5 implicit Runge-Kutta stiff integrator over a batch of
members.

Port of ``tpusysbio/solvers/radau.py`` (itself SciPy's ``_ivp/radau.py``
algorithm): the collocation system solved in the eigenbasis of the
Butcher matrix, the Hairer two-step predictive step control, the
rejected-step error re-estimate, the Jacobian-recompute heuristic
(``n_iter > 2`` and ``rate > 1e-3``) and the cubic interpolant.

Each factorization is a pair: ``μ_r/h·I − J`` (n × n) and the real
2n × 2n embedding ``[[a·I − J, −b·I], [b·I, a·I − J]]`` of the complex
matrix ``(μ_c/h)·I − J``, both through ``make_linear_solver``. Under
``linear_solver='pallas'`` a model of n ≤ 32 gives the Gauss-Jordan
kernel both n and 2n, and the f64 state column goes through the
refined-solve kernel at both; with ``sens_precision='f32'`` the
sensitivity columns take the f32 inverse and an f32 matmul.

Batching follows ``solvers/bdf.py``:

- the step loop runs until no member is running; a member that is not
  running keeps its whole state;
- the reference's fixed-trip Newton loop keeps its trip count and its
  per-member masks; trips after every member has converged or failed
  change nothing and are skipped;
- each ``lax.cond`` (factorization reuse, the Jacobian refresh, the
  rejected-step re-estimate, the accepted step's new RHS and Jacobian)
  is computed for the batch when any running member needs it, then
  merged per member.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.linalg import make_linear_solver
from tpusysbio_torch.solvers import common
from tpusysbio_torch.solvers.common import (
    STATUS_RUNNING,
    IntegrateResult,
    bcast,
    rms_norm,
    where_members,
)

_S6 = math.sqrt(6.0)
_C = np.array([(4 - _S6) / 10, (4 + _S6) / 10, 1.0])
_E = np.array([-13 - 7 * _S6, -13 + 7 * _S6, -1.0]) / 3
_MU_REAL = 3 + 3 ** (2 / 3) - 3 ** (1 / 3)
_MU_C_RE = 3 + 0.5 * (3 ** (1 / 3) - 3 ** (2 / 3))
_MU_C_IM = -0.5 * (3 ** (5 / 6) + 3 ** (7 / 6))
_T = np.array([
    [0.09443876248897524, -0.14125529502095421, 0.03002919410514742],
    [0.25021312296533332, 0.20412935229379994, -0.38294211275726192],
    [1.0, 1.0, 0.0]])
_TI = np.array([
    [4.17871859155190428, 0.32768282076106237, 0.52337644549944951],
    [-4.17871859155190428, -0.32768282076106237, 0.47662355450055044],
    [0.50287263494578682, -2.57192694985560522, 0.59603920482822492]])
_P = np.array([
    [13 / 3 + 7 * _S6 / 3, -23 / 3 - 22 * _S6 / 3, 10 / 3 + 5 * _S6],
    [13 / 3 - 7 * _S6 / 3, -23 / 3 + 22 * _S6 / 3, 10 / 3 - 5 * _S6],
    [1 / 3, -8 / 3, 10 / 3]])

NEWTON_MAXITER = 6
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0


def _mix(w, X):
    """``Σ_j w[j] X[:, j]`` for a row of constants ``w`` and X (B, J, ...),
    summed in order j = 0, 1, ..."""
    out = w[0] * X[:, 0]
    for j in range(1, X.shape[1]):
        out = out + w[j] * X[:, j]
    return out


def newton_matrices(J: torch.Tensor, h: torch.Tensor):
    """The two Newton matrices of a step of size ``h`` (B,) for Jacobians
    ``J`` (B, n, n): ``μ_r/h·I − J`` and the real 2n × 2n embedding of
    ``μ_c/h·I − J``."""
    n = J.shape[-1]
    I_n = torch.eye(n, dtype=J.dtype, device=J.device)
    hb = h[:, None, None]
    a, b = _MU_C_RE / hb, _MU_C_IM / hb
    top = torch.cat([a * I_n - J, -b * I_n.expand_as(J)], dim=-1)
    bot = torch.cat([b * I_n.expand_as(J), a * I_n - J], dim=-1)
    return _MU_REAL / hb * I_n - J, torch.cat([top, bot], dim=-2)


def _fact32(fact):
    if isinstance(fact, tuple):
        return tuple(a.to(torch.float32) if a.is_floating_point() else a
                     for a in fact)
    return fact.to(torch.float32)


def radau_solve(
    f: Callable,
    t_span,
    y0: torch.Tensor,
    t_eval: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    sens_rhs: Optional[Callable] = None,
    s0: Optional[torch.Tensor] = None,
    jac: Optional[Callable] = None,
) -> IntegrateResult:
    """Integrate ``dy/dt = f(t, y)`` forward; same interface as
    ``bdf_solve``."""
    dtype, dev = y0.dtype, y0.device
    B, n = y0.shape
    t0, t_bound, t_eval = common.prepare_times(t_span, y0, t_eval)
    T = t_eval.shape[1]
    kw = dict(dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    faug = common.augmented_rhs(f, sens_rhs)
    Y0, m = common.initial_block(y0, s0, sens_rhs)
    k = 1 + m

    if jac is None:
        def jac(t, y):
            return common.batched_jacobian(lambda yy: f(t, yy), y)

    factor_fn, solve_fn = make_linear_solver(config.linear_solver,
                                             config.jac_bandwidth)
    eps = torch.finfo(dtype).eps
    newton_tol = max(10 * eps / config.rtol, min(0.03, config.rtol ** 0.5))
    rtol, atol = config.rtol, config.atol
    max_step = torch.tensor(float(config.max_step), **kw)
    C3 = [float(c) for c in _C]
    E3 = [float(e) for e in _E]
    Tm, TIm, Pm = (torch.as_tensor(a, **kw) for a in (_T, _TI, _P))
    mu_r, mu_re, mu_im = _MU_REAL, _MU_C_RE, _MU_C_IM
    one = torch.ones((), **kw)
    f32 = torch.float32

    # split-precision sensitivities: the columns evaluate and solve in
    # f32; the state column and the error control stay f64
    split_sens = (config.sens_precision == "f32" and m > 0
                  and dtype == torch.float64)
    if split_sens:
        def faug_split(t, Y):
            y = Y[..., 0]
            fs = sens_rhs(t.to(f32), y.to(f32), Y[..., 1:].to(f32))
            return torch.cat([f(t, y)[..., None], fs.to(dtype)], dim=-1)
    else:
        faug_split = faug

    def factor_pair(h, J):
        real, embedded = newton_matrices(J, h)
        return factor_fn(real), factor_fn(embedded)

    def solve_complex(fc, re, im):
        out = solve_fn(fc, torch.cat([re, im], dim=1))
        return out[:, :n], out[:, n:]

    F0 = faug(t0, Y0)
    if config.first_step is None:
        h0 = common.select_initial_step(
            f, t0, y0, F0[..., 0], t_bound, config.max_step, rtol, atol,
            order=4)
    else:
        h0 = torch.full((B,), float(config.first_step), **kw)
    h0 = torch.minimum(h0, torch.abs(t_bound - t0))

    at_t0 = (t_eval == t0[:, None])[:, :, None, None]
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    ones = torch.ones(B, **kw)
    st = dict(
        t=t0, y=Y0, f=F0, h_abs=h0, h_abs_old=ones, error_norm_old=ones,
        have_old=false, J=jac(t0, y0), fr=None, fc=None, lu_valid=false,
        current_jac=~false, rejected=false,
        Q_prev=torch.zeros((B, 3, n, k), **kw), y_prev=Y0, t_prev=t0,
        h_prev=ones, have_sol=false,
        status=common.status_init(t0, t_bound),
        ys_acc=torch.where(at_t0, Y0[:, None],
                           torch.zeros((B, T, n, k), **kw)),
        nsteps=torch.zeros(B, **i32), naccepted=torch.zeros(B, **i32),
        nrejected=torch.zeros(B, **i32),
        nfev=torch.full((B,), 1 + (0 if config.first_step is not None
                                   else 2), **i32),
        njev=torch.ones(B, **i32), nlu=torch.zeros(B, **i32))

    def body(st):
        t, Y = st["t"], st["y"]
        running = st["status"] == STATUS_RUNNING
        min_step = 10 * eps * torch.abs(t)
        too_small = (st["h_abs"] < min_step) & st["rejected"]
        # a clamp at the top of the step drops the two-step history
        h_clamped = torch.minimum(torch.maximum(st["h_abs"], min_step),
                                  max_step)
        have_old = st["have_old"] & (h_clamped == st["h_abs"])
        t_new = torch.minimum(t + h_clamped, t_bound)
        h = t_new - t
        h_abs = h
        hb = h[:, None, None]

        # warm start from the previous step's interpolant
        x = ((t[:, None] + h[:, None] * torch.as_tensor(C3, **kw))
             - st["t_prev"][:, None]) / st["h_prev"][:, None]   # (B, 3)
        px = torch.stack([x, x * x, x * x * x], dim=2)            # (B, 3, 3)
        prev = st["y_prev"][:, None] + torch.einsum(
            "bsp,bpnk->bsnk", px, st["Q_prev"])
        Z0 = torch.where(bcast(st["have_sol"], prev), prev - Y[:, None],
                         torch.zeros_like(prev))
        scale = atol + torch.abs(Y[..., 0]) * rtol

        lu_valid = st["lu_valid"]
        fr, fc = st["fr"], st["fc"]
        if bool((running & ~lu_valid).any()):
            fr_new, fc_new = factor_pair(h, st["J"])
            fr = where_members(lu_valid, fr, fr_new)
            fc = where_members(lu_valid, fc, fc_new)
        nlu = st["nlu"] + torch.where(lu_valid, 0, 2).to(torch.int32)
        if split_sens:
            fr32, fc32 = _fact32(fr), _fact32(fc)

        # --- collocation Newton: fixed trips, per-member masks ---
        Z = Z0
        W = torch.stack([_mix(TIm[i], Z) for i in range(3)], dim=1)
        dW_norm_old = torch.zeros(B, **kw)
        rate = torch.zeros(B, **kw)
        n_iter = torch.zeros(B, **i32)
        converged = false
        failed = ~running
        for it in range(NEWTON_MAXITER):
            active = ~(converged | failed)
            if not bool(active.any()):
                break
            F = torch.stack([faug_split(t + C3[i] * h, Y + Z[:, i])
                             for i in range(3)], dim=1)
            nonfinite = ~common.finite_members(F)
            f_real = _mix(TIm[0], F) - (mu_r / hb) * W[:, 0]
            f_cre = (_mix(TIm[1], F) - (mu_re / hb) * W[:, 1]
                     + (mu_im / hb) * W[:, 2])
            f_cim = (_mix(TIm[2], F) - (mu_im / hb) * W[:, 1]
                     - (mu_re / hb) * W[:, 2])
            if split_sens:
                dW0 = torch.cat([
                    solve_fn(fr, f_real[..., :1].contiguous()),
                    solve_fn(fr32, f_real[..., 1:].to(f32)).to(dtype)],
                    dim=-1)
                d1s, d2s = solve_complex(fc, f_cre[..., :1],
                                         f_cim[..., :1])
                out32 = solve_fn(fc32, torch.cat(
                    [f_cre[..., 1:], f_cim[..., 1:]], dim=1).to(f32)
                ).to(dtype)
                dW1 = torch.cat([d1s, out32[:, :n]], dim=-1)
                dW2 = torch.cat([d2s, out32[:, n:]], dim=-1)
            else:
                dW0 = solve_fn(fr, f_real)
                dW1, dW2 = solve_complex(fc, f_cre, f_cim)
            dW = torch.stack([dW0, dW1, dW2], dim=1)
            dW_norm = rms_norm(dW[..., 0] / scale[:, None])
            rate_new = dW_norm / torch.where(dW_norm_old > 0, dW_norm_old,
                                             one)
            have_rate = it > 0
            diverged = have_rate & (
                (rate_new >= 1.0)
                | (rate_new ** (NEWTON_MAXITER - it) / (1.0 - rate_new)
                   * dW_norm > newton_tol))
            ok = active & ~nonfinite & ~diverged
            W = torch.where(bcast(ok, W), W + dW, W)
            Z = torch.where(bcast(ok, Z),
                            torch.stack([_mix(Tm[i], W) for i in range(3)],
                                        dim=1), Z)
            conv_now = ok & ((dW_norm == 0.0)
                             | (have_rate & (rate_new / (1.0 - rate_new)
                                             * dW_norm < newton_tol)))
            converged = converged | conv_now
            failed = failed | (active & (nonfinite | diverged))
            n_iter = n_iter + active.to(torch.int32)
            if have_rate:
                rate = torch.where(active, rate_new, rate)
            dW_norm_old = torch.where(ok, dW_norm, dW_norm_old)
        nfev = st["nfev"] + 3 * n_iter

        # Newton failure: refresh J at the same h, or halve h
        case_B = ~converged & ~st["current_jac"]
        case_C = ~converged & st["current_jac"]
        J = st["J"]
        if bool((case_B & running).any()):
            J = where_members(case_B, jac(t, Y[..., 0]), J)
        njev = st["njev"] + case_B.to(torch.int32)

        # --- error estimate ---
        y_new = Y + Z[:, 2]
        ZE = _mix(E3, Z) / hb
        err = solve_fn(fr, st["f"] + ZE)
        scale_new = atol + torch.maximum(torch.abs(Y[..., 0]),
                                         torch.abs(y_new[..., 0])) * rtol
        error_norm = rms_norm(err[..., 0] / scale_new)
        safety = (0.9 * (2 * NEWTON_MAXITER + 1)
                  / (2 * NEWTON_MAXITER + n_iter.to(dtype)))

        # the rejected-step stabilized re-estimate
        redo = st["rejected"] & (error_norm > 1.0) & converged
        if bool((redo & running).any()):
            err2 = solve_fn(fr, faug(t, Y + err) + ZE)
            error_norm = torch.where(redo, rms_norm(err2[..., 0]
                                                    / scale_new), error_norm)
        nfev = nfev + redo.to(torch.int32)

        bad_err = ~torch.isfinite(error_norm)
        error_norm = torch.where(bad_err, 2.0 * one, error_norm)
        reject = converged & ((error_norm > 1.0) | bad_err)
        accept = converged & ~reject

        # --- Hairer predictive controller ---
        e_pos = error_norm > 0
        ratio = torch.where(
            e_pos, (st["error_norm_old"]
                    / torch.clamp(error_norm, min=eps)) ** 0.25, one)
        mult = torch.where(st["have_old"] & e_pos,
                           h_abs / st["h_abs_old"] * ratio, one)
        predict = (torch.clamp(mult, max=1.0)
                   * torch.clamp(error_norm, min=eps) ** -0.25)
        factor_rej = torch.clamp(safety * predict, min=MIN_FACTOR)
        recompute_jac = (n_iter > 2) & (rate > 1e-3)
        factor_acc = torch.clamp(safety * predict, max=MAX_FACTOR)
        keep_h = ~recompute_jac & (factor_acc < 1.2)
        factor_acc = torch.where(keep_h, one, factor_acc)
        h_factor = torch.where(
            case_C, 0.5 * one,
            torch.where(reject, factor_rej,
                        torch.where(accept, factor_acc, one)))
        h_new = h_abs * h_factor

        f_new = st["f"]
        if bool((accept & running).any()):
            f_new = where_members(accept, faug(t_new, y_new), f_new)
        nfev = nfev + accept.to(torch.int32)
        new_jac = accept & recompute_jac
        if bool((new_jac & running).any()):
            J = where_members(new_jac, jac(t_new, y_new[..., 0]), J)
        njev = njev + new_jac.to(torch.int32)
        current_jac = torch.where(
            case_B, True, torch.where(accept, recompute_jac,
                                      st["current_jac"]))
        # the factorization stays valid only on an accepted step that kept
        # h and J
        lu_valid_new = accept & keep_h & ~recompute_jac

        # --- dense output (the cubic interpolant) ---
        Q = torch.einsum("bink,ip->bpnk", Z, Pm)

        def interp(tv):
            xx = (tv - t[:, None]) / h[:, None]
            pw = torch.stack([xx, xx * xx, xx * xx * xx], dim=2)
            return Y[:, None] + torch.einsum("btp,bpnk->btnk", pw, Q)

        inf = torch.full_like(t, float("inf"))
        ys_acc = common.interp_accumulate(
            t_eval, torch.where(accept, t, inf), t_new, interp,
            st["ys_acc"])

        nsteps = st["nsteps"] + 1
        done, status = common.step_status(accept, t_new, t_bound, nsteps,
                                          config.max_steps)
        acc_b = bcast(accept, Y)
        new_st = dict(
            t=torch.where(accept, t_new, t),
            y=torch.where(acc_b, y_new, Y), f=f_new, h_abs=h_new,
            h_abs_old=torch.where(accept, h_abs, st["h_abs_old"]),
            error_norm_old=torch.where(accept, error_norm,
                                       st["error_norm_old"]),
            have_old=accept | have_old, J=J, fr=fr, fc=fc,
            lu_valid=lu_valid_new, current_jac=current_jac,
            rejected=torch.where(accept, False,
                                 st["rejected"] | reject | case_C),
            Q_prev=torch.where(bcast(accept, Q), Q, st["Q_prev"]),
            y_prev=torch.where(acc_b, Y, st["y_prev"]),
            t_prev=torch.where(accept, t, st["t_prev"]),
            h_prev=torch.where(accept, h, st["h_prev"]),
            have_sol=st["have_sol"] | accept,
            status=status, ys_acc=ys_acc, nsteps=nsteps,
            naccepted=st["naccepted"] + accept.to(torch.int32),
            nrejected=st["nrejected"] + (reject | case_C).to(torch.int32),
            nfev=nfev, njev=njev, nlu=nlu)

        return common.settle(dict(st, fr=fr, fc=fc), new_st, too_small,
                             running)

    while bool((st["status"] == STATUS_RUNNING).any()):
        st = body(st)

    return IntegrateResult(
        ys=st["ys_acc"][..., 0], sens=st["ys_acc"][..., 1:],
        status=st["status"], nsteps=st["nsteps"],
        naccepted=st["naccepted"], nrejected=st["nrejected"],
        nfev=st["nfev"], njev=st["njev"], nlu=st["nlu"],
        order_hist=torch.zeros((B, 6), **i32),
        t_final=st["t"], y_final=st["y"])
