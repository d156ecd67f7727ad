"""Explicit Dormand–Prince RK45 for non-stiff problems over a batch of
members.

Port of ``tpusysbio/solvers/dopri5.py`` (SciPy's ``_ivp/rk.py`` RK45:
tableau, step control, quartic interpolant). The sensitivity columns ride
the same stages; there is no factorization. ``stiff_exit=True`` ends a
member with ``STATUS_STIFF`` once its step-size projection has said, on
five consecutive steps, that the rest of its interval cannot finish
within the step budget (``auto_solve``'s stiffness detector); its
``t_final``/``y_final`` are where it stopped.

Batching follows ``solvers/bdf.py``: the step loop runs until no member is
running, and a member that is not running keeps its whole state.
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

# Dormand-Prince 5(4) tableau (SciPy's RK45)
_C = np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1], dtype=np.float64)
_A = np.array([
    [0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
], dtype=np.float64)
_B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
              dtype=np.float64)
_E = np.array([71 / 57600, 0, -71 / 16695, 71 / 1920, -17253 / 339200,
               22 / 525, -1 / 40], dtype=np.float64)
_P = np.array([
    [1, -8048581381 / 2820520608, 8663915743 / 2820520608,
     -12715105075 / 11282082432],
    [0, 0, 0, 0],
    [0, 131558114200 / 32700410799, -68118460800 / 10900136933,
     87487479700 / 32700410799],
    [0, -1754552775 / 470086768, 14199869525 / 1410260304,
     -10690763975 / 1880347072],
    [0, 127303824393 / 49829197408, -318862633887 / 49829197408,
     701980252875 / 199316789632],
    [0, -282668133 / 205662961, 2019193451 / 616988883,
     -1453857185 / 822651844],
    [0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423],
], dtype=np.float64)

_ERROR_EXPONENT = -1.0 / 5.0   # error estimator order 4
# consecutive stability-limited steps that declare a member stiff
STIFF_STEPS = 5


def _stage_sum(w, K):
    """``Σ_j w[j] K[j]`` over a list of (B, n, k) stages, in order."""
    out = w[0] * K[0]
    for j in range(1, len(K)):
        out = out + w[j] * K[j]
    return out


def dopri5_solve(
    f: Callable,
    t_span,
    y0: torch.Tensor,
    t_eval: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    sens_rhs: Optional[Callable] = None,
    s0: Optional[torch.Tensor] = None,
    jac: Optional[Callable] = None,   # unused (explicit method)
    stiff_exit: bool = False,
) -> IntegrateResult:
    """Integrate ``dy/dt = f(t, y)`` forward; same interface as
    ``bdf_solve``, plus ``stiff_exit`` (see the module docstring)."""
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

    A = [[float(a) for a in row] for row in _A]
    Bw, C, E = ([float(v) for v in arr] for arr in (_B, _C, _E))
    P = torch.as_tensor(_P, **kw)
    rtol, atol = config.rtol, config.atol
    max_step = torch.tensor(float(config.max_step), **kw)
    eps = torch.finfo(dtype).eps

    F0 = faug(t0, Y0)
    if config.first_step is None:
        h0 = common.select_initial_step(
            f, t0, y0, F0[..., 0], t_bound, config.max_step, rtol, atol,
            order=4)
    else:
        h0 = torch.full((B,), float(config.first_step), **kw)
    h0 = torch.minimum(h0, torch.abs(t_bound - t0))

    at_t0 = (t_eval == t0[:, None])[:, :, None, None]
    st = dict(
        t=t0, y=Y0, f=F0, h_abs=h0,
        step_rejected=torch.zeros(B, dtype=torch.bool, device=dev),
        status=common.status_init(t0, t_bound),
        ys_acc=torch.where(at_t0, Y0[:, None],
                           torch.zeros((B, T, n, k), **kw)),
        nsteps=torch.zeros(B, **i32), naccepted=torch.zeros(B, **i32),
        nrejected=torch.zeros(B, **i32),
        nfev=torch.full((B,), 1 + (0 if config.first_step is not None
                                   else 2), **i32),
        stiff_count=torch.zeros(B, **i32))

    def body(st):
        t, y = st["t"], st["y"]
        running = st["status"] == STATUS_RUNNING
        min_step = 10 * eps * torch.abs(t)
        too_small = st["h_abs"] < min_step
        h_abs = torch.minimum(torch.maximum(st["h_abs"], min_step), max_step)
        t_new = torch.minimum(t + h_abs, t_bound)
        h = t_new - t
        hb = h[:, None, None]

        # 6 stages + the FSAL 7th
        K = [st["f"]]
        for s in range(1, 6):
            dy = hb * _stage_sum(A[s][:s], K)
            K.append(faug(t + C[s] * h, y + dy))
        y_new = y + hb * _stage_sum(Bw, K)
        f_new = faug(t_new, y_new)
        K.append(f_new)

        err = hb * _stage_sum(E, K)
        scale = atol + rtol * torch.maximum(torch.abs(y[..., 0]),
                                            torch.abs(y_new[..., 0]))
        if config.sens_error_control and m:
            scale_full = atol + rtol * torch.maximum(torch.abs(y),
                                                     torch.abs(y_new))
            error_norm = rms_norm(err / scale_full)
        else:
            error_norm = rms_norm(err[..., 0] / scale)

        finite = common.finite_members(y_new, err)
        accept = finite & (error_norm < 1.0)
        safe = torch.where(error_norm > 0, error_norm,
                           torch.ones_like(error_norm))
        factor_acc = torch.where(
            error_norm == 0.0, torch.full_like(error_norm, config.max_factor),
            torch.clamp(config.safety * safe ** _ERROR_EXPONENT,
                        max=config.max_factor))
        factor_acc = torch.where(st["step_rejected"],
                                 torch.clamp(factor_acc, max=1.0), factor_acc)
        factor_rej = torch.where(
            finite,
            torch.clamp(config.safety * error_norm ** _ERROR_EXPONENT,
                        min=config.min_factor),
            torch.full_like(error_norm, 0.5))
        h_new = h_abs * torch.where(accept, factor_acc, factor_rej)

        # quartic dense output
        Q = torch.einsum("bjnk,jq->bqnk", torch.stack(K, dim=1), P)

        def interp(tv):
            x = (tv - t[:, None]) / h[:, None]
            cols = [x]
            for _ in range(3):
                cols.append(cols[-1] * x)
            px = torch.stack(cols, dim=2)
            return y[:, None] + hb[:, None] * torch.einsum(
                "btq,bqnk->btnk", px, Q)

        inf = torch.full_like(t, float("inf"))
        ys_acc = common.interp_accumulate(
            t_eval, torch.where(accept, t, inf), t_new, interp,
            st["ys_acc"])

        nsteps = st["nsteps"] + 1
        done, status = common.step_status(accept, t_new, t_bound, nsteps,
                                          config.max_steps)
        stiff_count = st["stiff_count"]
        if stiff_exit:
            # the pace check: steps still needed at the controlled h
            # against the budget, gated on h no longer growing and
            # required on several consecutive steps
            t_cur = torch.where(accept, t_new, t)
            projected = (t_bound - t_cur) / torch.maximum(h_new, min_step)
            not_growing = h_new <= 1.2 * h_abs
            limited = (~done & not_growing
                       & (projected > (config.max_steps - nsteps).to(dtype)))
            stiff_count = torch.where(limited, stiff_count + 1, 0).to(
                torch.int32)
            status = torch.where(stiff_count >= STIFF_STEPS, STATUS_STIFF,
                                 status).to(torch.int32)

        acc_b = bcast(accept, y)
        acc32 = accept.to(torch.int32)
        new_st = dict(
            t=torch.where(accept, t_new, t),
            y=torch.where(acc_b, y_new, y),
            f=torch.where(acc_b, f_new, st["f"]),
            h_abs=h_new, step_rejected=~accept, status=status,
            ys_acc=ys_acc, nsteps=nsteps,
            naccepted=st["naccepted"] + acc32,
            nrejected=st["nrejected"] + (1 - acc32),
            nfev=st["nfev"] + 6, stiff_count=stiff_count)

        return common.settle(st, new_st, too_small, running)

    while bool((st["status"] == STATUS_RUNNING).any()):
        st = body(st)

    zeros = torch.zeros(B, **i32)
    return IntegrateResult(
        ys=st["ys_acc"][..., 0], sens=st["ys_acc"][..., 1:],
        status=st["status"], nsteps=st["nsteps"],
        naccepted=st["naccepted"], nrejected=st["nrejected"],
        nfev=st["nfev"], njev=zeros, nlu=zeros.clone(),
        order_hist=torch.zeros((B, 6), **i32),
        t_final=st["t"], y_final=st["y"])
