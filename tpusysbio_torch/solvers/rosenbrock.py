"""Linearly-implicit Rosenbrock 2(3) stepper (Shampine–Reichelt ode23s)
over a batch of members.

Port of ``tpusysbio/solvers/rosenbrock.py``: the modified Rosenbrock pair
of the MATLAB ``ode23s`` method, d = 1/(2+sqrt(2)), with its quadratic
interpolant. Every step attempt costs one Jacobian, one factorization of
``W = I - h·d·J`` through ``make_linear_solver`` and three solves, for
every running member; there is no Newton iteration. The sensitivity
columns ride the same solves with the state block's ``W`` (a W-method).

The time partial of the augmented RHS is ``torch.func.jvp`` in ``t`` over
the batched (B,) time with a tangent of ones; a time-independent model
gets a zero column from the same call. Like the reference, the stepper
ignores ``mixed_precision`` and ``sens_precision``.

Each solve takes the state column on its own and the sensitivity columns
together: under ``linear_solver='pallas'`` in f64 the state column is the
single-column solve of the fused refined-solve kernel (K2) and the other
columns take the plain refinement rounds, as the reference's own
single-column path and multi-column path do.

Batching follows ``solvers/bdf.py``: the step loop runs until no member is
running, and a member that is not running keeps its whole state.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.linalg import make_linear_solver
from tpusysbio_torch.solvers import common
from tpusysbio_torch.solvers.common import (
    STATUS_RUNNING,
    IntegrateResult,
    bcast,
    rms_norm,
)

_D = 1.0 / (2.0 + math.sqrt(2.0))
_E32 = 6.0 + math.sqrt(2.0)


def rosenbrock_solve(
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
    ``bdf_solve`` (batched ``f``, per-member ``t_span`` ends and
    ``t_eval``)."""
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

    def dfdt(t, Y):
        # time partial of the augmented RHS, one jvp over the batch
        return torch.func.jvp(lambda tt: faug(tt, Y), (t,),
                              (torch.ones_like(t),))[1]

    factor_fn, solve_fn = make_linear_solver(config.linear_solver,
                                             config.jac_bandwidth)

    def solve(fact, b):
        if m == 0:
            return solve_fn(fact, b)
        return torch.cat([solve_fn(fact, b[..., :1].contiguous()),
                          solve_fn(fact, b[..., 1:].contiguous())], dim=-1)

    rtol, atol = config.rtol, config.atol
    max_step = torch.tensor(float(config.max_step), **kw)
    eps = torch.finfo(dtype).eps
    I_n = torch.eye(n, **kw)
    d = _D
    one_m_2d = 1.0 - 2.0 * d

    F0 = faug(t0, Y0)
    if config.first_step is None:
        h0 = common.select_initial_step(
            f, t0, y0, F0[..., 0], t_bound, config.max_step, rtol, atol,
            order=2)
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
        njev=torch.zeros(B, **i32), nlu=torch.zeros(B, **i32))

    def body(st):
        t, Y = st["t"], st["y"]
        running = st["status"] == STATUS_RUNNING
        min_step = 10 * eps * torch.abs(t)
        too_small = st["h_abs"] < min_step
        h_abs = torch.minimum(torch.maximum(st["h_abs"], min_step), max_step)
        t_new = torch.minimum(t + h_abs, t_bound)
        h = t_new - t
        hb = h[:, None, None]

        J = jac(t, Y[..., 0])
        W_fact = factor_fn(I_n - (hb * d) * J)
        Tt = dfdt(t, Y)

        F0v = st["f"]
        hdT = (hb * d) * Tt
        k1 = solve(W_fact, F0v + hdT)
        F1 = faug(t + 0.5 * h, Y + (0.5 * hb) * k1)
        k2 = solve(W_fact, F1 - k1) + k1
        Y_new = Y + hb * k2
        F2 = faug(t_new, Y_new)
        k3 = solve(W_fact,
                   F2 - _E32 * (k2 - F1) - 2.0 * (k1 - F0v) + hdT)
        err = (hb / 6.0) * (k1 - 2.0 * k2 + k3)

        scale = atol + rtol * torch.maximum(torch.abs(Y[..., 0]),
                                            torch.abs(Y_new[..., 0]))
        if config.sens_error_control and m:
            scale_full = atol + rtol * torch.maximum(torch.abs(Y),
                                                     torch.abs(Y_new))
            error_norm = rms_norm(err / scale_full)
        else:
            error_norm = rms_norm(err[..., 0] / scale)

        finite = common.finite_members(Y_new, err)
        accept = finite & (error_norm < 1.0)
        expo = -1.0 / 3.0   # the 3rd-order error companion
        safe = torch.where(error_norm > 0, error_norm,
                           torch.ones_like(error_norm))
        factor_acc = torch.where(
            error_norm == 0.0, torch.full_like(error_norm, config.max_factor),
            torch.clamp(config.safety * safe ** expo, max=config.max_factor))
        factor_acc = torch.where(st["step_rejected"],
                                 torch.clamp(factor_acc, max=1.0), factor_acc)
        factor_rej = torch.where(
            finite,
            torch.clamp(config.safety * error_norm ** expo,
                        min=config.min_factor),
            torch.full_like(error_norm, 0.5))
        h_new = h_abs * torch.where(accept, factor_acc, factor_rej)

        def interp(tv):
            # ntrp23s quadratic interpolant at tv (B, T)
            s = ((tv - t[:, None]) / h[:, None])[..., None, None]
            w1 = s * (1.0 - s) / one_m_2d
            w2 = s * (s - 2.0 * d) / one_m_2d
            return Y[:, None] + hb[:, None] * (w1 * k1[:, None]
                                               + w2 * k2[:, None])

        inf = torch.full_like(t, float("inf"))
        ys_acc = common.interp_accumulate(
            t_eval, torch.where(accept, t, inf), t_new, interp,
            st["ys_acc"])

        nsteps = st["nsteps"] + 1
        done, status = common.step_status(accept, t_new, t_bound, nsteps,
                                          config.max_steps)
        acc32 = accept.to(torch.int32)
        new_st = dict(
            t=torch.where(accept, t_new, t),
            y=torch.where(bcast(accept, Y), Y_new, Y),
            f=torch.where(bcast(accept, Y), F2, st["f"]),
            h_abs=h_new, step_rejected=~accept, status=status,
            ys_acc=ys_acc, nsteps=nsteps,
            naccepted=st["naccepted"] + acc32,
            nrejected=st["nrejected"] + (1 - acc32),
            nfev=st["nfev"] + 2, njev=st["njev"] + 1, nlu=st["nlu"] + 1)

        return common.settle(st, new_st, too_small, running)

    while bool((st["status"] == STATUS_RUNNING).any()):
        st = body(st)

    return IntegrateResult(
        ys=st["ys_acc"][..., 0], sens=st["ys_acc"][..., 1:],
        status=st["status"], nsteps=st["nsteps"],
        naccepted=st["naccepted"], nrejected=st["nrejected"],
        nfev=st["nfev"], njev=st["njev"], nlu=st["nlu"],
        order_hist=torch.zeros((B, 6), **i32),
        t_final=st["t"], y_final=st["y"])
