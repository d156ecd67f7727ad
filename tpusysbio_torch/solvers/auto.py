"""Automatic non-stiff/stiff method selection over a batch of members.

Port of ``tpusysbio/solvers/auto.py``, the LSODA role at segment
granularity with a warm handoff:

1. integrate with an explicit method (``'rk45'``, Dormand–Prince, by
   default, or the ``'adams'`` multistep) that ends a member with
   ``STATUS_STIFF`` once its step size says the rest of its interval
   cannot finish within ``nonstiff_budget`` steps;
2. when any member did not finish, run the BDF stepper over the batch,
   each member continuing from its own ``t_final``/``y_final`` (a member
   that finished starts at its end and takes no step), and stitch: rows
   of ``t_eval`` at or before a member's handoff time keep the explicit
   values.

The reference's ``lax.cond(done, keep, fallback)`` under ``vmap`` becomes
a per-member merge: a member that finished explicitly keeps the explicit
result (statuses and counters, ``njev``/``nlu`` 0), every other member
takes the stitched result with summed step counters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.solvers import common
from tpusysbio_torch.solvers.adams import adams_solve
from tpusysbio_torch.solvers.bdf import bdf_solve
from tpusysbio_torch.solvers.common import (
    STATUS_DONE,
    IntegrateResult,
    bcast,
)
from tpusysbio_torch.solvers.dopri5 import dopri5_solve


def auto_solve(
    f: Callable,
    t_span,
    y0: torch.Tensor,
    t_eval,
    config: SolverConfig = SolverConfig(),
    sens_rhs: Optional[Callable] = None,
    s0: Optional[torch.Tensor] = None,
    jac: Optional[Callable] = None,
    nonstiff_budget: Optional[int] = None,
    explicit: str = "rk45",
) -> IntegrateResult:
    """Explicit attempt, then a warm handoff to BDF; same interface as
    ``bdf_solve``.

    ``nonstiff_budget``: the explicit phase's step budget (default
    ``max(config.max_steps // 4, 64)``). ``explicit``: ``'rk45'`` or
    ``'adams'``.
    """
    budget = nonstiff_budget or max(config.max_steps // 4, 64)
    cfg_rk = dataclasses.replace(config, max_steps=budget)
    explicit_solve = {"adams": adams_solve, "rk45": dopri5_solve}[explicit]
    rk = explicit_solve(f, t_span, y0, t_eval, config=cfg_rk,
                        sens_rhs=sens_rhs, s0=s0, stiff_exit=True)
    keep = rk.status == STATUS_DONE
    B = y0.shape[0]
    zeros = torch.zeros(B, dtype=torch.int32, device=y0.device)
    if bool(keep.all()):
        return rk._replace(njev=zeros, nlu=zeros.clone(),
                           order_hist=torch.zeros_like(rk.order_hist))

    m = 0 if s0 is None else s0.shape[-1]
    y_h = rk.y_final[..., 0]
    s_h = rk.y_final[..., 1:] if m else None
    bd = bdf_solve(f, (rk.t_final, t_span[1]), y_h, t_eval, config=config,
                   sens_rhs=sens_rhs, s0=s_h, jac=jac)
    # rows the explicit phase already produced keep its values
    pre = common.prepare_times(t_span, y0, t_eval)[2] <= rk.t_final[:, None]
    ys = torch.where(pre[..., None], rk.ys, bd.ys)
    sens = (torch.where(pre[..., None, None], rk.sens, bd.sens) if m
            else bd.sens)

    def pick(a, b):
        return torch.where(bcast(keep, a), a, b)

    return IntegrateResult(
        ys=pick(rk.ys, ys), sens=pick(rk.sens, sens),
        status=pick(rk.status, bd.status),
        nsteps=pick(rk.nsteps, rk.nsteps + bd.nsteps),
        naccepted=pick(rk.naccepted, rk.naccepted + bd.naccepted),
        nrejected=pick(rk.nrejected, rk.nrejected + bd.nrejected),
        nfev=pick(rk.nfev, rk.nfev + bd.nfev),
        njev=pick(zeros, bd.njev), nlu=pick(zeros, bd.nlu),
        order_hist=pick(torch.zeros_like(bd.order_hist), bd.order_hist),
        t_final=pick(rk.t_final, bd.t_final),
        y_final=pick(rk.y_final, bd.y_final))
