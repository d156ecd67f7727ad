"""Algebraic steady-state solve f(y*, p) = 0 with sensitivities, over a
batch of members.

Port of ``tpusysbio/solvers/steady_state.py``. The equilibrium is found by
a damped Newton iteration on the RHS (the plain pivoted LU of
``linalg/lu.py``), seeded by a short coarse BDF integration (rtol 1e-3,
atol 1e-6, the caller's ``linear_solver``), and the parameter
sensitivities come from the implicit function theorem::

    dy*/dp = −(∂f/∂y)⁻¹ (∂f/∂p)

— one linear solve against the converged Jacobian, ``∂f/∂p`` by
forward-mode AD over p.

Batching: every input leads with the member dimension B. The Newton loop
runs the batch union of trips, at most ``max_newton``; a member that is
done (converged, or no damping step improved its residual) keeps its
iterate and its trip count, as a vmapped ``while_loop`` freezes its lanes.

Conservation laws make pathway Jacobians singular at equilibrium; the
guarded LU then gives a finite pseudo-solve, as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.linalg import lu as _lu
from tpusysbio_torch.solvers.bdf import bdf_solve
from tpusysbio_torch.solvers.common import batched_jacobian, rms_norm

ALPHAS = (1.0, 0.5, 0.25)


class SteadyStateResult(NamedTuple):
    y: torch.Tensor               # (B, n) steady states
    sens: torch.Tensor            # (B, n, m) dy*/dp (zeros if not asked)
    residual_norm: torch.Tensor   # (B,)
    converged: torch.Tensor       # (B,) bool
    n_newton: torch.Tensor        # (B,) int32 Newton trips per member


def steady_state(
    rhs: Callable,                 # f(t, y, p) -> (B, n), t (B,)
    p: torch.Tensor,               # (B, m)
    y0: torch.Tensor,              # (B, n)
    config: SolverConfig = SolverConfig(),
    t_relax: float = 10.0,
    max_newton: int = 25,
    tol: float = 1e-10,
    with_sens: bool = False,
    jac_fn: Optional[Callable] = None,
) -> SteadyStateResult:
    """Find y* with f(y*, p) = 0 near the attractor of each member's y0.

    ``t_relax``: coarse pre-integration horizon that moves y0 into the
    Newton basin. Set 0.0 to skip.
    ``jac_fn``: optional closed-form state Jacobian ``(t, y, p) -> (B, n,
    n)``; forward-mode AD otherwise.
    """
    dtype, dev = y0.dtype, y0.device
    B, n = y0.shape
    t_zero = torch.zeros(B, dtype=dtype, device=dev)

    def f(y):
        return rhs(t_zero, y, p)

    if jac_fn is None:
        def jac(y):
            return batched_jacobian(f, y)
    else:
        def jac(y):
            return jac_fn(t_zero, y, p)

    if t_relax > 0.0:
        coarse = SolverConfig(rtol=1e-3, atol=1e-6,
                              max_steps=config.max_steps,
                              linear_solver=config.linear_solver)
        res = bdf_solve(lambda t, y: rhs(t, y, p), (0.0, t_relax), y0,
                        torch.tensor([t_relax], dtype=dtype, device=dev),
                        config=coarse,
                        jac=(None if jac_fn is None
                             else (lambda t, y: jac_fn(t, y, p))))
        y = res.ys[:, 0]
    else:
        y = y0

    scale = config.atol + torch.abs(y) * config.rtol
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        go = ~done & (it < max_newton)
        if not bool(go.any()):
            break
        fv = f(y)
        step = _lu.lu_solve(_lu.lu_factor(jac(y)), -fv)
        # damped update: the best of three step lengths, taken only if it
        # lowers the residual norm
        tries = [y + a * step for a in ALPHAS]
        norms = torch.stack([rms_norm(f(yt) / scale) for yt in tries], 1)
        best = torch.argmin(norms, dim=1)
        bi = torch.arange(B, device=dev)
        y_new = torch.stack(tries, 1)[bi, best]
        r_new = norms[bi, best]
        r0 = rms_norm(fv / scale)
        improved = torch.isfinite(r_new) & (r_new < r0)
        y = torch.where((go & improved)[:, None], y_new, y)
        done = done | (go & ((r_new < tol) | ~improved))
        it = it + go.to(torch.int32)

    r_fin = rms_norm(f(y) / scale)
    converged = r_fin < tol * 10
    m = p.shape[1]
    if with_sens:
        Fp = batched_jacobian(lambda pp: rhs(t_zero, y, pp),
                              p.contiguous())                # (B, n, m)
        sens = _lu.lu_solve(_lu.lu_factor(jac(y)), -Fp)
    else:
        sens = torch.zeros((B, n, m), dtype=dtype, device=dev)
    return SteadyStateResult(y=y, sens=sens, residual_norm=r_fin,
                             converged=converged, n_newton=it)
