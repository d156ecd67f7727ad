"""Bounded least squares: Coleman–Li scaled trust region (TRF-style), over
a batch of starts.

Port of ``tpusysbio/optim/trf.py``. The Coleman–Li scaling vector ``v``
(``scipy/optimize/_lsq/common.py:CL_scaling_vector``) turns the
bound-constrained problem into an unconstrained one in scaled variables,
with first-order optimality measured by ``‖v·g‖∞``. The subproblem is the
λ-damped scaled normal equations solved with the in-house LU
(``linalg/lu.py``; ``subproblem='normal'``), or the spectral step of an f32
SVD of the augmented Jacobian refined twice in f64 (``'svd'``). Steps are
projected per coordinate onto the strict interior of the box.

Batching follows ``optim/lm.py``: every field of ``TRFState`` leads with
N; ``residual_fn`` maps θ (N, G) to (N, R) and ``residual_and_jac_fn`` to
((N, R), (N, R, G)); the loop runs while any member is live and a member
that is not live keeps its whole state. The reference's fresh Jacobian on
acceptance (a ``lax.cond``, a select under ``vmap``) is one evaluation of
the batch when any live member accepts, merged per member. Counters per
member as in the reference: nfev +1 every iteration, njev +1 on
acceptance.

Known corner, kept as the reference documents it (``trf_fit``): when
every residual starts in the Huber tail, the robust curvature is the
``eps`` floor on every row and the λ-damped subproblem stalls at the
start.

Statuses: 0 = max_iter, 1 = gtol, 2 = ftol, 3 = xtol (or a rejected step
at λ_max), -1 = non-finite at the initial point (masked member).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpusysbio_torch.config import FitConfig
from tpusysbio_torch.linalg import lu as _lu
from tpusysbio_torch.optim.lm import (FitResult, LMState, _finite_rows,
                                      _frozen, _grad, _traced, lm_finish)
from tpusysbio_torch.optim.loss import make_loss


class TRFState(NamedTuple):
    """Resumable TRF state: advance it in bounded chunks with ``trf_run``."""

    x: torch.Tensor           # (N, G)
    r: torch.Tensor           # (N, R), robust-scaled
    J: torch.Tensor           # (N, R, G), robust-scaled
    cost: torch.Tensor        # (N,) robust cost
    lam: torch.Tensor
    nu: torch.Tensor
    status: torch.Tensor      # (N,) int32
    done: torch.Tensor        # (N,) bool
    n_iter: torch.Tensor      # (N,) int32
    nfev: torch.Tensor
    njev: torch.Tensor
    grad_norm: torch.Tensor   # ‖v·g‖∞
    cost_trace: torch.Tensor  # (N, max_iter) accepted-cost history


def _box(lower, upper, like: torch.Tensor):
    return (torch.as_tensor(lower, dtype=like.dtype, device=like.device),
            torch.as_tensor(upper, dtype=like.dtype, device=like.device))


def _cl_scaling(x, g, lb, ub):
    """Coleman–Li v and dv/dx (scipy/optimize/_lsq/common.py)."""
    one = torch.ones_like(x)
    neg = (g < 0) & torch.isfinite(ub)
    pos = (g > 0) & torch.isfinite(lb)
    v = torch.where(pos, x - lb, torch.where(neg, ub - x, one))
    dv = torch.where(pos, one, torch.where(neg, -one, torch.zeros_like(x)))
    return v, dv


def _interior_fn(lb, ub):
    """Projection onto the strict interior; ±inf bounds leave x free."""
    span = torch.where(torch.isfinite(ub - lb), ub - lb,
                       torch.ones_like(lb))
    pad = 1e-10 * torch.clamp(torch.abs(span), min=1.0)
    lo_ok, hi_ok = torch.isfinite(lb), torch.isfinite(ub)

    def interior(x):
        x = torch.where(lo_ok, torch.maximum(x, lb + pad), x)
        return torch.where(hi_ok, torch.minimum(x, ub - pad), x)

    return interior


def _eval_fns(residual_fn, residual_and_jac_fn, loss, f_scale):
    cost_fn, scale_fn = make_loss(loss, f_scale)

    def cost_of(r):
        return 0.5 * torch.sum(r * r, dim=1) if cost_fn is None \
            else cost_fn(r)

    def eval_rj(x):
        r, J = residual_and_jac_fn(x)
        bad = ~(_finite_rows(r) & _finite_rows(J))
        c = cost_of(r)
        if scale_fn is not None:
            r, J = scale_fn(r, J)
        return r, J, c, bad

    def eval_r(x):
        r = residual_fn(x)
        return cost_of(r), _finite_rows(r)

    return eval_rj, eval_r


def trf_init(residual_and_jac_fn: Callable, theta0: torch.Tensor, lower,
             upper, config: FitConfig = FitConfig(), loss: str = "linear",
             f_scale: float = 1.0) -> TRFState:
    """Evaluate the starts ``theta0`` (N, G), nudged into the strict
    interior of ``[lower, upper]``, into a resumable TRF state."""
    dtype, dev = theta0.dtype, theta0.device
    N = theta0.shape[0]
    lb, ub = _box(lower, upper, theta0)
    eval_rj, _ = _eval_fns(None, residual_and_jac_fn, loss, f_scale)
    x0 = _interior_fn(lb, ub)(theta0)
    r0, J0, cost0, bad0 = eval_rj(x0)
    g0 = _grad(J0, r0)
    v0, _ = _cl_scaling(x0, g0, lb, ub)
    i32 = dict(dtype=torch.int32, device=dev)
    return TRFState(
        x=x0, r=r0, J=J0, cost=cost0,
        lam=torch.full((N,), config.lam0, dtype=dtype, device=dev),
        nu=torch.full((N,), 2.0, dtype=dtype, device=dev),
        status=torch.where(bad0, -1, 0).to(torch.int32), done=bad0,
        n_iter=torch.zeros(N, **i32), nfev=torch.zeros(N, **i32),
        njev=torch.ones(N, **i32),
        grad_norm=torch.amax(torch.abs(v0 * g0), dim=1),
        cost_trace=cost0[:, None].expand(N, config.max_iter).clone())


def trf_finish(state: TRFState) -> FitResult:
    """A ``FitResult`` with the covariance channel (JᵀJ)⁻¹ at the final
    iterate, as ``lm_finish`` builds it; for a robust loss J is the
    robust-rescaled Jacobian, the curvature of the robust objective."""
    return lm_finish(LMState(*state))   # the same fields, x as theta


def trf_fit(residual_fn: Callable, residual_and_jac_fn: Callable,
            theta0: torch.Tensor, lower, upper,
            config: FitConfig = FitConfig(), subproblem: str = "normal",
            loss: str = "linear", f_scale: float = 1.0) -> FitResult:
    """Minimize ``0.5 ||r(θ)||²`` (or the robust cost of ``loss`` /
    ``f_scale``, as ``scipy.optimize.least_squares``) subject to
    ``lower < θ < upper`` from every row of ``theta0`` (N, G).

    ``subproblem``: ``'normal'`` (λ-damped scaled normal equations with
    Marquardt diagonal scaling, the in-house LU) or ``'svd'`` (f32 SVD of
    ``[J·diag(d); diag(√(g·dv))]``, the λI-damped spectral step, two f64
    refinement rounds against the f64 normal matrix). The reported
    ``cost`` is the robust cost.
    """
    state = trf_init(residual_and_jac_fn, theta0, lower, upper, config,
                     loss=loss, f_scale=f_scale)
    state = trf_run(residual_fn, residual_and_jac_fn, state, lower, upper,
                    config, subproblem=subproblem, loss=loss,
                    f_scale=f_scale)
    return trf_finish(state)


def trf_run(residual_fn: Callable, residual_and_jac_fn: Callable,
            state: TRFState, lower, upper, config: FitConfig = FitConfig(),
            iter_cap: Optional[int] = None, subproblem: str = "normal",
            loss: str = "linear", f_scale: float = 1.0) -> TRFState:
    """Advance every member until it is done or its ``n_iter`` reaches
    ``iter_cap``."""
    if subproblem not in ("normal", "svd"):
        raise ValueError(f"unknown subproblem {subproblem!r}; "
                         "expected 'normal' or 'svd'")
    dtype = state.x.dtype
    eps = torch.finfo(dtype).eps
    lb, ub = _box(lower, upper, state.x)
    cap = config.max_iter if iter_cap is None else int(iter_cap)
    interior = _interior_fn(lb, ub)
    eval_rj, eval_r = _eval_fns(residual_fn, residual_and_jac_fn, loss,
                                f_scale)

    def step_normal(B, diagB, gh, lam):
        M = B + lam[:, None, None] * torch.diag_embed(diagB)
        return _lu.lu_solve(_lu.lu_factor(M), -gh), diagB

    def step_svd(B, diagB, gh, lam, Jh, diag_h):
        # B = J_augᵀJ_aug with J_aug = [Jh; diag(√diag_h)]; the f32 SVD
        # gives V, Σ and p_h = −V (Σ²+λ)⁻¹ Vᵀ g_h, refined in f64
        J_aug = torch.cat([Jh, torch.diag_embed(torch.sqrt(diag_h))], dim=1)
        # a member whose Jacobian is not finite gets a NaN step, as the
        # reference's SVD gives it; the factorization never sees it
        ok = _finite_rows(J_aug)
        J_aug = torch.where(ok[:, None, None], J_aug, 0.0)
        _, s, Vh = torch.linalg.svd(J_aug.to(torch.float32),
                                    full_matrices=False)
        s, Vh = s.to(dtype), Vh.to(dtype)
        inv_spec = 1.0 / (s * s + lam[:, None])

        def spec_solve(rhs):
            return (Vh.transpose(1, 2)
                    @ (inv_spec * (Vh @ rhs[:, :, None])[:, :, 0])[:, :, None]
                    )[:, :, 0]

        ph = spec_solve(-gh)
        M = B + lam[:, None, None] * torch.eye(
            B.shape[-1], dtype=dtype, device=B.device)
        for _ in range(2):  # iterative refinement to f64 accuracy
            ph = ph + spec_solve(-gh - (M @ ph[:, :, None])[:, :, 0])
        ph = torch.where(ok[:, None], ph, float("nan"))
        return ph, torch.ones_like(diagB)

    def body(st: TRFState, live) -> TRFState:
        g = _grad(st.J, st.r)
        v, dv = _cl_scaling(st.x, g, lb, ub)
        d = torch.sqrt(v)
        # scaled problem: J_h = J diag(d); B = J_hᵀ J_h + diag(g·dv)
        Jh = st.J * d[:, None, :]
        gh = d * g
        diag_h = torch.clamp(g * dv, min=0.0)
        B = Jh.transpose(1, 2) @ Jh + torch.diag_embed(diag_h)
        diagB = torch.clamp(torch.diagonal(B, dim1=1, dim2=2), min=1e-12)
        if subproblem == "svd":
            ph, damp_diag = step_svd(B, diagB, gh, st.lam, Jh, diag_h)
        else:
            ph, damp_diag = step_normal(B, diagB, gh, st.lam)
        p = d * ph

        # projected onto the strict interior per coordinate: the free
        # coordinates keep moving when one presses its bound
        x_t = interior(st.x + p)
        step = x_t - st.x
        cost_t, finite_t = eval_r(x_t)

        pred = 0.5 * torch.sum(
            ph * (st.lam[:, None] * damp_diag * ph - gh), dim=1)
        pred = torch.clamp(pred, min=eps)
        rho = (st.cost - cost_t) / pred
        accept = finite_t & (cost_t < st.cost)

        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_new = torch.where(
            accept,
            torch.clamp(st.lam * shrink, config.lam_min, config.lam_max),
            torch.clamp(st.lam * st.nu, config.lam_min, config.lam_max))
        nu_new = torch.where(accept, 2.0, st.nu * 2.0)

        # fresh (scaled) r and J only on acceptance: evaluated for the
        # batch when any live member accepts, merged per member
        if bool((accept & live).any()):
            r_f, J_f, _, _ = eval_rj(x_t)
            r_new = torch.where(accept[:, None], r_f, st.r)
            J_new = torch.where(accept[:, None, None], J_f, st.J)
        else:
            r_new, J_new = st.r, st.J
        x_new = torch.where(accept[:, None], x_t, st.x)
        cost_new = torch.where(accept, cost_t, st.cost)

        g_new = _grad(J_new, r_new)
        v_new, _ = _cl_scaling(x_new, g_new, lb, ub)
        g_norm = torch.amax(torch.abs(v_new * g_new), dim=1)

        dcost = st.cost - cost_t
        ftol_hit = accept & (dcost < config.ftol * st.cost)
        xtol_hit = accept & (
            torch.linalg.vector_norm(step, dim=1)
            < config.xtol * (config.xtol
                             + torch.linalg.vector_norm(st.x, dim=1)))
        gtol_hit = g_norm < config.gtol
        stuck = ~accept & (st.lam >= config.lam_max)
        status = torch.where(
            gtol_hit, 1,
            torch.where(ftol_hit, 2, torch.where(xtol_hit | stuck, 3, 0))
        ).to(torch.int32)

        new = TRFState(
            x=x_new, r=r_new, J=J_new, cost=cost_new, lam=lam_new,
            nu=nu_new, status=status, done=status > 0,
            n_iter=st.n_iter + 1, nfev=st.nfev + 1,
            njev=st.njev + accept.to(torch.int32), grad_norm=g_norm,
            cost_trace=_traced(st.cost_trace, st.n_iter, cost_new))
        # members that are not live keep their whole state
        return _frozen(new, st, live)

    while True:
        live = ~state.done & (state.n_iter < cap)
        if not bool(live.any()):
            return state
        state = body(state, live)
