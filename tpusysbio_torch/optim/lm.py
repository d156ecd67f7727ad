"""Levenberg–Marquardt with Marquardt diagonal scaling, over a batch of
starts.

Port of ``tpusysbio/optim/lm.py``: damped normal equations
``(JᵀJ + λ·diag(JᵀJ)) δ = −Jᵀr`` solved with the in-house pivoted LU
(``linalg/lu.py``), the gain-ratio λ update of Nielsen/Madsen, and the
termination tests of ``scipy.optimize.least_squares`` plus MINPACK's
"flat valley" stop.

Batching. The reference fits one θ per call and gets its ensemble from
``jax.vmap`` over a ``lax.while_loop``. Here every field of the state
carries a leading start dimension N, ``residual_fn`` maps θ (N, G) to
(N, R) and ``residual_and_jac_fn`` to ((N, R), (N, R, G)), and the
reference's batching semantics are written out: the loop runs while any
member is live (not ``done`` and below the iteration cap); a member that
is not live keeps its whole state (``torch.where(live, new, old)`` on
every field), as a vmapped ``while_loop`` freezes its lanes. Every member
is evaluated at every iteration, live or not, as under ``vmap``; a
non-finite member poisons only itself.

Statuses: 0 = max_iter, 1 = gtol, 2 = ftol, 3 = xtol, -1 = non-finite at
the initial point (masked member).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpusysbio_torch import trace
from tpusysbio_torch.config import FitConfig
from tpusysbio_torch.linalg import lu as _lu


class FitResult(NamedTuple):
    """Per-start results; every field leads with N."""

    theta: torch.Tensor
    cost: torch.Tensor
    grad_norm: torch.Tensor       # inf-norm of Jᵀr at the solution
    status: torch.Tensor          # see module docstring
    n_iter: torch.Tensor
    nfev: torch.Tensor            # residual-only integrations
    njev: torch.Tensor            # residual+jacobian integrations
    # accepted-cost trace per iteration; entries beyond n_iter hold the
    # cost the state had when the trace was created
    cost_trace: Optional[torch.Tensor] = None
    # (JᵀJ)⁻¹ at the optimum (the ``cov_x`` of ``scipy.optimize.leastsq``).
    # NaN/inf rows signal a rank-deficient Jacobian, never an exception.
    cov: Optional[torch.Tensor] = None
    # per-parameter 1σ error bars: sqrt(diag(cov) · 2·cost/(m−p))
    param_sigma: Optional[torch.Tensor] = None

    @property
    def success(self):
        return self.status > 0


class LMState(NamedTuple):
    """Resumable LM state: advance it in bounded chunks with ``lm_run``."""

    theta: torch.Tensor       # (N, G)
    r: torch.Tensor           # (N, R)
    J: torch.Tensor           # (N, R, G)
    cost: torch.Tensor        # (N,)
    lam: torch.Tensor
    nu: torch.Tensor
    status: torch.Tensor      # (N,) int32
    done: torch.Tensor        # (N,) bool
    n_iter: torch.Tensor      # (N,) int32
    nfev: torch.Tensor
    njev: torch.Tensor
    grad_norm: torch.Tensor
    cost_trace: torch.Tensor  # (N, max_iter) accepted-cost history


def _finite_rows(x):
    return torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)


def _grad(J, r):
    return (J.transpose(1, 2) @ r[:, :, None])[:, :, 0]


def _traced(trace, n_iter, cost):
    """``trace[:, n_iter] = cost`` per member (dropped beyond the trace)."""
    slots = torch.arange(trace.shape[1], device=cost.device)
    return torch.where(slots[None, :] == n_iter[:, None], cost[:, None],
                       trace)


def _frozen(new, old, live):
    """``new`` where a member is live, else its whole ``old`` state."""
    return type(new)(*(
        torch.where(live.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        for a, b in zip(new, old)))


@trace.spanned("lm.init")
def lm_init(residual_and_jac_fn: Callable, theta0: torch.Tensor,
            config: FitConfig = FitConfig()) -> LMState:
    """Evaluate the initial points ``theta0`` (N, G) into an LM state."""
    dtype, dev = theta0.dtype, theta0.device
    N = theta0.shape[0]
    r0, J0 = residual_and_jac_fn(theta0)
    cost0 = 0.5 * torch.sum(r0 * r0, dim=1)
    bad0 = ~(_finite_rows(r0) & _finite_rows(J0))
    i32 = dict(dtype=torch.int32, device=dev)
    return LMState(
        theta=theta0, r=r0, J=J0, cost=cost0,
        lam=torch.full((N,), config.lam0, dtype=dtype, device=dev),
        nu=torch.full((N,), 2.0, dtype=dtype, device=dev),
        status=torch.where(bad0, -1, 0).to(torch.int32),
        done=bad0, n_iter=torch.zeros(N, **i32),
        nfev=torch.zeros(N, **i32), njev=torch.ones(N, **i32),
        grad_norm=torch.amax(torch.abs(_grad(J0, r0)), dim=1),
        cost_trace=cost0[:, None].expand(N, config.max_iter).clone())


def lm_finish(state: LMState) -> FitResult:
    J = state.J
    m, p = J.shape[1], J.shape[2]
    eye = torch.eye(p, dtype=J.dtype, device=J.device).expand(
        J.shape[0], p, p)
    cov = _lu.lu_solve(_lu.lu_factor(J.transpose(1, 2) @ J), eye)
    s_sq = (2.0 * state.cost / (m - p) if m > p
            else torch.full_like(state.cost, float("inf")))
    param_sigma = torch.sqrt(
        torch.clamp(torch.diagonal(cov, dim1=1, dim2=2), min=0.0)
        * s_sq[:, None])
    return FitResult(
        theta=state.theta, cost=state.cost, grad_norm=state.grad_norm,
        status=state.status, n_iter=state.n_iter, nfev=state.nfev,
        njev=state.njev, cost_trace=state.cost_trace,
        cov=cov, param_sigma=param_sigma)


def lm_fit(residual_fn: Callable, residual_and_jac_fn: Callable,
           theta0: torch.Tensor, config: FitConfig = FitConfig(),
           lower: Optional[torch.Tensor] = None,
           upper: Optional[torch.Tensor] = None) -> FitResult:
    """Minimize ``0.5 ||r(θ)||²`` from every row of ``theta0`` (N, G).

    Args:
      residual_fn: ``θ (N, G) -> r (N, R)`` (one plain integration pass).
      residual_and_jac_fn: ``θ -> (r, J (N, R, G))`` (one sensitivity
        pass); J comes from forward sensitivities.
      lower/upper: optional box bounds in θ (log) space; steps are clipped.
    """
    state = lm_init(residual_and_jac_fn, theta0, config)
    state = lm_run(residual_fn, residual_and_jac_fn, state, config,
                   iter_cap=config.max_iter, lower=lower, upper=upper)
    return lm_finish(state)


def lm_run(residual_fn: Callable, residual_and_jac_fn: Callable,
           state: LMState, config: FitConfig = FitConfig(),
           iter_cap: Optional[int] = None,
           lower: Optional[torch.Tensor] = None,
           upper: Optional[torch.Tensor] = None) -> LMState:
    """Advance every member until it is done or its ``n_iter`` reaches
    ``iter_cap``."""
    dtype = state.theta.dtype
    cap = config.max_iter if iter_cap is None else int(iter_cap)
    eps = torch.finfo(dtype).eps
    lockstep = config.eval_mode == "lockstep"

    def clip_theta(th):
        if lower is not None:
            th = torch.maximum(th, lower)
        if upper is not None:
            th = torch.minimum(th, upper)
        return th

    def body(st: LMState, live) -> LMState:
        Jt = st.J.transpose(1, 2)
        A = Jt @ st.J
        g = _grad(st.J, st.r)
        diag = torch.clamp(torch.diagonal(A, dim1=1, dim2=2), min=1e-12)
        M = A + st.lam[:, None, None] * torch.diag_embed(diag)
        delta = _lu.lu_solve(_lu.lu_factor(M), -g)

        theta_t = clip_theta(st.theta + delta)
        step = theta_t - st.theta
        if lockstep:
            # one sensitivity integration yields residual AND Jacobian
            r_t, J_t = residual_and_jac_fn(theta_t)
            finite_t = _finite_rows(r_t) & _finite_rows(J_t)
        else:
            r_t = residual_fn(theta_t)
            J_t = None
            finite_t = _finite_rows(r_t)
        cost_t = 0.5 * torch.sum(r_t * r_t, dim=1)

        # gain ratio: actual vs model reduction
        pred = 0.5 * torch.sum(step * (st.lam[:, None] * diag * step - g),
                               dim=1)
        pred = torch.clamp(pred, min=eps)
        rho = (st.cost - cost_t) / pred
        accept = finite_t & (cost_t < st.cost)

        # λ update (Nielsen): shrink on good gain, grow geometrically on
        # rejection
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_new = torch.where(
            accept,
            torch.clamp(st.lam * shrink, config.lam_min, config.lam_max),
            torch.clamp(st.lam * st.nu, config.lam_min, config.lam_max))
        nu_new = torch.where(accept, 2.0, st.nu * 2.0)

        if lockstep:
            r_new = torch.where(accept[:, None], r_t, st.r)
            J_new = torch.where(accept[:, None, None], J_t, st.J)
            njev = st.njev + 1
            nfev = st.nfev
        else:
            # fresh Jacobian only on acceptance: evaluated for the batch
            # when any live member accepts, merged per member
            if trace.read((accept & live).any(), "lm.reads"):
                r_f, J_f = residual_and_jac_fn(theta_t)
                r_new = torch.where(accept[:, None], r_f, st.r)
                J_new = torch.where(accept[:, None, None], J_f, st.J)
            else:
                r_new, J_new = st.r, st.J
            njev = st.njev + accept.to(torch.int32)
            nfev = st.nfev + 1
        theta_new = torch.where(accept[:, None], theta_t, st.theta)
        cost_new = torch.where(accept, cost_t, st.cost)

        g_norm = torch.amax(torch.abs(_grad(J_new, r_new)), dim=1)

        # termination (scipy least_squares semantics)
        dcost = st.cost - cost_t
        ftol_hit = accept & (dcost < config.ftol * st.cost)
        # MINPACK info=1: stop when BOTH the actual and the PREDICTED
        # relative reduction are below ftol with a sane gain ratio —
        # evaluated even on rejected trials, so a fit in a flat valley
        # terminates instead of crawling until max_iter
        flat_hit = (finite_t
                    & (torch.abs(dcost) <= config.ftol * st.cost)
                    & (pred <= config.ftol * st.cost)
                    & (rho <= 2.0))
        xtol_hit = accept & (
            torch.linalg.vector_norm(step, dim=1)
            < config.xtol * (config.xtol
                             + torch.linalg.vector_norm(st.theta, dim=1)))
        gtol_hit = g_norm < config.gtol
        # a rejected step at λ_max cannot make progress -> xtol-style stop
        stuck = ~accept & (st.lam >= config.lam_max)

        status = torch.where(
            gtol_hit, 1,
            torch.where(ftol_hit | flat_hit, 2,
                        torch.where(xtol_hit | stuck, 3, 0))
        ).to(torch.int32)

        new = LMState(
            theta=theta_new, r=r_new, J=J_new, cost=cost_new,
            lam=lam_new, nu=nu_new, status=status, done=status > 0,
            n_iter=st.n_iter + 1, nfev=nfev, njev=njev,
            grad_norm=g_norm,
            cost_trace=_traced(st.cost_trace, st.n_iter, cost_new))
        # members that are not live keep their whole state
        return _frozen(new, st, live)

    while True:
        live = ~state.done & (state.n_iter < cap)
        if not trace.read(live.any(), "lm.reads"):
            return state
        with trace.span("lm.iter"):
            state = body(state, live)
