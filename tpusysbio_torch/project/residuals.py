"""The ``Project``: stacked weighted residuals and sensitivity Jacobians
across a multi-experiment ensemble, for a batch of parameter vectors.

Port of ``tpusysbio/project/residuals.py``. Pipeline:

1. θ (log space, (N, G)) -> per-experiment model parameters (mapping.py),
2. integrate every (start, experiment) pair as one member of a flattened
   ``B = N·E`` stepper batch — states + forward sensitivities ride one
   column-block BDF solve (solvers/bdf.py) with per-member ``t_span`` and
   ``t_eval``, dense output at each experiment's measurement grid,
3. observables + their parameter sensitivities via ``torch.func.jvp``,
4. gather at measurement (time, observable) indices,
5. project-level scale factors B per measurement group with analytic dB/dθ
   (scale_factors.py),
6. residuals ``mask · (B·sim − data)/σ`` and Jacobian
   ``mask · (B·dsim + sim·dB)/σ`` with the log-transform factor folded in
   by the mapping chain (dp/dθ = p).

The reference gets N from ``jax.vmap`` over its single-θ functions; here
every method takes θ as (N, G), or (G,) for one vector (the leading
dimension is then dropped from the results).

A model without the closed-form ``rhs_sens``/``rhs_sens_dir`` that the
chosen ``sens_mode`` needs takes its columns from ``sens/forward.py``.

Not ported yet (``NotImplementedError`` at construction): ``priors``,
``experiment_mesh``, batches with timed inputs (segments),
pre-equilibration, initial-value overrides and steady-state rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from tpusysbio_torch import solvers
from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.data import ExperimentBatch
from tpusysbio_torch.model.core import OdeModel
from tpusysbio_torch.project.mapping import ParameterMap
from tpusysbio_torch.project.scale_factors import (
    scale_factors as _scale_factors,
    scale_factors_and_grad as _scale_factors_and_grad,
)
from tpusysbio_torch.sens import make_sens_rhs, make_sens_rhs_dir


class ProjectEval(NamedTuple):
    """Full evaluation record; every field leads with N."""

    residuals: torch.Tensor           # (N, R)
    jacobian: Optional[torch.Tensor]  # (N, R, G) or None
    cost: torch.Tensor                # (N,) 0.5 * sum(r^2)
    scale: torch.Tensor               # (N, n_groups) fitted scale factors
    status: torch.Tensor              # (N, E) per-experiment solver status
    nsteps: torch.Tensor              # (N, E)


@dataclasses.dataclass(frozen=True)
class Project:
    """Objective assembly over an experiment batch.

    ``residuals(θ)`` and ``residuals_and_jacobian(θ)`` are functions of a
    batch of θ — hand them to the LM optimizer (optim/lm.py) or the
    multi-start runner (fit/multistart.py). Tensors follow the device of
    ``batch`` and ``pmap``.
    """

    model: OdeModel
    pmap: ParameterMap
    batch: ExperimentBatch
    solver: str = "bdf"
    config: SolverConfig = SolverConfig()
    experiment_mesh: Optional[object] = None
    # steady-state rows (not ported yet; kept for field parity)
    ss_t_relax: float = 10.0
    ss_max_newton: int = 25
    # Sensitivity column space: 'params' propagates all P model-parameter
    # columns and chains to θ afterwards; 'theta' moves the chain rule
    # INSIDE the integrator and propagates only the G fit-parameter columns
    # (the MAPK headline: 12 over 30). 'auto' picks 'theta' when G < P.
    sens_mode: str = "auto"
    priors: Optional[object] = None

    def __post_init__(self):
        b = self.batch
        unported = [name for name, used in (
            ("priors", self.priors is not None),
            ("experiment_mesh", self.experiment_mesh is not None),
            ("steady-state rows", b.has_steady),
            ("timed inputs (segments)", b.seg_bounds is not None),
            ("preequilibrate", b.has_preeq),
            ("y0_overrides", b.has_y0_over)) if used]
        if unported:
            raise NotImplementedError(
                "Project: not ported yet: " + ", ".join(unported))
        if self.sens_mode not in ("auto", "theta", "params"):
            raise ValueError(f"unknown sens_mode {self.sens_mode!r}")
        if self.pmap.map_idx.device != b.t_eval.device:
            raise ValueError("pmap and batch must lie on one device")

    @property
    def n_residuals(self) -> int:
        return self.batch.n_residuals

    @property
    def n_theta(self) -> int:
        return self.pmap.n_global

    @property
    def _theta_sens(self) -> bool:
        if self.sens_mode == "auto":
            return self.pmap.n_global < self.model.n_params
        return self.sens_mode == "theta"

    # ------------------------------------------------------------------
    def _sim(self, p, t0, t_end, t_eval, C, with_sens: bool):
        """Simulate the flattened batch: ``p`` (B, P), times (B,)/(B, T).
        With ``C`` (B, P, G) — the chain dp/dθ — sensitivities are
        propagated directly in θ space (G columns); otherwise in
        model-parameter space (P columns)."""
        model = self.model
        solve = solvers.SOLVERS[self.solver]
        Bm, P = p.shape

        def f(t, y):
            # dtype-following: the stepper's mixed-precision mode feeds f32
            return model.rhs(t, y, p.to(y.dtype))

        jac = (None if model.rhs_jac is None
               else (lambda t, y: model.rhs_jac(t, y, p.to(y.dtype))))
        y0 = model.y0(p)
        if with_sens:
            dy0 = model.y0_sensitivity(p)            # (B, n, P)
            if C is not None:
                s0 = dy0 @ C
                if model.rhs_sens_dir is not None:
                    def sens_rhs(t, y, S):
                        return model.rhs_sens_dir(t, y, S, p, C)
                else:
                    sens_rhs = make_sens_rhs_dir(model.rhs, p, C)
            else:
                s0 = dy0
                if model.rhs_sens is not None:
                    def sens_rhs(t, y, S):
                        return model.rhs_sens(t, y, S, p)
                else:
                    sens_rhs = make_sens_rhs(model.rhs, p)

            res = solve(f, (t0, t_end), y0, t_eval, config=self.config,
                        sens_rhs=sens_rhs, s0=s0, jac=jac)
        else:
            res = solve(f, (t0, t_end), y0, t_eval, config=self.config,
                        jac=jac)

        # observables g(y, p) and their total parameter derivative, over
        # the (member, time) pairs flattened to one batch
        T = t_eval.shape[1]
        ys_f = res.ys.reshape(Bm * T, -1)
        # copies, not stride-0 views (which reshape keeps when Bm == 1):
        # forward-mode AD refuses a primal whose elements share memory
        p_f = p.repeat_interleave(T, dim=0)
        obs_traj = model.observables(ys_f, p_f).reshape(Bm, T, -1)
        if not with_sens:
            return obs_traj, None, res.status, res.nsteps

        # parameter directions per sensitivity column: dp/dθ columns in θ
        # mode, the identity in params mode
        dirs = C if C is not None else torch.eye(
            P, dtype=p.dtype, device=p.device).expand(Bm, P, P)
        K = dirs.shape[-1]
        sens_f = res.sens.reshape(Bm * T, -1, K)
        dirs_f = dirs.repeat_interleave(T, dim=0)

        def obs_dcol(s_col, c_col):
            return torch.func.jvp(model.observables, (ys_f, p_f),
                                  (s_col, c_col))[1]

        obs_sens = torch.func.vmap(obs_dcol, in_dims=(2, 2), out_dims=2)(
            sens_f, dirs_f).reshape(Bm, T, -1, K)
        return obs_traj, obs_sens, res.status, res.nsteps

    def _gathered(self, theta, with_jac: bool):
        b = self.batch
        N = theta.shape[0]
        E, T, M = b.n_experiments, b.n_times, b.n_meas
        Bm = N * E
        p_all = self.pmap.expand(theta)                      # (N, E, P)
        theta_mode = with_jac and self._theta_sens

        def per_start(x):
            return x[None].expand(N, *x.shape).reshape(Bm, *x.shape[1:])

        C = (self.pmap.chain(theta).reshape(Bm, -1, self.n_theta)
             if theta_mode else None)
        obs_traj, obs_sens, status, nsteps = self._sim(
            p_all.reshape(Bm, -1), per_start(b.t0), per_start(b.t_end),
            per_start(b.t_eval), C, with_jac)

        # gather at measurement (time, observable) indices, per member
        bi = torch.arange(Bm, device=theta.device)[:, None]
        t_idx = per_start(b.m_t_idx).long()
        o_idx = per_start(b.m_obs).long()
        sim = obs_traj[bi, t_idx, o_idx].reshape(N, E, M)
        dsim = None
        if with_jac:
            dsim_p = obs_sens[bi, t_idx, o_idx]              # (Bm, M, G|P)
            if theta_mode:
                # columns already ARE dθ derivatives
                dsim = dsim_p
            else:
                chain = self.pmap.chain(theta).reshape(Bm, -1, self.n_theta)
                dsim = dsim_p.to(chain.dtype) @ chain
            dsim = dsim.reshape(N, E, M, self.n_theta)
        return sim, dsim, status.reshape(N, E), nsteps.reshape(N, E)

    # ------------------------------------------------------------------
    def evaluate(self, theta, with_jac: bool = False) -> ProjectEval:
        """Evaluate at θ (N, G), or (G,) for one vector."""
        b = self.batch
        theta = torch.as_tensor(theta, device=b.t_eval.device)
        if theta.ndim == 1:
            ev = self.evaluate(theta[None], with_jac)
            return ProjectEval(*(None if x is None else x[0] for x in ev))
        if theta.ndim != 2 or theta.shape[1] != self.n_theta:
            raise ValueError(f"theta must be (N, {self.n_theta}) or "
                             f"({self.n_theta},); got {tuple(theta.shape)}")
        N = theta.shape[0]
        sim_em, dsim_emg, status, nsteps = self._gathered(theta, with_jac)
        R = b.n_residuals
        sim = sim_em.reshape(N, R)
        data = b.values.reshape(R)
        sigma = b.sigmas.reshape(R)
        group = b.group.reshape(R)
        mask = b.mask.reshape(R)
        inv_var = 1.0 / (sigma * sigma)
        inv_sig = torch.where(mask, 1.0 / sigma, torch.zeros_like(sigma))
        grouped = group >= 0
        gclip = torch.clamp(group, min=0).long()
        one = torch.ones((), dtype=theta.dtype, device=theta.device)

        if with_jac:
            dsim = dsim_emg.reshape(N, R, self.n_theta)
            if b.n_groups:
                B, dB = _scale_factors_and_grad(
                    sim, dsim, data, inv_var, group, mask, b.n_groups)
            else:
                B = torch.ones((N, 1), dtype=theta.dtype,
                               device=theta.device)
                dB = torch.zeros((N, 1, self.n_theta), dtype=theta.dtype,
                                 device=theta.device)
            B_row = torch.where(grouped, B[:, gclip], one)
            dB_row = torch.where(grouped[:, None], dB[:, gclip], 0.0 * one)
            r = inv_sig * (B_row * sim - data)
            J = inv_sig[:, None] * (B_row[..., None] * dsim
                                    + sim[..., None] * dB_row)
        else:
            if b.n_groups:
                B = _scale_factors(sim, data, inv_var, group, mask,
                                   b.n_groups)
            else:
                B = torch.ones((N, 1), dtype=theta.dtype,
                               device=theta.device)
            B_row = torch.where(grouped, B[:, gclip], one)
            r = inv_sig * (B_row * sim - data)
            J = None

        cost = 0.5 * torch.sum(r * r, dim=1)
        return ProjectEval(residuals=r, jacobian=J, cost=cost, scale=B,
                           status=status, nsteps=nsteps)

    # convenience closures -------------------------------------------------
    def residuals(self, theta) -> torch.Tensor:
        return self.evaluate(theta, with_jac=False).residuals

    def residuals_and_jacobian(self, theta):
        ev = self.evaluate(theta, with_jac=True)
        return ev.residuals, ev.jacobian

    def cost(self, theta) -> torch.Tensor:
        return self.evaluate(theta, with_jac=False).cost
