"""The ``Project``: stacked weighted residuals and sensitivity Jacobians
across a multi-experiment ensemble, for a batch of parameter vectors.

Port of ``tpusysbio/project/residuals.py``. Pipeline:

1. θ (log space, (N, G)) -> per-experiment model parameters (mapping.py),
2. integrate every (start, experiment) pair as one member of a flattened
   ``B = N·E`` stepper batch — states + forward sensitivities ride one
   column-block BDF solve (solvers/bdf.py) with per-member ``t_span`` and
   ``t_eval``, dense output at each experiment's measurement grid;
   experiments with timed inputs integrate segment by segment
   (``_sim_segments``), pre-equilibrated ones start from the basal steady
   state (solvers/steady_state.py), and ``y0_overrides`` reset initial
   values after that,
3. observables + their parameter sensitivities via ``torch.func.jvp``,
4. gather at measurement (time, observable) indices; steady-state rows
   gather from the experiment's algebraic equilibrium (damped Newton with
   implicit-function-theorem sensitivities) instead,
5. project-level scale factors B per measurement group with analytic dB/dθ
   (scale_factors.py),
6. residuals ``mask · (B·sim − data)/σ`` and Jacobian
   ``mask · (B·dsim + sim·dB)/σ`` with the log-transform factor folded in
   by the mapping chain (dp/dθ = p), then the prior rows
   (project/priors.py) appended.

The reference gets N from ``jax.vmap`` over its single-θ functions; here
every method takes θ as (N, G), or (G,) for one vector (the leading
dimension is then dropped from the results). The steady-state solves run
only on the members whose experiments need them (a pre-equilibrated
experiment, or one with steady-state rows); the reference solves for
every experiment under ``vmap`` and discards the others' results.

A model without the closed-form ``rhs_sens``/``rhs_sens_dir`` that the
chosen ``sens_mode`` needs takes its columns from ``sens/forward.py``.

``experiment_mesh`` (``utils.make_mesh``) splits the experiments over the
ranks of a process group: each rank integrates the N × E_r members of its
contiguous block of experiments, the predictions and their θ-columns are
all-gathered in experiment order, and the scale factors, priors and
residual assembly then run whole on every rank, so every rank returns the
full ``r`` and ``J``. E need not divide by the mesh size: blocks hold
⌈E / size⌉ experiments, the last ones fewer, and the gather drops the pads.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpusysbio_torch import solvers, trace
from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.data import ExperimentBatch
from tpusysbio_torch.model.core import OdeModel
from tpusysbio_torch.project.mapping import ParameterMap
from tpusysbio_torch.project.priors import Priors
from tpusysbio_torch.project.scale_factors import (
    scale_factors as _scale_factors,
    scale_factors_and_grad as _scale_factors_and_grad,
    segment_index,
)
from tpusysbio_torch.sens import make_sens_rhs, make_sens_rhs_dir
from tpusysbio_torch.solvers.common import (STATUS_DONE, STATUS_SS_FAIL,
                                            IntegrateResult)
from tpusysbio_torch.solvers.steady_state import steady_state
from tpusysbio_torch.utils import all_gather, check_device


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
    # Steady-state rows and pre-equilibration: coarse relaxation horizon
    # seeding the equilibrium Newton solve (solvers/steady_state.py)
    ss_t_relax: float = 10.0
    ss_max_newton: int = 25
    # Sensitivity column space: 'params' propagates all P model-parameter
    # columns and chains to θ afterwards; 'theta' moves the chain rule
    # INSIDE the integrator and propagates only the G fit-parameter columns
    # (the MAPK headline: 12 over 30). 'auto' picks 'theta' when G < P.
    sens_mode: str = "auto"
    # Optional log-normal priors on parameters / scale factors, appended
    # as extra least-squares rows (project/priors.py)
    priors: Optional[Priors] = None

    def __post_init__(self):
        b = self.batch
        if self.sens_mode not in ("auto", "theta", "params"):
            raise ValueError(f"unknown sens_mode {self.sens_mode!r}")
        if self.pmap.map_idx.device != b.t_eval.device:
            raise ValueError("pmap and batch must lie on one device")
        # static per batch, read on the host once: the scale groups' row
        # lists and the experiments that need a steady-state solve
        dev = b.t_eval.device
        set_ = object.__setattr__
        set_(self, "_seg_index", segment_index(b.group.reshape(-1),
                                               b.n_groups)
             if b.n_groups else None)
        set_(self, "_preeq_exps", torch.as_tensor(
            np.flatnonzero(b.preeq.cpu().numpy()) if b.has_preeq
            else np.zeros(0, np.int64), device=dev))
        set_(self, "_ss_exps", torch.as_tensor(
            np.flatnonzero(b.m_is_ss.any(1).cpu().numpy()), device=dev))
        mesh = self.experiment_mesh
        set_(self, "_block", None)
        if mesh is not None and mesh.size > 1:
            check_device(b.t_eval, mesh, "the batch's tensors")
            # this rank's experiments as a Project of their own; a rank
            # whose block is empty integrates experiment 0 as a pad
            E = b.n_experiments
            per = -(-E // mesh.size)
            counts = [min(per, max(E - r * per, 0)) for r in range(mesh.size)]
            lo = mesh.rank * per
            exps = torch.arange(lo, lo + counts[mesh.rank], device=dev) \
                if counts[mesh.rank] else torch.zeros(1, dtype=torch.long,
                                                      device=dev)
            sub = dataclasses.replace(
                self, pmap=_take_experiments(self.pmap, exps),
                batch=_take_experiments(b, exps), experiment_mesh=None,
                priors=None)
            set_(self, "_block", (sub, counts, per))

    @property
    def n_residuals(self) -> int:
        extra = self.priors.n_rows if self.priors is not None else 0
        return self.batch.n_residuals + extra

    @property
    def n_theta(self) -> int:
        return self.pmap.n_global

    @property
    def _theta_sens(self) -> bool:
        if self.sens_mode == "auto":
            return self.pmap.n_global < self.model.n_params
        return self.sens_mode == "theta"

    # ------------------------------------------------------------------
    def _seg_fns(self, p_k, C, dirs_k, with_sens: bool):
        """RHS / Jacobian / sensitivity-RHS closures for the parameters
        ``p_k`` (B, P) of one segment. ``dirs_k`` (B, P) zeroes the
        direction of parameters clamped to constants in this segment
        (their dp_k/dp vanishes while clamped); None means no clamping
        (the one-segment path keeps the closed-form full-column
        ``rhs_sens`` when the model has it)."""
        model = self.model

        def f(t, y):
            # dtype-following: the stepper's mixed-precision mode feeds f32
            return model.rhs(t, y, p_k.to(y.dtype))

        jac = (None if model.rhs_jac is None
               else (lambda t, y: model.rhs_jac(t, y, p_k.to(y.dtype))))
        if not with_sens:
            return f, jac, None
        if C is not None or dirs_k is not None:
            # θ mode: the chain's columns; params mode with clamped
            # parameters: all P columns, the clamped ones without a ∂f/∂p
            # term in this segment
            if C is None:
                C_k = torch.diag_embed(dirs_k)
            else:
                C_k = C if dirs_k is None else C * dirs_k[:, :, None]
            if model.rhs_sens_dir is not None:
                def sens_rhs(t, y, S):
                    return model.rhs_sens_dir(t, y, S, p_k, C_k)
            else:
                sens_rhs = make_sens_rhs_dir(model.rhs, p_k, C_k)
        elif model.rhs_sens is not None:
            def sens_rhs(t, y, S):
                return model.rhs_sens(t, y, S, p_k)
        else:
            sens_rhs = make_sens_rhs(model.rhs, p_k)
        return f, jac, sens_rhs

    @trace.spanned("project.observe")
    def _observe(self, y, p, S, dirs):
        """Observables ``g(y, p)`` of (B, k, n) states and, with ``S`` (B,
        k, n, K), their total derivative along the K parameter directions
        ``dirs`` (B, P, K): (B, k, n_obs) and (B, k, n_obs, K)."""
        model = self.model
        Bm, k = y.shape[:2]
        y_f = y.reshape(Bm * k, -1)
        # copies, not stride-0 views (which reshape keeps when Bm == 1):
        # forward-mode AD refuses a primal whose elements share memory
        p_f = p.repeat_interleave(k, dim=0)
        obs = model.observables(y_f, p_f).reshape(Bm, k, -1)
        if S is None:
            return obs, None
        K = dirs.shape[-1]
        s_f = S.reshape(Bm * k, -1, K)
        dirs_f = dirs.repeat_interleave(k, dim=0)

        def obs_dcol(s_col, c_col):
            return torch.func.jvp(model.observables, (y_f, p_f),
                                  (s_col, c_col))[1]

        obs_sens = torch.func.vmap(obs_dcol, in_dims=(2, 2), out_dims=2)(
            s_f, dirs_f).reshape(Bm, k, -1, K)
        return obs, obs_sens

    @trace.spanned("project.steady")
    def _steady(self, p, y0, with_sens: bool):
        return steady_state(
            self.model.rhs, p, y0, config=self.config,
            t_relax=self.ss_t_relax, max_newton=self.ss_max_newton,
            with_sens=with_sens, jac_fn=self.model.rhs_jac)

    def _sim(self, p, t0, t_end, t_eval, C, with_sens: bool, extra: dict):
        """Simulate the flattened batch: ``p`` (B, P), times (B,)/(B, T).
        With ``C`` (B, P, G) — the chain dp/dθ — sensitivities are
        propagated directly in θ space (G columns); otherwise in
        model-parameter space (P columns).

        ``extra`` holds the per-member experiment features, each present
        only when the batch uses it: ``segs`` = (bounds (B, S+1), mask (B,
        S, P), vals (B, S, P), state mask (B, S, n) or None, state vals)
        integrates segment by segment; ``preeq`` = (members, mask, vals)
        replaces y0 of those members by the steady state under basal
        parameters and chains the IFT dy*/dp into s0; ``y0_over`` = (mask
        (B, n), vals) resets initial values after that; ``ss`` = the
        members whose experiments have steady-state rows."""
        model = self.model
        solve = solvers.SOLVERS[self.solver]
        Bm, P = p.shape
        dtype = p.dtype
        segs = extra.get("segs")
        if segs is not None:
            p0 = torch.where(segs[1][:, 0], segs[2][:, 0], p)
            dirs0 = (~segs[1][:, 0]).to(dtype)
        else:
            p0, dirs0 = p, None

        y0 = model.y0(p0)
        s0 = None
        if with_sens:
            dy0 = model.y0_sensitivity(p0)            # (B, n, P)
            if dirs0 is not None:
                dy0 = dy0 * dirs0[:, None, :]
            s0 = dy0 @ C if C is not None else dy0

        ss_fail = torch.zeros(Bm, dtype=torch.bool, device=p.device)
        if "preeq" in extra:
            idx, pre_mask, pre_vals = extra["preeq"]
            p_basal = torch.where(pre_mask, pre_vals, p[idx])
            ss0 = self._steady(p_basal, model.y0(p_basal), with_sens)
            y0 = y0.index_copy(0, idx, ss0.y.to(y0.dtype))
            if with_sens:
                # IFT dy*/dp in model-parameter space; basal-clamped
                # parameters are constants, so their columns vanish
                s_pre = ss0.sens * (~pre_mask)[:, None, :].to(dtype)
                if C is not None:
                    s_pre = s_pre @ C[idx]
                s0 = s0.index_copy(0, idx, s_pre.to(s0.dtype))
            ss_fail = ss_fail.index_copy(0, idx, ~ss0.converged)

        if "y0_over" in extra:
            # initial-VALUE overrides, after pre-equilibration: a constant
            # start has zero parameter sensitivity
            yo_mask, yo_vals = extra["y0_over"]
            y0 = torch.where(yo_mask, yo_vals, y0)
            if with_sens:
                s0 = s0 * (~yo_mask)[:, :, None].to(s0.dtype)

        if segs is None:
            f, jac, sens_rhs = self._seg_fns(p, C, None, with_sens)
            res = solve(f, (t0, t_end), y0, t_eval, config=self.config,
                        sens_rhs=sens_rhs, s0=s0, jac=jac)
        else:
            res = self._sim_segments(p, segs, t_eval, y0, s0, C, with_sens,
                                     solve)

        # observables g(y, p) with the experiment's BASE parameters
        # (perturbations change the dynamics, not the observation map);
        # parameter directions per column: dp/dθ in θ mode, the identity
        # in params mode
        dirs = None
        if with_sens:
            dirs = C if C is not None else torch.eye(
                P, dtype=dtype, device=p.device).expand(Bm, P, P)
        obs_traj, obs_sens = self._observe(
            res.ys, p, res.sens if with_sens else None, dirs)

        status = torch.where(ss_fail, STATUS_SS_FAIL, res.status)
        obs_ss = obs_ss_sens = None
        if "ss" in extra:
            idx = extra["ss"]
            ss = self._steady(p[idx], y0[idx], with_sens)
            sens_ss = None
            if with_sens:
                # IFT sensitivities come back in model-parameter space
                sens_ss = (ss.sens @ C[idx] if C is not None
                           else ss.sens)[:, None]
            o, o_s = self._observe(ss.y[:, None], p[idx], sens_ss,
                                   None if dirs is None else dirs[idx])
            obs_ss = o.new_zeros((Bm,) + o.shape[2:]).index_copy(
                0, idx, o[:, 0])
            if with_sens:
                obs_ss_sens = o_s.new_zeros((Bm,) + o_s.shape[2:]) \
                    .index_copy(0, idx, o_s[:, 0])
            # only experiments with steady-state rows fail on it
            status = status.index_copy(0, idx, torch.where(
                ss.converged, status[idx], STATUS_SS_FAIL).to(status.dtype))
        return (obs_traj, obs_sens, obs_ss, obs_ss_sens,
                status.to(torch.int32), res.nsteps)

    def _sim_segments(self, p, segs, t_eval, y0, s0, C, with_sens: bool,
                      solve) -> IntegrateResult:
        """Piecewise integration across each member's segment boundaries
        (the timed inputs): S stepper calls over the whole batch with
        per-member (B,) ends. State and sensitivity columns carry over each
        boundary (perturbation values are constants, so y and S are
        continuous); an ``input_states`` assignment SETS the carried state
        where masked and zeroes those rows' sensitivities; clamped
        parameters' direction columns are zeroed while clamped; padded
        zero-length segments report DONE (common.status_init) and no-op."""
        bounds, smask, svals, sy_mask, sy_vals = segs
        Bm, n = y0.shape
        dtype = y0.dtype
        T = t_eval.shape[1]
        m = s0.shape[-1] if with_sens else 0
        ys_tot = torch.zeros((Bm, T, n), dtype=dtype, device=y0.device)
        sens_tot = torch.zeros((Bm, T, n, m), dtype=dtype, device=y0.device)
        y_c, s_c = y0, s0
        status = counters = None
        for k in range(smask.shape[1]):
            with trace.span("project.segment"):
                t_lo, t_hi = bounds[:, k], bounds[:, k + 1]
                if sy_mask is not None:
                    y_c = torch.where(sy_mask[:, k], sy_vals[:, k], y_c)
                    if with_sens:
                        s_c = s_c * (~sy_mask[:, k])[:, :, None].to(s_c.dtype)
                p_k = torch.where(smask[:, k], svals[:, k], p)
                dirs_k = (~smask[:, k]).to(p.dtype)
                f, jac, sens_rhs = self._seg_fns(p_k, C, dirs_k, with_sens)
                res = solve(f, (t_lo, t_hi), y_c, t_eval, config=self.config,
                            sens_rhs=sens_rhs, s0=s_c, jac=jac)
                # the stepper fills t_eval points in [t_lo, t_hi] only (t_lo
                # by the at-t0 prefill); boundary points are written by both
                # adjoining segments with the SAME carried state
                filled = ((t_eval >= t_lo[:, None])
                          & (t_eval <= t_hi[:, None]))
                ys_tot = torch.where(filled[..., None], res.ys.to(dtype),
                                     ys_tot)
                if with_sens:
                    sens_tot = torch.where(filled[..., None, None],
                                           res.sens.to(dtype), sens_tot)
                y_c = res.y_final[..., 0]
                if with_sens:
                    s_c = res.y_final[..., 1:]
                # first failure wins
                status = (res.status if status is None else
                          torch.where(status == STATUS_DONE, res.status,
                                      status))
                cs = (res.nsteps, res.naccepted, res.nrejected, res.nfev,
                      res.njev, res.nlu, res.order_hist)
                counters = cs if counters is None else tuple(
                    a + b for a, b in zip(counters, cs))
        return IntegrateResult(
            ys=ys_tot, sens=sens_tot, status=status, nsteps=counters[0],
            naccepted=counters[1], nrejected=counters[2], nfev=counters[3],
            njev=counters[4], nlu=counters[5], order_hist=counters[6],
            t_final=bounds[:, -1],
            y_final=torch.cat([y_c[..., None]]
                              + ([s_c] if with_sens else []), dim=-1))

    def _gathered_on_mesh(self, theta, with_jac: bool):
        """``_gathered`` of this rank's block of experiments, all-gathered
        along the experiment axis in experiment order."""
        sub, counts, per = self._block
        mesh = self.experiment_mesh
        mine = counts[mesh.rank]

        def gather(x):
            # pad this block to ``per`` experiments (dim 1), gather, drop
            # every block's pads
            x = x[:, :mine].transpose(0, 1)
            x = torch.cat([x, x.new_zeros((per - mine,) + x.shape[1:])])
            parts = all_gather(x, mesh)
            return torch.cat([p[:c] for p, c in zip(parts, counts)]) \
                .transpose(0, 1)

        return tuple(None if x is None else gather(x)
                     for x in sub._gathered(theta, with_jac))

    def _gathered(self, theta, with_jac: bool):
        if self._block is not None:
            return self._gathered_on_mesh(theta, with_jac)
        b = self.batch
        N = theta.shape[0]
        E, M = b.n_experiments, b.n_meas
        Bm = N * E
        p_all = self.pmap.expand(theta)                      # (N, E, P)
        theta_mode = with_jac and self._theta_sens
        dev = theta.device

        def per_start(x):
            return x[None].expand(N, *x.shape).reshape(Bm, *x.shape[1:])

        def members(exps):
            # rows of the flattened batch whose experiment is in ``exps``
            return (torch.arange(N, device=dev)[:, None] * E
                    + exps[None, :]).reshape(-1)

        extra = {}
        if b.seg_bounds is not None:
            extra["segs"] = tuple(
                None if x is None else per_start(x)
                for x in (b.seg_bounds, b.seg_mask, b.seg_vals,
                          b.seg_y0_mask, b.seg_y0_vals))
        if self._preeq_exps.numel():
            idx = members(self._preeq_exps)
            extra["preeq"] = (idx, per_start(b.preeq_mask)[idx],
                              per_start(b.preeq_vals)[idx])
        if b.has_y0_over:
            extra["y0_over"] = (per_start(b.y0_mask), per_start(b.y0_vals))
        if b.has_steady:
            extra["ss"] = members(self._ss_exps)

        C = (self.pmap.chain(theta).reshape(Bm, -1, self.n_theta)
             if theta_mode else None)
        obs_traj, obs_sens, obs_ss, obs_ss_sens, status, nsteps = self._sim(
            p_all.reshape(Bm, -1), per_start(b.t0), per_start(b.t_end),
            per_start(b.t_eval), C, with_jac, extra)

        # gather at measurement (time, observable) indices, per member;
        # steady-state rows gather from the equilibrium observables instead
        bi = torch.arange(Bm, device=dev)[:, None]
        t_idx = per_start(b.m_t_idx).long()
        o_idx = per_start(b.m_obs).long()
        sim = obs_traj[bi, t_idx, o_idx]
        if b.has_steady:
            is_ss = per_start(b.m_is_ss)
            sim = torch.where(is_ss, obs_ss[bi, o_idx].to(sim.dtype), sim)
        sim = sim.reshape(N, E, M)
        dsim = None
        if with_jac:
            dsim_p = obs_sens[bi, t_idx, o_idx]              # (Bm, M, G|P)
            if b.has_steady:
                dsim_p = torch.where(is_ss[..., None],
                                     obs_ss_sens[bi, o_idx]
                                     .to(dsim_p.dtype), dsim_p)
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
        with trace.span("project.evaluate"):
            return self._evaluate(theta, with_jac)

    def _evaluate(self, theta, with_jac: bool) -> ProjectEval:
        b = self.batch
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
                with trace.span("project.scale"):
                    B, dB = _scale_factors_and_grad(
                        sim, dsim, data, inv_var, group, mask, b.n_groups,
                        self._seg_index)
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
            if self.priors is not None:
                r_p, J_p = self.priors.rows(theta, B, dB)
                r = torch.cat([r, r_p], dim=1)
                J = torch.cat([J, J_p], dim=1)
        else:
            if b.n_groups:
                with trace.span("project.scale"):
                    B = _scale_factors(sim, data, inv_var, group, mask,
                                       b.n_groups, self._seg_index)
            else:
                B = torch.ones((N, 1), dtype=theta.dtype,
                               device=theta.device)
            B_row = torch.where(grouped, B[:, gclip], one)
            r = inv_sig * (B_row * sim - data)
            if self.priors is not None:
                r = torch.cat([r, self.priors.rows(theta, B)[0]], dim=1)
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


def _take_experiments(obj, exps: torch.Tensor):
    """An ``ExperimentBatch`` or ``ParameterMap`` restricted to the
    experiments ``exps``: every tensor field leads with E. The batch's
    ``has_steady`` follows its own rows (the segment, pre-equilibration
    and override paths act on masks, which hold for any subset)."""
    fields = {f.name: getattr(obj, f.name)[exps]
              for f in dataclasses.fields(obj)
              if isinstance(getattr(obj, f.name), torch.Tensor)}
    if isinstance(obj, ExperimentBatch):
        fields["has_steady"] = bool(fields["m_is_ss"].any())
    return dataclasses.replace(obj, **fields)
