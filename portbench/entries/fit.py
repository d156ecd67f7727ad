"""Entry ``fit``: ``TwoPhaseDriver.run`` over multi-start fits, back to
back.

A unit is one two-phase fit of ``traffic.starts`` starts, a Latin
hypercube in ``theta_true +- traffic.box`` (log space) drawn on the device
from (seed, unit index): a lockstep LM screen of ``screen_iters``
iterations with the configuration's solver ``traffic.screen``, then the
best ``top_k`` polished by ``polish_iters`` iterations with
``traffic.polish``. Work is a start whose screen did not fail
(LM status >= 0 and a finite cost).

Checked, on the fits of the window: ``top_k_miss``, the polished starts
that are not the screen's best ``top_k`` in its own order (exact); and on
a sample of polished starts, the window's best among them, against the
plain reference: ``step_err``, how far the polish's step ``theta -
theta0`` falls short of the reference's LM step from ``theta0`` at the
damping ``lam0``, in the damped normal matrix's norm over that step's size
(where the polish kept its start: the root of the share of the model's
reduction that the reference's step realised), so that a polish which
keeps its start where a step helps reads about 1 and a reversed step 2;
and ``polish_err``, at the parameters the polish returned, the relative
error of the cost and the error of the gradient norm ``|J^T r|_inf`` over
the size of the sum's terms ``| |J|^T |r| |_inf``. The step check is of
one LM iteration, so the cell polishes by ``polish_iters`` 1.
"""

from __future__ import annotations

import numpy as np

from portbench import harness
from portbench.entries import _common
from portbench.harness import sub_seed


class Entry:
    rate_metric = "starts_per_min"

    def __init__(self, ctx):
        import dataclasses

        import torch

        from tpusysbio_torch import FitConfig
        from tpusysbio_torch.fit import TwoPhaseDriver

        self.ctx = ctx
        tr = ctx.traffic
        if tr["polish_iters"] != 1:
            raise ValueError("the step check follows one polish iteration")
        self.dev = torch.device(ctx.device)
        self.tight, self.theta_true = _common.fit_problem(ctx, tr["polish"])
        self.screen = dataclasses.replace(
            self.tight, config=ctx.solver_config(tr["screen"]))
        self.kept = []
        rec = ctx.recorder

        def fns(proj, phase):
            if rec is None:
                return proj.residuals, proj.residuals_and_jacobian

            def res(theta):
                rec.count("residual_calls")
                with rec.span(f"project.res.{phase}"):
                    return proj.residuals(theta)

            def res_jac(theta):
                rec.count("jacobian_calls")
                with rec.span(f"project.jac.{phase}"):
                    return proj.residuals_and_jacobian(theta)

            return res, res_jac

        def driver(screen, tight, screen_iters, polish_iters):
            return TwoPhaseDriver(
                fns(screen, "screen"), fns(tight, "polish"),
                FitConfig(max_iter=screen_iters, eval_mode="lockstep",
                          ftol=tr["screen_ftol"], xtol=tr["screen_xtol"],
                          lam0=tr["lam0"]),
                FitConfig(max_iter=polish_iters, eval_mode="lockstep",
                          lam0=tr["lam0"]),
                tr["top_k"], iter_chunk=tr["iter_chunk"],
                screen_channels="rank", run_tag=ctx.cell.get("name", ""))

        self.driver = driver(self.screen, self.tight, tr["screen_iters"],
                             tr["polish_iters"])

        # the window's shapes over a few steps: the same projects with a
        # short step budget, one iteration each
        def short(proj):
            return dataclasses.replace(proj, config=dataclasses.replace(
                proj.config, max_steps=tr["warmup_max_steps"]))

        self.warm_driver = driver(short(self.screen), short(self.tight),
                                  1, 1)

    def starts(self, i):
        """A Latin hypercube of the unit's starts: one random permutation
        of the strata per parameter, a uniform draw inside each."""
        import torch

        tr = self.ctx.traffic
        N, G = tr["starts"], self.theta_true.shape[0]
        g = torch.Generator(device=self.dev)
        g.manual_seed(sub_seed(self.ctx.seed, "starts", i))
        perms = torch.rand((N, G), generator=g, device=self.dev).argsort(0)
        u = torch.rand((N, G), generator=g, dtype=torch.float64,
                       device=self.dev)
        strata = (perms.to(torch.float64) + u) / N
        return self.theta_true - tr["box"] + 2.0 * tr["box"] * strata

    def warmup(self):
        self.warm_driver.run(self.starts(-1))
        self.warm_driver = None

    def unit(self, i):
        polish, screen, info = self.driver.run(self.starts(i))
        host = {k: _common.host(getattr(screen, k))
                for k in ("theta", "cost", "status")}
        phost = {k: _common.host(getattr(polish, k))
                 for k in ("theta0", "theta", "cost", "grad_norm",
                           "status", "n_iter")}
        self.kept.append(dict(unit=i, screen=host, polish=phost))
        rec = self.ctx.recorder
        if rec is not None:
            rec.info(screen_seconds=info["screen_seconds"],
                     polish_seconds=info["polish_seconds"],
                     lm_iters=int(_common.host(screen.n_iter).max())
                     + int(phost["n_iter"].max()))
        bad = (host["status"] < 0) | ~np.isfinite(host["cost"])
        N = len(bad)
        return dict(attempted=N, failed=int(bad.sum()),
                    work=int(N - bad.sum()))

    def rate(self, totals):
        """The rate of the window's work and its unit."""
        return 60.0 * totals["work"] / totals["seconds"], "starts/min"

    def free(self):
        import torch

        self.driver = self.tight = self.screen = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def picked(self):
        """The polished starts to check: the window's best, and the rest
        of ``check_polished`` drawn from the seed."""
        polished = [{k: p[k][j] for k in ("theta0", "theta", "cost",
                                          "grad_norm")}
                    for p in (fit["polish"] for fit in self.kept)
                    for j in range(len(p["cost"]))]
        if not polished:
            return []
        best = int(np.argmin([p["cost"] for p in polished]))
        rest = [j for j in range(len(polished)) if j != best]
        rng = np.random.default_rng(sub_seed(self.ctx.seed, "fit-sample"))
        n = min(self.ctx.traffic["check_polished"] - 1, len(rest))
        more = rng.choice(rest, size=n, replace=False) if n else []
        return [polished[best]] + [polished[int(j)] for j in more]

    def control_polish(self, picked, solve):
        """The control in the polish's place: one LM iteration from each
        picked start with the reference's Jacobian in bfloat16."""
        from portbench.reference import lm

        lam = self.ctx.traffic["lam0"]
        th0 = [p["theta0"] for p in picked]
        at0 = solve(th0, True, "bfloat16")
        trial = [t + lm.lm_step(r, J, lam) for t, (r, J) in zip(th0, at0)]
        tried = solve(trial, False)
        theta = [tt if lm.cost(rt) < lm.cost(r0) else t
                 for t, tt, (rt, _), (r0, _) in zip(th0, trial, tried, at0)]
        at = solve(theta, True, "bfloat16")
        return [dict(theta0=t, theta=th, cost=lm.cost(r),
                     grad_norm=lm.grad_norm(r, J))
                for t, th, (r, J) in zip(th0, theta, at)]

    def checks(self):
        from portbench.reference import lm
        from portbench.reference.solve import residual_job

        tr = self.ctx.traffic
        k, lam = tr["top_k"], tr["lam0"]
        miss = 0
        for fit in self.kept:
            s = fit["screen"]
            bad = (s["status"] < 0) | ~np.isfinite(s["cost"])
            order = np.argsort(np.where(bad, np.inf, s["cost"]),
                               kind="stable")
            top = s["theta"][order[:k]]
            miss += int(np.sum(np.any(top != fit["polish"]["theta0"],
                                      axis=1)))

        def solve(thetas, with_jac, sens_dtype=None):
            return _common.parallel(residual_job, _common.residual_jobs(
                self.ctx.cfg, thetas, with_jac, sens_dtype))

        picked = self.picked()
        if self.ctx.control == "bf16":
            picked = self.control_polish(picked, solve)
        th0 = [p["theta0"] for p in picked]
        moved = [bool(np.any(p["theta"] != p["theta0"])) for p in picked]
        out = solve(th0 + [p["theta"] for p, m in zip(picked, moved) if m],
                    True)
        at0, later = out[:len(picked)], iter(out[len(picked):])
        at = [next(later) if m else rj for m, rj in zip(moved, at0)]
        steps = [lm.lm_step(r, J, lam) for r, J in at0]
        # where the polish kept its start, the reference tries its own
        # step: the cost it would have lowered is what the polish forwent
        stay = [i for i, m in enumerate(moved) if not m]
        tried = dict(zip(stay, solve([th0[i] + steps[i] for i in stay],
                                     False)))
        step_errs, polish_errs = [], []
        for i, p in enumerate(picked):
            r, J = at[i]
            M = lm.damped(at0[i][1], lam)
            if moved[i]:
                gap = lm.step_gap(p["theta"] - p["theta0"], steps[i], M)
            else:
                gap = lm.kept_gap(lm.cost(at0[i][0]), lm.cost(tried[i][0]),
                                  steps[i], M)
            step_errs.append(gap)
            c_ref, g_ref = lm.cost(r), lm.grad_norm(r, J)
            g_size = float((np.abs(J).T @ np.abs(r)).max())
            polish_errs.append(max(abs(p["cost"] - c_ref) / c_ref,
                                   abs(p["grad_norm"] - g_ref) / g_size))
        harness.log(f"checked {len(picked)} polished starts, "
                    f"{len(stay)} kept their start")
        return _common.limited(self.ctx.cell, top_k_miss=miss,
                               step_err=_common.worst(step_errs),
                               polish_err=_common.worst(polish_errs))
