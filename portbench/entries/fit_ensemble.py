"""Entry ``fit_ensemble``: ``entries/fit.py``'s two-phase multi-start fits,
of a multi-experiment ``Project`` with shared and local parameters and
relative data.

The configuration's ``ensemble`` block gives the problem: one experiment
a dose (the local parameter's value), the shared parameters fitted in log
space beside each dose's own local one, the fixed ones, and one relative
measurement an observable, each in its own scale group, over the stored
data (``portbench/data``, made by ``portbench/reference/jakstat.py``).
The port fits the scale factors in closed form, pooled over the doses.

A unit is ``traffic.fits_per_unit`` of ``entries/fit.py``'s fits back to
back, each from starts of its own: a fit of this host-bound cell takes
about as long as a run's window, and the window then times several fits
in place of one. A profiled unit is one fit: its metrics are ratios of
trips and evaluations. The rate and the checks are ``entries/fit.py``'s
(``top_k_miss``, ``step_err``, ``polish_err``), against
``portbench/reference/jakstat.py``: its residuals carry its own scale
factors, and its Jacobian their gradient ``dB/dtheta``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import harness
from portbench.entries import _common, fit


def ensemble_problem(ctx, solver_key):
    """The configuration's ensemble fit as a ``Project`` of the port, with
    the solver ``solver_key``. Returns the project and ``theta_true``."""
    import torch

    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.project import ParameterMap, Project

    spec, dev = ctx.cfg["ensemble"], torch.device(ctx.device)
    data = harness.load_json(harness.HERE / "data" / spec["data"])
    model = ctx.model()
    t = np.asarray(data["times"])
    exps = [Experiment(name, tuple(
        Measurement(obs_index=g, times=t, values=np.asarray(vals),
                    sigmas=np.full(len(t), data["sigma"][g]),
                    scale_group=group)
        for g, (group, vals) in enumerate(zip(data["scale_groups"],
                                              values))))
        for name, values in zip(data["experiments"], data["values"])]
    batch = ExperimentBatch.from_experiments(exps, device=dev)
    pmap = ParameterMap.create(model.param_names, len(exps),
                               shared=tuple(spec["shared"]),
                               local=tuple(spec["local"]),
                               fixed=spec["fixed"], device=dev)
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=ctx.solver_config(solver_key))
    return proj, pmap.pack(spec["true"])


class Entry(fit.Entry):
    def __init__(self, ctx):
        import torch

        from tpusysbio_torch import FitConfig
        from tpusysbio_torch.fit import TwoPhaseDriver

        self.ctx = ctx
        tr = ctx.traffic
        if tr["polish_iters"] != 1:
            raise ValueError("the step check follows one polish iteration")
        self.dev = torch.device(ctx.device)
        self.tight, self.theta_true = ensemble_problem(ctx, tr["polish"])
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

    def unit(self, i):
        """Fits ``i * n`` to ``i * n + n - 1``, of ``n`` fits a unit."""
        n, rec = self.ctx.traffic["fits_per_unit"], self.ctx.recorder
        total, info = dict(attempted=0, failed=0, work=0), {}
        for k in range(1 if rec is not None and rec.cur["profiled"] else n):
            out = super().unit(i * n + k)
            for key in total:
                total[key] += out[key]
            if rec is not None:
                for key, v in rec.cur["info"].items():
                    info[key] = info.get(key, 0) + v
        if rec is not None:
            rec.cur["info"].update(info)
        return total

    def checks(self):
        from portbench.reference import lm
        from portbench.reference.jakstat import residual_job

        tr = self.ctx.traffic
        k, lam = tr["top_k"], tr["lam0"]
        miss = 0
        for kept in self.kept:
            s = kept["screen"]
            bad = (s["status"] < 0) | ~np.isfinite(s["cost"])
            order = np.argsort(np.where(bad, np.inf, s["cost"]),
                               kind="stable")
            top = s["theta"][order[:k]]
            miss += int(np.sum(np.any(top != kept["polish"]["theta0"],
                                      axis=1)))

        spec = self.ctx.cfg["ensemble"]
        data = harness.load_json(harness.HERE / "data" / spec["data"])

        def solve(thetas, with_jac, sens_dtype=None):
            return _common.parallel(residual_job, [
                (spec, data, th, with_jac, sens_dtype) for th in thetas])

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
