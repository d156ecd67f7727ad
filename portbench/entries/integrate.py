"""Entry ``integrate``: ``OdeModel.simulate_sensitivities`` over batches
of members, back to back.

A unit is one batch: ``traffic.batch`` members ``k_true * exp(sd * z)``,
``z ~ N(0, 1)`` per rate constant, drawn on the device from (seed, unit
index); trajectories and sensitivities to every rate constant at
``traffic.n_t`` times over ``traffic.t_span``, with the configuration's
solver ``traffic.solver``. Work is a member integrated with status 1.

Checked: ``ys`` and ``sens`` of a sample of the members the window
integrated, against the plain reference: ``traj_err``, the largest error
of a state or a sensitivity over the size of its species (the state's
largest value; the species' largest sensitivity to any rate constant).
"""

from __future__ import annotations

from portbench.entries import _common
from portbench.harness import sub_seed


class Entry:
    rate_metric = "integrations_per_s"

    def __init__(self, ctx):
        import torch

        self.ctx = ctx
        tr = ctx.traffic
        self.dev = torch.device(ctx.device)
        self.model = ctx.model()
        self.config = ctx.solver_config(tr["solver"])
        self.k_true = torch.as_tensor(ctx.cfg["network"]["rates"],
                                      dtype=torch.float64, device=self.dev)
        self.t_span = tuple(float(x) for x in tr["t_span"])
        self.t_eval = torch.linspace(*self.t_span, tr["n_t"],
                                     dtype=torch.float64, device=self.dev)
        self.kept = []

    def members(self, i):
        import torch

        g = torch.Generator(device=self.dev)
        g.manual_seed(sub_seed(self.ctx.seed, "members", i))
        z = torch.randn((self.ctx.traffic["batch"], self.k_true.shape[0]),
                        generator=g, dtype=torch.float64, device=self.dev)
        return self.k_true * torch.exp(self.ctx.traffic["log_sd"] * z)

    def _run(self, ps, config):
        return self.model.simulate_sensitivities(
            ps, self.t_span, self.t_eval, solver=self.ctx.traffic["stepper"],
            config=config, device=self.dev)

    def warmup(self):
        """The window's shapes (the same batch, grid and solver) over a
        few steps: every kernel the window launches is built and
        loaded."""
        import dataclasses

        short = dataclasses.replace(
            self.config, max_steps=self.ctx.traffic["warmup_max_steps"])
        self._run(self.members(-1), short)

    def unit(self, i):
        ps = self.members(i)
        res = self._run(ps, self.config)
        status = res.status.cpu().numpy()
        ok = status == 1
        for j in _common.pick(self.ctx.seed, i, ok, res.nsteps,
                              self.ctx.traffic["keep_per_unit"]):
            self.kept.append(dict(
                unit=i, member=int(j), nsteps=int(res.nsteps[j]),
                p=ps[j].cpu().numpy(), ys=res.ys[j].cpu().numpy(),
                sens=res.sens[j].cpu().numpy()))
        B = len(status)
        return dict(attempted=B, failed=int(B - ok.sum()),
                    work=int(ok.sum()))

    def rate(self, totals):
        """The rate of the window's work and its unit."""
        return totals["work"] / totals["seconds"], "integrations/s"

    def free(self):
        import torch

        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self):
        from portbench.reference.solve import solve_job

        spec = self.ctx.cfg["network"]
        sample = _common.sample(self.kept, self.ctx.seed,
                                self.ctx.traffic["check_members"])
        t_eval = self.t_eval.cpu().numpy()
        jobs = [(spec, it["p"], self.t_span, t_eval) for it in sample]
        if self.ctx.control == "bf16":
            jobs += [(spec, it["p"], self.t_span, t_eval, None, "bfloat16")
                     for it in sample]
        out = _common.parallel(solve_job, jobs)
        refs = out[:len(sample)]
        got = (out[len(sample):] if self.ctx.control == "bf16"
               else [(it["ys"], it["sens"]) for it in sample])
        traj_err = _common.worst(
            max(_common.scaled_err(g[0], r[0], axes=(0,)),
                _common.scaled_err(g[1], r[1], axes=(0, 2)))
            for g, r in zip(got, refs))
        return _common.limited(self.ctx.cell, traj_err=traj_err)
