"""Command-line interface of the port, after ``tpusysbio/cli.py``.

The same subcommands, flags and printed JSON keys as the reference:

    python -m tpusysbio_torch.cli simulate   --model mapk22 --t-end 100
    python -m tpusysbio_torch.cli sens       --model lotka
    python -m tpusysbio_torch.cli fit        --example jakstat
    python -m tpusysbio_torch.cli multistart --config configs/mm3.yaml
    python -m tpusysbio_torch.cli profile    --model mm3
    python -m tpusysbio_torch.cli sample     --model mm3
    python -m tpusysbio_torch.cli bench

It runs on the GPU; ``--cpu`` asks for the CPU, and without CUDA and
without ``--cpu`` it raises. Every call returns, besides what it prints, a
dict of its results for callers in the same process.

Differences from the reference:

- the multi-start starts come from ``fit.latin_hypercube`` with a
  ``torch.Generator`` seeded by ``--seed``, so they differ from the JAX
  CLI's ``PRNGKey`` stream (so do the ``fit --example jakstat`` starts);
- ``--profile DIR`` writes a ``torch.profiler`` trace, ``DIR/trace.json``,
  and the port's own spans (``tpusysbio_torch/trace.py``: the stepper's
  trips by phase, its host reads, ``Project``'s evaluations, LM's
  iterations) as Chrome trace events, ``DIR/spans.json``, on the same time
  axis: open both in Perfetto to see which phase issued each operation;
- ``fit --max-iter N`` caps the example's LM iterations per start (by
  default the example's own, the reference's fixed number);
- a config's ``mesh:`` section spans the ranks of a ``torchrun`` launch
  (``torchrun --nproc_per_node=K -m tpusysbio_torch.cli multistart
  --config ...``: one process per rank, ``utils.make_mesh``); rank 0
  alone prints and writes ``--out`` and ``--plot`` files. Started as one
  process it runs unsharded (what a one-device mesh computes) and says so
  on stderr;
- ``sample``'s chain takes its draws from a ``torch.Generator`` seeded by
  ``--seed`` (its walkers start from the reference's numpy ball, so they
  equal the JAX CLI's; the chains differ);
- ``--plot PREFIX`` (``multistart``, ``profile``) writes the reference's
  PNG files through ``viz.py``; without matplotlib it raises the
  ``ImportError`` naming it before any fit runs;
- ``bench`` runs the root ``bench.py``'s contract through the port
  (``tpusysbio_torch/bench.py``), on the card or, with ``--cpu``, on the
  CPU, and prints the reference's JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

from tpusysbio_torch import resolve_device


def _models():
    """Model name -> (constructor taking ``device=``, true parameters as a
    numpy array)."""
    from tpusysbio_torch.model import library

    return {
        "mm3": (library.michaelis_menten, library.MM_TRUE_PARAMS),
        "lotka": (library.lotka_volterra, library.LV_TRUE_PARAMS),
        "repressilator": (library.repressilator,
                          library.REPRESSILATOR_TRUE_PARAMS),
        "mapk22": (library.mapk_huang_ferrell,
                   library.mapk_true_params(device="cpu").numpy()),
        "jakstat": (library.jak_stat, library.JAKSTAT_TRUE_PARAMS),
        "egfr": (library.egfr_like,
                 library.egfr_true_params(device="cpu").numpy()),
    }


_MODEL_NAMES = ("mm3", "lotka", "repressilator", "mapk22", "jakstat",
                "egfr")

_FREE_PARAMS = {
    # identifiable free sets per canonical config; None = all
    "mm3": None,
    "lotka": None,
    "repressilator": None,
    "jakstat": ("k1", "k2", "k3", "k4"),
    "mapk22": "KKPP+K|KPase+KP",   # 12 MAPK-layer rate constants
    # receptor module + layer-0 kinase/phosphatase rates
    "egfr": "L+Rec|LR+A0_0|LR+A0_1|P0+A0_1",
}


def _device(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else "cuda")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _maybe_profile(trace_dir, device):
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from tpusysbio_torch import trace

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    first = len(trace.spans())
    with profile(activities=acts) as prof:
        yield
        _sync(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"torch.profiler trace written to {path}", file=sys.stderr)
    _write_spans(os.path.join(trace_dir, "spans.json"), path, first)


def _write_spans(path, profile_path, first):
    """The port's spans from span ``first`` on as Chrome trace events, on
    the time axis of the profiler's trace at ``profile_path`` (its
    ``baseTimeNanoseconds``, which the profiler writes near the top of
    the file)."""
    from tpusysbio_torch import trace

    with open(profile_path, "rb") as fh:
        head = fh.read(65536).decode("utf-8", "replace")
    found = re.search(r'"baseTimeNanoseconds":\s*(\d+)', head)
    base = int(found.group(1)) if found else 0
    with open(path, "w") as fh:
        json.dump({"traceEvents": trace.chrome_events(trace.spans(), base,
                                                      first),
                   "baseTimeNanoseconds": base,
                   "displayTimeUnit": "ms"}, fh)
    print(f"program spans written to {path}", file=sys.stderr)


def _report(res):
    rec = {k: int(getattr(res, k)[0]) for k in (
        "status", "nsteps", "naccepted", "nrejected", "nfev", "njev",
        "nlu")}
    print(json.dumps(rec))
    return rec


def _integrate(args, with_sens: bool):
    from tpusysbio_torch.config import SolverConfig

    dev = _device(args)
    build, p_true = _models()[args.model]
    model = build(device=dev)
    t_eval = np.linspace(0.0, args.t_end, args.n_times)
    cfg = SolverConfig(rtol=args.rtol, atol=args.atol,
                       max_steps=args.max_steps)
    run = model.simulate_sensitivities if with_sens else model.simulate
    with _maybe_profile(args.profile, dev):
        res = run(p_true[None], (0.0, args.t_end), t_eval, solver=args.solver,
                  config=cfg, device=dev)
        _sync(dev)
    return t_eval, res


def cmd_simulate(args):
    t_eval, res = _integrate(args, with_sens=False)
    rec = _report(res)
    ys = res.ys[0].cpu().numpy()
    if args.out:
        np.savez(args.out, t=t_eval, ys=ys)
        print(f"trajectory saved to {args.out}", file=sys.stderr)
    return {"record": rec, "ys": ys}


def cmd_sens(args):
    t_eval, res = _integrate(args, with_sens=True)
    rec = _report(res)
    ys, sens = res.ys[0].cpu().numpy(), res.sens[0].cpu().numpy()
    print(f"sens shape {tuple(sens.shape)}, "
          f"max |dy/dp| = {float(np.max(np.abs(sens))):.4g}")
    if args.out:
        np.savez(args.out, t=t_eval, ys=ys, sens=sens)
    return {"record": rec, "ys": ys, "sens": sens}


def cmd_fit(args):
    from tpusysbio_torch import examples

    dev = _device(args)
    depth = {} if args.max_iter is None else {"max_iter": args.max_iter}
    if args.example == "jakstat":
        return examples.jakstat_ensemble(device=dev, **depth)
    if args.example == "mm3":
        return examples.mm3_fit(device=dev, **depth)
    raise SystemExit(f"unknown fit example {args.example!r}")


def cmd_bench(args):
    from tpusysbio_torch import bench

    return {"record": bench.main(device=_device(args))}


def _synth_problem(args, device):
    """Synthetic estimation problem on a canonical config: simulate at the
    true parameters, add observation noise, free the model's usual
    estimation subset. Returns (model, batch, pmap, free, theta_true)."""
    from tpusysbio_torch.config import SolverConfig
    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.project import ParameterMap

    build, p_true = _models()[args.model]
    model = build(device=device)
    p_true = np.asarray(p_true)
    t = np.linspace(args.t_end / args.n_times, args.t_end, args.n_times)
    sim = model.simulate(p_true[None], (0.0, args.t_end), t,
                         config=SolverConfig(rtol=1e-9, atol=1e-12,
                                             max_steps=4096), device=device)
    p_rows = torch.as_tensor(p_true, device=device).expand(len(t), -1)
    obs = model.observables(sim.ys[0], p_rows).cpu().numpy()
    rng = np.random.default_rng(args.seed)
    sigma = args.noise * float(np.max(np.abs(obs)))
    data = obs + rng.normal(scale=sigma, size=obs.shape)
    meas = tuple(Measurement(obs_index=i, times=t, values=data[:, i],
                             sigmas=np.full(len(t), sigma))
                 for i in range(model.n_obs))
    batch = ExperimentBatch.from_experiments([Experiment("synth", meas)],
                                             device=device)

    free_spec = _FREE_PARAMS.get(args.model)
    if free_spec is None:
        free = list(model.param_names)
    elif isinstance(free_spec, str):
        prefixes = tuple(free_spec.split("|"))
        free = [n for n in model.param_names if n.startswith(prefixes)]
    else:
        free = list(free_spec)
    fixed = {n: p_true[model.param_names.index(n)]
             for n in model.param_names if n not in free}
    pmap = ParameterMap.create(model.param_names, 1, shared=tuple(free),
                               fixed=fixed, device=device)
    theta_true = pmap.pack(
        {n: p_true[model.param_names.index(n)] for n in free})
    return model, batch, pmap, free, theta_true


def _config_mesh(config, device):
    """The mesh of a config's ``mesh:`` section: over the process group of
    a ``torchrun`` launch (``WORLD_SIZE`` > 1; this process joins it here
    when no group exists yet), or None when it resolves to one rank.
    Returns ``(mesh, joined)``."""
    import torch.distributed as dist

    from tpusysbio_torch import utils

    if len(config.axis_names) != 1:
        raise ValueError("the ensemble mesh is 1-D; got axes "
                         f"{config.axis_names!r}")
    joined = (not dist.is_initialized()
              and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if joined:
        utils.distributed_initialize(
            backend="gloo" if device.type == "cpu" else None)
    if not dist.is_initialized():
        return None, False
    mesh = utils.make_mesh(config=config, device=device)
    return (mesh if mesh.size > 1 else None), joined


def cmd_multistart(args):
    """End-to-end two-phase multi-start pipeline on a canonical config:
    synthesize data at the true parameters + noise, screen a Latin-
    hypercube start cloud with the f32 stepper at loose rtol, polish the
    top fraction at reference accuracy, report ranked fits + 1σ bars."""
    from tpusysbio_torch.config import FitConfig, SolverConfig, load_config
    from tpusysbio_torch.fit import latin_hypercube, multistart_two_phase
    from tpusysbio_torch.project import Project

    runspec = None
    if getattr(args, "config", None):
        runspec = load_config(args.config)
        args.model = runspec.model
        for k, v in runspec.run.items():
            key = k.replace("-", "_")
            if not hasattr(args, key):
                raise SystemExit(f"config run key {k!r} is not a "
                                 "multistart setting")
            setattr(args, key, v)
    if args.plot:
        from tpusysbio_torch import viz

        viz._mpl()
    dev = _device(args)
    # join the group first: it pins this rank's card, and the problem is
    # built on the mesh's device
    mesh, joined = None, False
    if runspec is not None and runspec.mesh is not None:
        mesh, joined = _config_mesh(runspec.mesh, dev)
        if mesh is None:
            print("mesh: the config's mesh resolves to one device; running "
                  "unsharded, which is what a one-device mesh computes",
                  file=sys.stderr)
        else:
            dev = mesh.device
    # under a mesh every rank holds the whole result; rank 0 reports it
    quiet = mesh is not None and mesh.rank != 0

    model, batch, pmap, free, theta_true = _synth_problem(args, dev)

    if runspec is not None:
        tight_cfg = runspec.solver
        screen_cfg = runspec.screen_solver or dataclasses.replace(
            tight_cfg, rtol=1e-3, atol=1e-6, mixed_precision=True,
            sens_precision="full",
            max_steps=max(64, tight_cfg.max_steps // 4))
        polish_fit_cfg = runspec.fit
        screen_fit_cfg = runspec.screen_fit or dataclasses.replace(
            polish_fit_cfg, max_iter=args.screen_iters, ftol=1e-4,
            xtol=1e-4)
    else:
        tight_cfg = SolverConfig(rtol=args.rtol, atol=args.atol,
                                 max_steps=args.max_steps,
                                 linear_solver=args.linear_solver,
                                 sens_precision="f32")
        screen_cfg = SolverConfig(rtol=1e-3, atol=1e-6,
                                  max_steps=max(64, args.max_steps // 4),
                                  linear_solver=args.linear_solver,
                                  mixed_precision=True)
        polish_fit_cfg = FitConfig(max_iter=args.polish_iters,
                                   eval_mode="lockstep")
        screen_fit_cfg = FitConfig(max_iter=args.screen_iters,
                                   eval_mode="lockstep", ftol=1e-4,
                                   xtol=1e-4)
    proj_tight = Project(model=model, pmap=pmap, batch=batch,
                         config=tight_cfg)
    proj_screen = dataclasses.replace(proj_tight, config=screen_cfg)

    starts = latin_hypercube(torch.Generator().manual_seed(args.seed),
                             args.starts, theta_true - args.spread,
                             theta_true + args.spread)
    top_k = min(args.top_k, args.starts)
    t0 = time.perf_counter()
    with _maybe_profile(None if quiet else args.profile, dev):
        polish, screen = multistart_two_phase(
            (proj_screen.residuals, proj_screen.residuals_and_jacobian),
            (proj_tight.residuals, proj_tight.residuals_and_jacobian),
            starts, screen_fit_cfg, polish_fit_cfg,
            top_k=top_k, mesh=mesh, iter_chunk=args.iter_chunk)
        _sync(dev)
    wall = time.perf_counter() - t0
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()

    ranked = polish.ranked()
    cost_truth = float(proj_tight.cost(theta_true))
    cost = ranked.cost.cpu().numpy()
    rec = {
        "model": args.model, "free_params": len(free),
        "starts": args.starts, "top_k": top_k,
        "wall_seconds": round(wall, 1),
        "screen_finished": int((screen.status.cpu().numpy() >= 0).sum()),
        "best_cost": float(cost[0]),
        "cost_at_truth": round(cost_truth, 6),
        "top_costs": cost[:min(5, top_k)].round(4).tolist(),
    }
    theta = ranked.theta.cpu().numpy()
    sigma = ranked.param_sigma.cpu().numpy()
    out = {"record": rec, "wall": wall, "cost_at_truth": cost_truth,
           "polish": polish, "screen": screen, "starts": starts,
           "project": proj_tight, "screen_project": proj_screen,
           "theta_true": theta_true, "polish_config": polish_fit_cfg,
           "screen_config": screen_fit_cfg}
    if quiet:
        return out
    print(json.dumps(rec))
    for name, th, sg in zip(free, theta[0], sigma[0]):
        print(f"  {name:>16s}: {np.exp(th):.6g}  "
              f"(log-space 1σ {sg:.3g})")
    if args.out:
        np.savez(args.out, theta=theta, cost=cost,
                 status=ranked.status.cpu().numpy(), param_sigma=sigma,
                 free=np.asarray(free))
        print(f"ranked results saved to {args.out}", file=sys.stderr)
    if args.plot:
        from tpusysbio_torch import viz

        viz.plot_waterfall(screen).savefig(
            f"{args.plot}_waterfall.png", dpi=110)
        viz.plot_fit(proj_tight, ranked.theta[0]).savefig(
            f"{args.plot}_fit.png", dpi=110)
        print(f"plots saved to {args.plot}_waterfall.png / _fit.png",
              file=sys.stderr)
    return out


def cmd_profile(args):
    """Profile-likelihood identifiability analysis on a canonical config:
    fit the synthetic problem, then profile every free parameter around
    the optimum (fit/profile.py: the 2·P warm-started chains as one LM
    batch) and report likelihood-ratio confidence intervals."""
    from tpusysbio_torch.config import FitConfig, SolverConfig
    from tpusysbio_torch.fit import confidence_intervals, profile_likelihood
    from tpusysbio_torch.optim import lm_fit
    from tpusysbio_torch.project import Project

    if args.plot:
        from tpusysbio_torch import viz

        viz._mpl()
    dev = _device(args)
    model, batch, pmap, free, theta_true = _synth_problem(args, dev)
    cfg = SolverConfig(rtol=args.rtol, atol=args.atol,
                       max_steps=args.max_steps,
                       linear_solver=args.linear_solver,
                       sens_precision="f32")
    proj = Project(model=model, pmap=pmap, batch=batch, config=cfg)
    fit_cfg = FitConfig(max_iter=args.fit_iters, eval_mode="lockstep")

    t0 = time.perf_counter()
    fit = lm_fit(proj.residuals, proj.residuals_and_jacobian,
                 theta_true[None], fit_cfg)
    prof = profile_likelihood(
        proj.residuals, proj.residuals_and_jacobian, fit.theta[0],
        n_points=args.n_points, span=args.span, config=fit_cfg)
    _sync(dev)
    wall = time.perf_counter() - t0

    ci = confidence_intervals(prof, level=args.level)
    status = prof.status.cpu().numpy()
    rec = {
        "model": args.model, "free_params": len(free),
        "grid_points": int(prof.values.shape[1]),
        "wall_seconds": round(wall, 1),
        "fit_cost": float(fit.cost[0]),
        "unconverged_points": int((status <= 0).sum()),
        "level": args.level,
    }
    print(json.dumps(rec))
    theta_hat = fit.theta[0].cpu().numpy()
    for p, name in enumerate(free):
        lo, hi = ci[p]
        lo_s = f"{np.exp(lo):.4g}" if np.isfinite(lo) else "-inf"
        hi_s = f"{np.exp(hi):.4g}" if np.isfinite(hi) else "+inf"
        flag = "" if np.isfinite(lo) and np.isfinite(hi) else \
            "  [non-identifiable within span]"
        print(f"  {name:>16s}: {np.exp(theta_hat[p]):.6g}  "
              f"CI [{lo_s}, {hi_s}]{flag}")
    costs = prof.costs.cpu().numpy()
    if args.out:
        np.savez(args.out, idx=prof.idx, values=prof.values.cpu().numpy(),
                 costs=costs, thetas=prof.thetas.cpu().numpy(),
                 status=status, cost_opt=float(prof.cost_opt), ci=ci,
                 free=np.asarray(free))
        print(f"profile curves saved to {args.out}", file=sys.stderr)
    if args.plot:
        from tpusysbio_torch import viz

        viz.plot_profiles(prof, names=free, level=args.level).savefig(
            f"{args.plot}_profiles.png", dpi=110)
        print(f"plot saved to {args.plot}_profiles.png", file=sys.stderr)
    return {"record": rec, "wall": wall, "ci": ci, "costs": costs,
            "profile": prof, "theta_hat": theta_hat}


def cmd_sample(args):
    """Posterior sampling on a canonical config: fit the synthetic
    problem, then run ensemble MCMC (fit/mcmc.py, the emcee-style stretch
    move over lockstep walkers) from a ball around the optimum and report
    per-parameter posterior mean ± sigma."""
    from tpusysbio_torch.config import FitConfig, SolverConfig
    from tpusysbio_torch.fit import autocorr_time, ensemble_sample
    from tpusysbio_torch.optim import lm_fit
    from tpusysbio_torch.project import Project

    dev = _device(args)
    model, batch, pmap, free, theta_true = _synth_problem(args, dev)
    cfg = SolverConfig(rtol=args.rtol, atol=args.atol,
                       max_steps=args.max_steps,
                       linear_solver=args.linear_solver,
                       sens_precision="f32")
    proj = Project(model=model, pmap=pmap, batch=batch, config=cfg)
    fit_cfg = FitConfig(max_iter=args.fit_iters, eval_mode="lockstep")

    t0 = time.perf_counter()
    fit = lm_fit(proj.residuals, proj.residuals_and_jacobian,
                 theta_true[None], fit_cfg)
    rng = np.random.default_rng(args.seed)
    x0 = torch.as_tensor(fit.theta[0].cpu().numpy()
                         + args.init_ball * rng.normal(
                             size=(args.walkers, len(free))), device=dev)
    res = ensemble_sample(lambda th: -proj.cost(th), x0, args.steps,
                          torch.Generator().manual_seed(args.seed),
                          thin=args.thin)
    _sync(dev)
    wall = time.perf_counter() - t0

    burn = args.burn // args.thin
    samp = res.flat(burn=burn).cpu().numpy()
    tau = autocorr_time(res.chain[burn:])
    acc = res.acceptance.cpu().numpy()
    rec = {
        "model": args.model, "free_params": len(free),
        "walkers": args.walkers, "steps": args.steps,
        "kept_samples": int(samp.shape[0]),
        "wall_seconds": round(wall, 1),
        "fit_cost": float(fit.cost[0]),
        "mean_acceptance": round(float(acc.mean()), 3),
        "max_autocorr_time": round(float(tau.max()), 1),
    }
    print(json.dumps(rec))
    mu, sd = samp.mean(axis=0), samp.std(axis=0)
    for p, name in enumerate(free):
        print(f"  {name:>16s}: {np.exp(mu[p]):.6g}  "
              f"(x/÷ {np.exp(sd[p]):.4g}; τ={tau[p]:.1f})")
    chain, log_prob = res.chain.cpu().numpy(), res.log_prob.cpu().numpy()
    if args.out:
        np.savez(args.out, chain=chain, log_prob=log_prob, acceptance=acc,
                 free=np.asarray(free))
        print(f"chain saved to {args.out}", file=sys.stderr)
    return {"record": rec, "wall": wall, "fit": fit,
            "x0": x0.cpu().numpy(), "chain": chain, "log_prob": log_prob,
            "acceptance": acc, "tau": tau, "samples": samp,
            "project": proj}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpusysbio_torch")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the GPU")
    parser.add_argument("--x64", action="store_true", default=True,
                        help="float64 (always on in the port; kept for "
                             "the reference's command lines)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--model", default="mm3", choices=_MODEL_NAMES)
        p.add_argument("--solver", default="bdf",
                       choices=["auto", "adams", "bdf", "radau", "dopri5",
                                "rosenbrock"])
        p.add_argument("--t-end", type=float, default=10.0)
        p.add_argument("--n-times", type=int, default=21)
        p.add_argument("--rtol", type=float, default=1e-6)
        p.add_argument("--atol", type=float, default=1e-9)
        p.add_argument("--max-steps", type=int, default=2048)
        p.add_argument("--profile", metavar="DIR", default=None,
                       help="write a torch.profiler trace to DIR")
        p.add_argument("--out", default=None, help="save results to .npz")

    p_sim = sub.add_parser("simulate", help="integrate a canonical model")
    add_common(p_sim)
    p_sim.set_defaults(fn=cmd_simulate)

    p_sens = sub.add_parser("sens",
                            help="integrate with forward sensitivities")
    add_common(p_sens)
    p_sens.set_defaults(fn=cmd_sens)

    p_fit = sub.add_parser("fit", help="run a canonical fit example")
    p_fit.add_argument("--example", default="jakstat",
                       choices=["jakstat", "mm3"])
    p_fit.add_argument("--max-iter", type=int, default=None,
                       help="LM iterations per start (default: the "
                            "example's own)")
    p_fit.set_defaults(fn=cmd_fit)

    p_bench = sub.add_parser("bench", help="run the headline benchmark")
    p_bench.set_defaults(fn=cmd_bench)

    p_ms = sub.add_parser(
        "multistart",
        help="two-phase multi-start fit pipeline on a canonical config")
    p_ms.add_argument("--config", default=None, metavar="FILE",
                      help="YAML/JSON RunSpec (configs/ ships one per "
                           "canonical config); file settings override "
                           "flag defaults")
    p_ms.add_argument("--model", default="mapk22",
                      choices=list(_FREE_PARAMS.keys()))
    p_ms.add_argument("--starts", type=int, default=64)
    p_ms.add_argument("--top-k", type=int, default=8)
    p_ms.add_argument("--screen-iters", type=int, default=8)
    p_ms.add_argument("--polish-iters", type=int, default=20)
    p_ms.add_argument("--iter-chunk", type=int, default=8)
    p_ms.add_argument("--spread", type=float, default=1.0,
                      help="LHS half-width around truth, log space")
    p_ms.add_argument("--noise", type=float, default=0.02,
                      help="data noise as a fraction of max |obs|")
    p_ms.add_argument("--seed", type=int, default=0)
    p_ms.add_argument("--t-end", type=float, default=100.0)
    p_ms.add_argument("--n-times", type=int, default=12)
    p_ms.add_argument("--rtol", type=float, default=1e-6)
    p_ms.add_argument("--atol", type=float, default=1e-9)
    p_ms.add_argument("--max-steps", type=int, default=512)
    p_ms.add_argument("--linear-solver", default="pallas",
                      choices=["lu", "inv", "inv32", "pallas"])
    p_ms.add_argument("--profile", metavar="DIR", default=None)
    p_ms.add_argument("--out", default=None,
                      help="save ranked results to .npz")
    p_ms.add_argument("--plot", default=None, metavar="PREFIX",
                      help="save PREFIX_waterfall.png + PREFIX_fit.png")
    p_ms.set_defaults(fn=cmd_multistart)

    p_pl = sub.add_parser(
        "profile",
        help="profile-likelihood identifiability analysis on a canonical "
             "config (fit, then profile every free parameter)")
    p_pl.add_argument("--model", default="mm3",
                      choices=list(_FREE_PARAMS.keys()))
    p_pl.add_argument("--n-points", type=int, default=6,
                      help="grid points per direction")
    p_pl.add_argument("--span", type=float, default=1.0,
                      help="profile half-width in log space")
    p_pl.add_argument("--level", type=float, default=0.95,
                      help="confidence level for the LR intervals")
    p_pl.add_argument("--fit-iters", type=int, default=40)
    p_pl.add_argument("--noise", type=float, default=0.02)
    p_pl.add_argument("--seed", type=int, default=0)
    p_pl.add_argument("--t-end", type=float, default=10.0)
    p_pl.add_argument("--n-times", type=int, default=12)
    p_pl.add_argument("--rtol", type=float, default=1e-6)
    p_pl.add_argument("--atol", type=float, default=1e-9)
    p_pl.add_argument("--max-steps", type=int, default=512)
    p_pl.add_argument("--linear-solver", default="pallas",
                      choices=["lu", "inv", "inv32", "pallas"])
    p_pl.add_argument("--out", default=None,
                      help="save profile curves to .npz")
    p_pl.add_argument("--plot", default=None, metavar="PREFIX",
                      help="save PREFIX_profiles.png")
    p_pl.set_defaults(fn=cmd_profile)

    p_mc = sub.add_parser(
        "sample",
        help="posterior sampling via ensemble MCMC on a canonical config "
             "(fit, then emcee-style stretch-move walkers)")
    p_mc.add_argument("--model", default="mm3",
                      choices=list(_FREE_PARAMS.keys()))
    p_mc.add_argument("--walkers", type=int, default=32)
    p_mc.add_argument("--steps", type=int, default=400)
    p_mc.add_argument("--burn", type=int, default=100,
                      help="sweeps discarded before moments (pre-thin)")
    p_mc.add_argument("--thin", type=int, default=1)
    p_mc.add_argument("--init-ball", type=float, default=0.01,
                      help="walker init sigma around the optimum (log)")
    p_mc.add_argument("--fit-iters", type=int, default=40)
    p_mc.add_argument("--noise", type=float, default=0.02)
    p_mc.add_argument("--seed", type=int, default=0)
    p_mc.add_argument("--t-end", type=float, default=10.0)
    p_mc.add_argument("--n-times", type=int, default=12)
    p_mc.add_argument("--rtol", type=float, default=1e-6)
    p_mc.add_argument("--atol", type=float, default=1e-9)
    p_mc.add_argument("--max-steps", type=int, default=512)
    p_mc.add_argument("--linear-solver", default="pallas",
                      choices=["lu", "inv", "inv32", "pallas"])
    p_mc.add_argument("--out", default=None, help="save chain to .npz")
    p_mc.set_defaults(fn=cmd_sample)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
