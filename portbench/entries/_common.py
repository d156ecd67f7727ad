"""Helpers the entries share: which results to keep and check, the
reference solves in worker processes, and the scaled errors compared."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from portbench.harness import sub_seed

MAX_WORKERS = 6


def pick(seed, unit, ok, nsteps, k):
    """Members of one unit to keep for the check: the one with status 1
    that took the most steps, and ``k - 1`` more drawn from (seed,
    unit)."""
    ok_idx = np.flatnonzero(ok)
    if not len(ok_idx):
        return []
    steps = nsteps.cpu().numpy()[ok_idx]
    first = int(ok_idx[int(np.argmax(steps))])
    rest = ok_idx[ok_idx != first]
    rng = np.random.default_rng(sub_seed(seed, "keep", unit))
    more = rng.choice(rest, size=min(k - 1, len(rest)), replace=False)
    return [first] + [int(j) for j in more]


def sample(kept, seed, n):
    """At most ``n`` of the kept results: the one that took the most
    steps, and the rest drawn from the seed."""
    if not kept:
        return []
    first = max(range(len(kept)), key=lambda i: kept[i]["nsteps"])
    rest = [i for i in range(len(kept)) if i != first]
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    more = rng.choice(rest, size=min(n - 1, len(rest)), replace=False) \
        if rest else []
    return [kept[first]] + [kept[int(i)] for i in more]


def parallel(fn, jobs):
    """``[fn(*job) for job in jobs]``, in spawned worker processes; ``fn``
    is a module-level function. Every worker has ended on return."""
    if len(jobs) <= 1:
        return [fn(*job) for job in jobs]
    # one thread a worker: the workers' small matrices gain nothing from
    # a BLAS pool, and several pools would fight over the cores
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(MAX_WORKERS, len(jobs)),
                             mp_context=ctx) as pool:
        futures = [pool.submit(fn, *job) for job in jobs]
        return [f.result() for f in futures]


def scaled_err(got, ref, axes):
    """``max |got - ref| / scale``, the scale being ``max |ref|`` over
    ``axes`` (each species' own size), floored at 1e-12 of the largest."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.max(np.abs(ref), axis=axes, keepdims=True)
    scale = np.maximum(scale, 1e-12 * np.max(np.abs(ref)) + 1e-300)
    return float(np.max(np.abs(got - ref) / scale))


def worst(values):
    """The largest of ``values``; infinite when nothing was checked or
    a value is not finite."""
    vals = list(values)
    if not vals or not all(np.isfinite(v) for v in vals):
        return float("inf")
    return float(max(vals))


def limited(cell, **values):
    """Each compared number beside the cell's limit for it."""
    return {name: {"value": float(v), "limit": float(cell["limits"][name])}
            for name, v in values.items()}


def fit_problem(ctx, solver_key):
    """The configuration's fit problem as a ``Project`` of the port: the
    stored data (``portbench/data``), the free rate constants shared and
    fitted in log space, the others fixed at their true values. Returns
    the project and ``theta_true``."""
    import torch

    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.project import ParameterMap, Project

    from portbench.harness import HERE, load_json

    cfg, dev = ctx.cfg, torch.device(ctx.device)
    data = load_json(HERE / "data" / cfg["fit"]["data"])
    model = ctx.model()
    t = np.asarray(data["times"])
    values = np.asarray(data["values"])
    meas = tuple(Measurement(obs_index=i, times=t, values=values[:, i],
                             sigmas=np.full(len(t), data["sigma"]))
                 for i in range(values.shape[1]))
    batch = ExperimentBatch.from_experiments([Experiment("base", meas)],
                                             device=dev)
    names = list(model.param_names)
    rates = dict(zip(names, cfg["network"]["rates"]))
    free = cfg["fit"]["free"]
    fixed = {n: v for n, v in rates.items() if n not in free}
    pmap = ParameterMap.create(names, 1, shared=tuple(free), fixed=fixed,
                               device=dev)
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=ctx.solver_config(solver_key))
    theta_true = torch.log(torch.as_tensor([rates[n] for n in free],
                                           dtype=torch.float64, device=dev))
    return proj, theta_true


def residual_jobs(cfg, thetas, with_jac, sens_dtype=None):
    """Reference jobs for the residuals (and Jacobians) at ``thetas``."""
    from portbench.harness import HERE, load_json

    spec = cfg["network"]
    fit = cfg["fit"]
    data = load_json(HERE / "data" / fit["data"])
    return [(spec, fit["free"], data, th, with_jac, sens_dtype)
            for th in thetas]


def host(x):
    """A tensor or array as a numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
