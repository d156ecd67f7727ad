"""The headline benchmark of the port: the contract of the root ``bench.py``.

Stiff ODE integrations with all forward sensitivities per second on one
card: MAPK-22 (22 species, 30 rate constants, 682 augmented states a
member), rtol=1e-6, atol=1e-9, ``t_span`` (0, 100), a batch of members
``p_true * exp(N(0, 0.1))`` drawn on the host from ``default_rng(0)``.
The knobs and their defaults are the reference's, read from the
environment when :func:`main` runs:

    TPUSYSBIO_BENCH_BATCH (256), _REPEATS (3), _SOLVER ('pallas'),
    _SENS_PREC ('f32'), _STEPPER ('bdf'), _NT (41), _DENSE_WINDOW (0)

Run on the card (``--cpu`` on the CLI, ``device="cpu"`` here, asks for
the CPU):

    python -m tpusysbio_torch.cli bench
    python -m tpusysbio_torch.bench

It prints one JSON line with the reference's keys. ``detail`` holds:

- ``compile_seconds``: the first call, a warm-up that on a cold build
  directory also builds the CUDA kernels with ``nvcc``;
- ``compile_cache_hit``: whether ``linalg/_build.py`` found the kernel
  library already built (None on the CPU, where no kernel runs);
- ``best_batch_seconds``: the best of ``REPEATS`` calls, each ending in
  ``torch.cuda.synchronize()`` on the card;
- ``ok_members``: members that finished with status 1 (the others are
  counted out, never dropped); ``backend``: ``"cuda"`` or ``"cpu"``;
  ``mean_nsteps``.

``vs_baseline`` divides the rate by the single-core SciPy rate of
``bench/baselines/cpu_baseline.json`` (read, never written).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from tpusysbio_torch import resolve_device
from tpusysbio_torch.config import SolverConfig

T_SPAN = (0.0, 100.0)
BASELINE = (Path(__file__).resolve().parents[1] / "bench" / "baselines"
            / "cpu_baseline.json")


def knobs() -> dict:
    """The ``TPUSYSBIO_BENCH_*`` settings, with the reference's defaults."""
    env = os.environ.get
    return dict(batch=int(env("TPUSYSBIO_BENCH_BATCH", "256")),
                repeats=int(env("TPUSYSBIO_BENCH_REPEATS", "3")),
                solver=env("TPUSYSBIO_BENCH_SOLVER", "pallas"),
                sens_prec=env("TPUSYSBIO_BENCH_SENS_PREC", "f32"),
                stepper=env("TPUSYSBIO_BENCH_STEPPER", "bdf"),
                n_t=int(env("TPUSYSBIO_BENCH_NT", "41")),
                dense_window=int(env("TPUSYSBIO_BENCH_DENSE_WINDOW", "0")))


def members(p_true: np.ndarray, batch: int) -> np.ndarray:
    """``bench.py``'s members: a seed-0 log-normal spread, f64 on the
    host."""
    rng = np.random.default_rng(0)
    return p_true[None, :] * np.exp(
        rng.normal(scale=0.1, size=(batch, p_true.shape[0])))


def main(device="cuda") -> dict:
    """Run the benchmark, print its JSON line and return it as a dict."""
    from tpusysbio_torch.linalg import _build
    from tpusysbio_torch.model import library

    dev = resolve_device(device)
    k = knobs()
    model = library.mapk_huang_ferrell(device=dev)
    p_true = library.mapk_true_params(device="cpu").numpy()
    ps = torch.as_tensor(members(p_true, k["batch"]), device=dev)
    t_eval = torch.linspace(*T_SPAN, k["n_t"], dtype=torch.float64,
                            device=dev)
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=1024,
                       linear_solver=k["solver"],
                       sens_precision=k["sens_prec"], dense_f32=True,
                       dense_window=k["dense_window"])

    def run():
        res = model.simulate_sensitivities(ps, T_SPAN, t_eval,
                                           solver=k["stepper"], config=cfg,
                                           device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res

    cache_hit = (_build.library_path().exists() if dev.type == "cuda"
                 else None)
    t0 = time.perf_counter()
    out = run()
    compile_s = time.perf_counter() - t0
    n_ok = int((out.status == 1).sum())

    times = []
    for _ in range(k["repeats"]):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    rate = k["batch"] / best

    vs = None
    if BASELINE.exists():
        with open(BASELINE) as fh:
            vs = rate / json.load(fh)["integrations_per_sec"]

    rec = {
        "metric": "stiff ODE+sensitivity integrations/sec/chip (MAPK-22, "
                  f"30-param fwd sens, {k['stepper']} rtol=1e-6)",
        "value": round(rate, 3),
        "unit": "integrations/sec/chip",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "detail": {
            "batch": k["batch"], "best_batch_seconds": round(best, 3),
            "compile_seconds": round(compile_s, 1),
            "compile_cache_hit": cache_hit,
            "ok_members": n_ok, "backend": dev.type,
            "mean_nsteps": float(out.nsteps.cpu().numpy().mean()),
        },
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
