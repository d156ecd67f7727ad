#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusysbio_torch``) on one GPU.

Usage, from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tpusysbio_torch/linalg/csrc/``
(``nvcc`` at first use), then runs these phases and exits non-zero on the
first failed check:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: the kernels' build time and the compiler's register report;
3. K1 (``gj_inverse_f32``) against its plain PyTorch version on MAPK-22
   Newton matrices ``I - cJ`` (B=256, n=22), on random Newton-shaped
   matrices at n=64, and ``inverse()`` through block-Schur at n=97;
4. K2 (``refine_solve``) against its plain version and against
   ``torch.linalg.solve`` at B=256, n=22 and n=64, f64;
5. the main path: the ``bench.py`` contract (MAPK-22, BDF with all 30
   forward sensitivities, rtol=1e-6, atol=1e-9, ``sens_precision='f32'``,
   ``dense_f32``, ``linear_solver='pallas'``, 41-point ``t_eval``, 256
   members with a seed-0 log-normal parameter spread) through
   ``OdeModel.simulate_sensitivities``; all members must finish, both
   kernels' launch counters must rise, 4 members re-run on the CPU must
   agree, and the golden MAPK-22 sensitivity fixture must hold on the card.

The lines before the last are a ``{"kernels": [...]}`` JSON object (per
kernel: launches on the main path, error against its plain version, its
time, the plain version's, the least time the card could take and the
library call's) and the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``. Library calls (``torch.linalg.inv``,
``torch.linalg.solve``) are timed here as yardsticks only; the port never
calls them.

``python3 chip_smoke.py --profile`` adds one main-path batch under
``torch.profiler``: its device-busy share, the number of device kernels
and the device time by kernel name.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM rate, and the
# non-tensor-core f32 and f64 rates that these scalar kernels can use.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12

BATCH = 256
T_SPAN = (0.0, 100.0)
N_T = 41


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, t_ops: float):
    """The least time of the work in ms: bytes over the HBM rate, or
    ``t_ops`` (operations over their type's peak rate, in s)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def newton_matrices(model, rng, batch, c=1e-3):
    """MAPK-22 Newton matrices I - cJ at random states and parameters."""
    import torch

    from tpusysbio_torch.model import library

    p_true = library.mapk_true_params(device="cuda")
    p = p_true[None] * torch.as_tensor(
        np.exp(rng.normal(scale=0.1, size=(batch, 30))), device="cuda")
    y = torch.as_tensor(rng.uniform(0.0, 1.2, size=(batch, 22)),
                        device="cuda")
    J = model.rhs_jac(torch.zeros(batch, dtype=torch.float64,
                                  device="cuda"), y, p)
    return torch.eye(22, dtype=torch.float64, device="cuda") - c * J


def random_newton(rng, batch, n, scale=0.08):
    import torch

    return torch.as_tensor(np.eye(n)[None]
                           - scale * rng.standard_normal((batch, n, n)),
                           device="cuda")


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    card = out.stdout.strip().splitlines()[0]
    print(f"[device] {card}", flush=True)
    return card


def phase_build():
    from tpusysbio_torch.linalg import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {secs:.2f} s "
          f"(cached={_build.build_info.get('cached')})", flush=True)
    for line in _build.build_info.get("log", "").splitlines():
        if line.startswith("==") or "registers" in line or "Compiling" in line:
            print(f"[build]   {line.strip()}")
    return secs


def phase_k1(model, rng):
    import torch

    from tpusysbio_torch.linalg import gpu_lu

    rows = {}
    a22 = newton_matrices(model, rng, BATCH)
    a64 = random_newton(rng, BATCH, 64)
    a97 = random_newton(rng, 16, 97, scale=0.05)
    for name, a in (("n22", a22), ("n64", a64)):
        a32 = a.to(torch.float32).contiguous()
        got = gpu_lu.gj_inverse_f32(a32)
        ref = gpu_lu.gj_inverse_f32_plain(a32)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        rel = float((got - ref).abs().max() / ref.abs().max())
        abs_err = float((got - ref).abs().max())
        check(rel <= 1e-4, f"K1 {name}: rel diff from plain {rel:.3e} > 1e-4")
        x = gpu_lu.inverse(a)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device="cuda")
        res = float((x @ a - eye).abs().sum(-1).max())
        check(res < 1e-11, f"K1 {name}: ||XA - I||inf {res:.3e} >= 1e-11")
        rows[name] = dict(rel=rel, abs=abs_err, resid=res)
        print(f"[K1] {name}: B={a.shape[0]} rel diff from plain {rel:.3e} "
              f"(bound 1e-4); inverse() ||XA-I||inf {res:.3e} (bound 1e-11)",
              flush=True)
    x = gpu_lu.inverse(a97)
    eye = torch.eye(97, dtype=torch.float64, device="cuda")
    res = float((x @ a97 - eye).abs().sum(-1).max())
    check(res < 1e-11, f"K1 n97 Schur: ||XA - I||inf {res:.3e} >= 1e-11")
    print(f"[K1] n97 (block-Schur, K1 on both blocks): B=16 "
          f"||XA-I||inf {res:.3e} (bound 1e-11)", flush=True)

    # timing at the main path's shape
    a32 = a22.to(torch.float32).contiguous()
    n = 22
    ms = cuda_ms(lambda: gpu_lu.gj_inverse_f32(a32), reps=200)
    plain_ms = cuda_ms(lambda: gpu_lu.gj_inverse_f32_plain(a32), reps=10)
    lib_ms = cuda_ms(lambda: torch.linalg.inv(a32), reps=200)
    nbytes = 2 * BATCH * n * n * 4
    ops = BATCH * n * (2 * n + 4 * n * (n - 1))
    b_ms, b_by = bound_ms(nbytes, ops / F32_FLOPS)
    print(f"[K1] B={BATCH} n=22: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.linalg.inv {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})",
          flush=True)
    return dict(name="gj_inverse_f32", route="cuda",
                source="tpusysbio_torch/linalg/csrc/gj_inverse.cu",
                replaces="tpusysbio/linalg/pallas_lu.py:104",
                max_abs_err=rows["n22"]["abs"], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def phase_k2(model, rng):
    import torch

    from tpusysbio_torch.linalg import gpu_lu

    out = {}
    for n in (22, 64):
        a = (newton_matrices(model, rng, BATCH) if n == 22
             else random_newton(rng, BATCH, n))
        b = torch.as_tensor(rng.standard_normal((BATCH, n)), device="cuda")
        x32 = gpu_lu.inverse(a.to(torch.float32))
        got = gpu_lu.refine_solve(x32, a, b)
        ref = gpu_lu.refine_solve_plain(x32, a, b)
        lib = torch.linalg.solve(a, b)
        torch.cuda.synchronize()
        rel_lib = float(((got - lib).abs() / lib.abs().clamp_min(1e-30))
                        .max())
        rel_plain = float((got - ref).abs().max() / ref.abs().max())
        check(rel_lib < 1e-9,
              f"K2 n={n}: rel err vs torch.linalg.solve {rel_lib:.3e}")
        check(rel_plain <= 1e-12,
              f"K2 n={n}: rel diff from plain {rel_plain:.3e} > 1e-12")
        print(f"[K2] n={n}: B={BATCH} rel err vs torch.linalg.solve "
              f"{rel_lib:.3e} (bound 1e-9), vs plain {rel_plain:.3e} "
              f"(bound 1e-12)", flush=True)
        out[n] = (x32, a, b, float((got - ref).abs().max()))
    n = 22
    x32, a, b, abs_err = out[n]
    ms = cuda_ms(lambda: gpu_lu.refine_solve(x32, a, b), reps=200)
    plain_ms = cuda_ms(lambda: gpu_lu.refine_solve_plain(x32, a, b),
                       reps=50)
    lib_ms = cuda_ms(lambda: torch.linalg.solve(a, b), reps=50)
    nbytes = BATCH * (n * n * 4 + n * n * 8 + 2 * n * 8)
    # 4 f32 mat-vecs at the f32 rate, 3 f64 mat-vecs at the f64 rate
    t_ops = BATCH * 2 * n * n * (4 / F32_FLOPS + 3 / F64_FLOPS)
    b_ms, b_by = bound_ms(nbytes, t_ops)
    print(f"[K2] B={BATCH} n=22: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.linalg.solve {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by})", flush=True)
    return dict(name="refine_solve", route="cuda",
                source="tpusysbio_torch/linalg/csrc/refine_solve.cu",
                replaces="tpusysbio/linalg/pallas_lu.py:492",
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def phase_main_path():
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    model = library.mapk_huang_ferrell(device="cuda")
    p_true = library.mapk_true_params(device="cuda").cpu().numpy()
    rng = np.random.default_rng(0)
    ps = p_true[None, :] * np.exp(rng.normal(scale=0.1,
                                             size=(BATCH, p_true.shape[0])))
    t_eval = np.linspace(*T_SPAN, N_T)
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=1024,
                       linear_solver="pallas", sens_precision="f32",
                       dense_f32=True)

    def run():
        res = model.simulate_sensitivities(ps, T_SPAN, t_eval, config=cfg,
                                           device="cuda")
        torch.cuda.synchronize()
        return res

    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    res = run()
    first_s = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    status = res.status.cpu().numpy()
    n_ok = int((status == 1).sum())
    check(n_ok == BATCH, f"main path: {n_ok}/{BATCH} members status == 1")
    for k, v in launches.items():
        check(v > 0, f"main path: kernel {k} was never launched")
    check(tuple(res.ys.shape) == (BATCH, N_T, 22)
          and tuple(res.sens.shape) == (BATCH, N_T, 22, 30),
          f"main path: shapes {tuple(res.ys.shape)}, {tuple(res.sens.shape)}")
    check(bool(torch.isfinite(res.ys).all() and torch.isfinite(res.sens)
               .all()), "main path: non-finite outputs")
    nsteps = res.nsteps.cpu().numpy()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"[main] {n_ok}/{BATCH} members status == 1; mean_nsteps "
          f"{nsteps.mean():.2f}; launches {launches}; first batch "
          f"{first_s:.3f} s; best of 3 {best:.3f} s "
          f"({[round(t, 3) for t in times]}); {BATCH / best:.1f} "
          f"integrations/s", flush=True)

    # 4 members again on the CPU, where the kernels' plain versions run
    cpu_model = library.mapk_huang_ferrell(device="cpu")
    ref = cpu_model.simulate_sensitivities(ps[:4], T_SPAN, t_eval,
                                           config=cfg, device="cpu")
    ys, ys_ref = res.ys[:4].cpu().numpy(), ref.ys.numpy()
    sens, sens_ref = res.sens[:4].cpu().numpy(), ref.sens.numpy()
    ys_rel = float(np.max(np.abs(ys - ys_ref)) / np.max(np.abs(ys_ref)))
    sens_rel = float(np.max(np.abs(sens - sens_ref))
                     / np.max(np.abs(sens_ref)))
    ns_cpu = ref.nsteps.numpy()
    ns_dev = np.abs(nsteps[:4] - ns_cpu) / ns_cpu
    print(f"[main] CPU cross-check of 4 members: ys rel {ys_rel:.3e} "
          f"(bound 1e-7), sens rel {sens_rel:.3e} (bound 1e-4), nsteps "
          f"gpu {nsteps[:4].tolist()} cpu {ns_cpu.tolist()}", flush=True)
    check(bool((ref.status == 1).all()), "CPU cross-check: status")
    check(ys_rel <= 1e-7, f"CPU cross-check: ys rel {ys_rel:.3e} > 1e-7")
    check(sens_rel <= 1e-4,
          f"CPU cross-check: sens rel {sens_rel:.3e} > 1e-4")
    check(bool((ns_dev <= 0.05).all()),
          f"CPU cross-check: nsteps differ by more than 5%: {ns_dev}")

    # the golden SciPy fixture (tests/golden/mapk22_sens.npz) on the card,
    # with the reference's own bounds for the bench knobs
    g = np.load(os.path.join(ROOT, "tests", "golden", "mapk22_sens.npz"))
    gres = model.simulate_sensitivities(g["p"][None], tuple(g["t_span"]),
                                        g["t_eval"], config=cfg,
                                        device="cuda")
    traj = float(np.max(np.abs(gres.ys[0].cpu().numpy() - g["ys"]))
                 / np.max(np.abs(g["ys"])))
    gsens = float(np.max(np.abs(gres.sens[0].cpu().numpy() - g["sens"]))
                  / np.max(np.abs(g["sens"])))
    print(f"[main] golden mapk22_sens on the card: trajectory {traj:.3e} "
          f"(bound 2e-6), sens {gsens:.3e} (bound 5e-5)", flush=True)
    check(int(gres.status[0]) == 1, "golden: status")
    check(traj < 2e-6 and gsens < 5e-5, "golden: bounds")
    return launches, run


def phase_profile(run):
    """One main-path batch under torch.profiler: device-busy share,
    device kernels per batch and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name = {}
    for e in events:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    print(f"[profile] one batch: wall {wall:.3f} s, device kernels "
          f"{len(events)}, device busy {busy_us / 1e6:.3f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall; idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%)", flush=True)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {tot / 1e3:9.2f} ms {cnt:7d}x  {name[:90]}")


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "tpusysbio_torch")):
        fail("tpusysbio_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import tpusysbio_torch  # noqa: F401  (sets true-f32 matmuls)
    from tpusysbio_torch.model import library

    card = phase_device()
    phase_build()
    model = library.mapk_huang_ferrell(device="cuda")
    rng = np.random.default_rng(1234)
    k1 = phase_k1(model, rng)
    k2 = phase_k2(model, rng)
    launches, run = phase_main_path()
    if "--profile" in sys.argv[1:]:
        phase_profile(run)
    k1["launches"] = launches["gj_inverse_f32"]
    k2["launches"] = launches["refine_solve"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in (k1, k2)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
