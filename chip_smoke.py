#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpusysbio_torch``) on one GPU.

Usage, from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tpusysbio_torch/linalg/csrc/``
(``nvcc`` at first use), then runs these phases and exits non-zero on the
first failed check:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: the kernels' build time and the compiler's report per kernel
   (registers, stack, spills); a kernel that spills fails the run;
3. K1 (``gj_inverse_f32``, a matrix in a warp's registers) against its
   plain PyTorch version on MAPK-22 Newton matrices ``I - cJ`` at n=22
   and the batches the paths give it (B=256: the main path and the fit's
   screen; B=16: the fit's polish), on random Newton-shaped matrices at
   n=64, and ``inverse()`` through block-Schur at n=97; timed at B=16, 64,
   256 and 1024;
4. K2 (``refine_solve``) against its plain version and against
   ``torch.linalg.solve`` at n=22, B=256 (the main path) and B=16 (the
   fit's polish), and at n=64, f64; timed at B=16, 64, 256 and 1024;
5. K3 (the batch-major ``gj_inverse_f32``: a group of lanes per matrix,
   several matrices a warp) against the same plain version, and bit for
   bit against K1's output, at n=22, B=256, B=64 (the batch of phase 8),
   B=67 (a last warp with groups that have no matrix) and B=1024, at
   n=64, 33, 32 and 1, at the two block-Schur shapes of the 99-state
   model, (64, 64, 64) and (64, 35, 35), on general matrices that
   exchange rows, on tied pivots, through block-Schur at n=97 under the
   ``major`` layout, and on a NaN and a singular matrix; timed beside K1
   at B=64, 256, 1024 and 4096 and at the two block-Schur shapes; then
   the launch floor (``[floor]``): an empty kernel through the same launch
   route at grids of 16 and 256;
6. the main path of the first slice: the ``bench.py`` contract (MAPK-22,
   BDF with all 30 forward sensitivities, rtol=1e-6, atol=1e-9,
   ``sens_precision='f32'``, ``dense_f32``, ``linear_solver='pallas'``,
   41-point ``t_eval``, 256 members with a seed-0 log-normal parameter
   spread) through ``OdeModel.simulate_sensitivities``; all members must
   finish, K1's and K2's launch counters must rise, 4 members re-run on
   the CPU must agree, and the golden MAPK-22 sensitivity fixture must hold
   on the card;
7. the fit path: the MAPK-22 two-phase multi-start fit (12 free rate
   constants, 3 observables x 12 times; 256 Latin-hypercube starts
   screened by LM on the f32 stepper, the best 16 polished at rtol=1e-6)
   through ``Project`` and ``TwoPhaseDriver``; K1 and K2 must be launched,
   the screen and the polish (``FIT_POLISH_ITERS`` iterations) must give
   finite costs, the best polished cost must not exceed the cost at the
   true parameters, and a small run of the same two-phase fit on the CPU (the 4 best starts; 2 screening and 3
   polishing iterations, the polish from the card's screened points) must
   agree with the card;
8. the fit path's screening phase under ``TPUSYSBIO_GJ_LAYOUT=major``
   (64 starts, 2 iterations): K3 must be launched in K1's place and the
   costs must agree with the ``minor`` layout's;
9. the EGFR-scale path (``[egfr-sens]``): the 99-species, 146-constant
   receptor cascade with 11 free constants as ``bench/egfr_bench.py``
   builds it (data from an rtol=1e-8 simulation on the card), one batch of
   64 ``Project.evaluate(theta, with_jac=True)`` at rtol=1e-6 with the 11
   direction columns in f32; every factorization inverts the 99 x 99
   Newton matrix by block-Schur elimination, so K1 must be launched an even
   number of times, half at n=64 and half at n=35, and K2 not at all
   (n > 64); all members must finish without a NaN from the Schur guard, 2
   members re-run on the CPU must agree, and the golden EGFR trajectory
   must hold on the card;
10. the EGFR-scale fit (``[egfr-fit]``): 64 Latin-hypercube starts through
   ``make_multistart_runner(iter_chunk=2)``, ``EGFR_FIT_ITERS`` (1)
   lockstep LM iterations; at
   least 56 costs finite and the best no worse than at the true
   parameters;
11. one EGFR evaluation of 16 members under the ``major`` layout
   (``[egfr-major]``): K3 launched at both block shapes, K1 not, residuals
   and Jacobian equal to the ``minor`` run's bit for bit;
12. the small canonical models, whose sensitivities are jvp columns
   (``sens/forward.py``): ``[golden-small]``, ``simulate_sensitivities``
   on the card against the SciPy fixtures of MM-3, Lotka-Volterra, the
   repressilator and JAK-STAT (tests/test_sens.py's config and bound, the
   JAX package's step counts); ``[K1-small]``/``[K2-small]``, K1 and K2
   against their plain versions and timed beside ``torch.linalg`` at
   n = 2, 3, 4, 6 and B = 64, 256 on those models' Newton matrices;
13. the CLI in process (``tpusysbio_torch.cli.main``): ``[cli-mm3]``,
   ``[cli-repressilator]``, ``[cli-jakstat]``, ``[cli-mapk22]`` and
   ``[cli-egfr]`` run ``multistart --config configs/<name>.yaml`` at the
   run file's width (64/8, 64/8, 256/16, 1024/64, 64/8 starts/top_k) and
   the LM depth ``CLI_DEPTH``: best cost at most the cost at the true
   parameters, that cost equal to the JAX package's, K1 launched (at n=64
   and n=35 for EGFR's block-Schur inverse) and K2 with it (not at n=99),
   and the two best polish starts polished again on the CPU to the same
   cost; ``[jakstat-ensemble]`` runs ``fit --example jakstat --max-iter
   ENSEMBLE_ITERS`` twice (two doses, shared k1-k4, local amp, two scale
   groups): best cost at most the cost at truth, and the two runs bitwise
   equal; ``[profile-mm3]`` runs ``profile --model mm3 --n-points 3 --span
   0.5 --fit-iters PROFILE_FIT_ITERS``: every row's minimum at its center,
   the intervals the JAX CLI's. Each keeps its width and runs at the
   smallest LM depth at which these gates hold (see the constants); the
   ensemble's converged best fit (status > 0) needs its own depth,
   ``phase_jakstat_ensemble(card, None)``, as the multistart paths' own
   depth is ``phase_cli(name, card, tmpdir, None)`` and the profile's
   ``phase_profile_mm3(card, None)``: calls of their own;
14. timed inputs and pre-equilibration through ``Project``: ``[pulse]``,
   the stimulus-and-washout example (``examples.jakstat_pulse_*``: amp
   clamped to 1 at t=5 and to 0 at t=25, three segments), one evaluation
   with Jacobian at 256 Latin-hypercube θ under ``linear_solver='pallas'``
   (K1 and K2 launched, 2 members re-run on the CPU), then its LM fit from
   θ_true + 0.7 at ``PULSE_FIT_ITERS`` iterations against the JAX
   example's fit at that depth (``phase_pulse(card, None)``: the example's
   80, in a call of its own); ``[preeq]``, the two-experiment dose step of
   tests/test_events.py (one experiment pre-equilibrated by the
   steady-state solve, one not): the residuals at the true parameters
   against the exact solution, 64 θ with Jacobian (all statuses 1, K1 and
   K2 launched, 2 members re-run on the CPU).

15. bounded and robust fitting and ensemble MCMC: ``[fit-trf]``,
   ``multistart_trf`` on the tight MAPK-22 ``Project`` (K1 and K2) from
   phase 7's 16 screened points, bounded to θ_true ± 1, ``FIT_TRF_ITERS``
   TRF iterations, then 4 of them with ``subproblem='svd'`` and
   ``loss='soft_l1'``: every θ strictly inside the box, statuses ≥ 0, the
   best cost non-increasing, each run repeated on the CPU from the card's
   input points (statuses equal, costs within 1e-4) and the tight
   evaluation at the card's two best θ on the CPU (residuals 1e-7,
   Jacobian 1e-4); ``[sample-mm3]``, ``cli.main(["sample", "--model",
   "mm3", ...])`` at the CLI's 32 walkers, ``SAMPLE_STEPS`` sweeps and
   ``--fit-iters SAMPLE_FIT_ITERS``: the chain's shape, finite log-probs,
   ``fit_cost`` the JAX CLI's to 1e-6, K1 and K2 launched, and the same
   command with ``--cpu`` giving the same chain relative to its fit to
   1e-8 (the fits part by ~1e-5 along MM-3's k1/km1 valley, and every
   walker is an affine combination of the start walkers).

16. the other steppers and the BDF's channels
   (``phase_other_steppers``): ``[radau-mapk22]``, ``[rosenbrock-fit]``,
   ``[auto-mapk22]``, ``[explicit]``, ``[multishoot]``,
   ``[events-mapk22]``, ``[backward-mm3]``, ``[cli-solvers]``;

17. the model and data surfaces (``phase_surfaces``; it first prints the
   torch and sympy versions and whether matplotlib imports): ``[sbml]``,
   ``examples/repressilator.sbml.xml`` through ``from_sbml`` at 256
   members under ``'pallas'`` (K1 at n=6) against the library
   repressilator, the MAPK-22 ``to_sbml``/``from_sbml`` round trip's RHS
   to 1e-13, and tests/test_sbml.py's lowered events (a copy of its
   document, ``EVENT_SBML``) through ``Project`` against SciPy;
   ``[petab-mapk22]``, phase 7's problem exported to SBML, PEtab tables
   and a CSV and read back by ``from_petab`` and ``experiments_from_csv``
   (costs at θ_true equal to the native ``Project``'s and the JAX
   package's to 1e-6), one screening evaluation with Jacobian at 256
   ``sample_startpoints`` (K1), ``multistart_trf`` from the best 16 at
   ``PETAB_TRF_ITERS`` iterations in the PEtab box (K1 and K2), two
   members on the CPU; ``[compat]``, ``solve_ivp`` on the MAPK-22 RHS, a
   terminal event's grid, ``odeint`` on MM-3 and
   ``least_squares``/``leastsq`` on an MM-3 fit against SciPy; ``[plot]``,
   ``multistart --plot`` and ``profile --plot`` on MM-3 at the smallest
   depth (the PNGs, or the CLI's ImportError naming matplotlib where it
   does not import);

18. after the CLI group has ended: ``[banded]``, tests/test_banded.py's
   relay chain at n = 200, kl = ku = 1, 64 rates, BDF at rtol 1e-6 under
   ``'banded'`` and ``'lu'`` (statuses 1, step counts within 2,
   trajectories within 1e-6; member 0 against the JAX package's banded
   run and SciPy; one factorization and one solve timed); the
   ``[petab-mapk22]`` screening evaluation timed beside the native one;
   the kernel timings at n = 2-6 (``[K1-small]``/``[K2-small]``) and
   n = 44 (``[K1-n44]``/``[K2-n44]``).

19. multi-device, two ranks of a gloo process group sharing the card
   (``chip_smoke.py --mesh-rank ...`` processes; they load the kernels
   that phase 2 built, and each writes its launches to a file that the
   phase sums): ``[mesh-fit]``, right after phase 8, phase 7's problem and
   starts through ``TwoPhaseDriver(mesh=)`` (128 starts screened a rank,
   the gathered screen ranked on both, the 16 best polished 8 + 8): the
   ranks' gathered results equal bit for bit, the screened statuses, the
   polished set and statuses phase 7's, the ranked polished costs phase
   7's to ``MESH_ROUNDING_BOUND`` (1e-4: the ranks fit half batches, whose
   members round otherwise than in the whole batch), K1 and K2 launched
   in each rank, the starts' digest equal on both;
   ``[cli-mapk22-mesh]``, in the CLI group after ``[cli-mapk22]`` (which
   also runs the same fit by two blocks of the starts and of the top_k in
   one process, ``block_reference``), ``multistart --config
   configs/mapk22.yaml`` (its ``mesh:`` section) at ``CLI_DEPTH`` as
   ``torchrun --nproc_per_node=2`` launches it (the CLI joins the group
   from the environment): rank 0 prints the record, rank 1 nothing; both
   ranks' screens and polishes equal each other's and the block
   reference's bit for bit (every start's screened status and cost, the
   polished starts, statuses and costs); against ``[cli-mapk22]``'s whole
   batch the best cost to ``CLI_MESH_BOUND`` (1e-3) and at most the cost
   at truth; K1 and K2 launched in each rank.

``phase_egfr_10k(card, n_starts=10000)``, not called by ``main()``, is
config 5 at its literal scale (``bench/experiments/egfr_10k.py``) through
``TwoPhaseDriver``, in a call of its own.

Phases 13 and 14 and ``[sample-mm3]`` run in a second process on the same
card (``chip_smoke.py --cli-group <launches file>``, started after phase 5
and joined before phase 18; its output is this one's), beside phases 6-17
in this one: every path is host-bound, and in one process the whole took
1013-1406 s against the 1200 s limit (PERF.md §4). Each lap of this
process first checks that the CLI group has not failed. The two share the
host's cores and the card, so the wall times of phases 6-17 and of the
CLI group are not comparable with one-process runs; every kernel timing
and phase 18 run with no second process. The launch counters, per
process, are set to 0 just before each path and read just after.

The lines before the last are a ``{"kernels": [...]}`` JSON object (per
kernel: launches on those paths, error against its plain version, its
time, the plain version's, the least time the card could take and the
library call's) and the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``. The floor is context for the bounds (no
one-launch kernel goes below it) and is not in the kernels' line. Library
calls (``torch.linalg.inv``, ``torch.linalg.solve``) are timed here as
yardsticks only; the port never calls them.

``python3 chip_smoke.py --profile`` adds one main-path batch, one
screening evaluation of the fit path, one EGFR evaluation and one JAK-STAT
screening evaluation of 256 starts under ``torch.profiler``: the
device-busy share, the number of device kernels and the device time by
kernel name.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM rate, and the
# non-tensor-core f32 and f64 rates that these scalar kernels can use.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12

BATCH = 256            # [main]'s members and [fit]'s screened starts
POLISH_BATCH = 16      # [fit]'s polished members (FIT_TOP_K x 1 experiment)
MAJOR_BATCH = 64       # [fit-major]'s screened starts
T_SPAN = (0.0, 100.0)
N_T = 41

# the fit path (bench/headline_bench.py's MAPK-22 headline)
FIT_STARTS = 256
FIT_TOP_K = 16
FIT_SCREEN_ITERS = 8
FIT_POLISH_ITERS = 2   # cut from the headline's 20 to leave the CLI paths
#                        room in the limit (best polished cost 10.18 at 4,
#                        10.13 at 20; 10.82 at the true parameters)
FIT_ITER_CHUNK = 4
MINPACK_ANCHOR_COST = 10.133   # scipy.optimize.leastsq on this problem

# the EGFR-scale path (bench/egfr_bench.py): 99 species, 11 free constants
EGFR_BATCH = 64
EGFR_MAJOR_BATCH = 16
EGFR_FIT_ITERS = 1     # cut from 10 to leave the CLI paths room in the limit
#                        (best 47.315 <= 49.468 at truth on the CPU at 1)
EGFR_ITER_CHUNK = 2
EGFR_FREE_PREFIXES = ("L+Rec", "LR+A0_0", "LR+A0_1", "P0+A0_1")

# The LM depth of the CLI paths: the card takes ~20 ms a step attempt
# whatever the model (host-bound), and at their own depth these paths take
# ~55 min (PERF.md), so this run keeps every path's width and cuts its
# depth to the smallest at which its gates hold:
CLI_DEPTH = (1, 2)          # (screen, polish) LM iterations of multistart:
#                             best cost <= cost at truth holds from here on
PROFILE_FIT_ITERS = 6       # profile --fit-iters (the CLI's default: 40):
#                             k2's interval within 2.1e-4 of the JAX CLI's
#                             on the CPU (the gate: 1e-3; 4 gives 7.8e-3)
ENSEMBLE_ITERS = 1          # fit --max-iter (the example's: 60). Its best
#                             start converges (status > 0) only from 13
#                             iterations, ~5 min a run: that gate is left to
#                             a run of phase_jakstat_ensemble(card, None)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


TIMED_BATCHES = (16, 64, 256, 1024)


def cuda_ms(fn, reps: int, warmup: int = 3, queued: bool = True) -> float:
    """Mean device time of ``fn()`` in ms by CUDA events: from a queue
    behind ~60 ms of device work (``queued``), or at the host's launch
    pace."""
    from tpusysbio_torch.linalg.timing import cuda_ms as timed

    return timed(fn, reps, warmup=warmup, queued=queued)


def times_by_batch(make_call):
    """Queued and host-paced ms of ``make_call(B)()`` per timed batch."""
    queued, paced = {}, {}
    for B in TIMED_BATCHES:
        call = make_call(B)
        queued[B] = cuda_ms(call, reps=200)
        paced[B] = cuda_ms(call, reps=200, queued=False)
    return queued, paced


def fmt_by_batch(ms):
    return ", ".join(f"B={B} {t:.4f}" for B, t in ms.items())


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


@contextlib.contextmanager
def gj_layout(layout):
    """Set the port's Gauss-Jordan layout switch ('minor' launches K1,
    'major' K3) and restore it on the way out."""
    from tpusysbio_torch.linalg import gpu_lu

    saved = gpu_lu._LAYOUT
    gpu_lu._LAYOUT = layout
    try:
        yield
    finally:
        gpu_lu._LAYOUT = saved


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
    for r in _build.resource_report(_build.build_info.get("log", "")):
        print(f"[build]   {r['source']} {r['kernel']}: {r['registers']} "
              f"registers, stack frame {r['stack']} B, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B")
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"build: {r['kernel']} spills registers")
    return secs


def phase_k1(model, rng):
    import torch

    from tpusysbio_torch.linalg import gpu_lu

    rows = {}
    a22 = newton_matrices(model, rng, BATCH)
    a22_polish = newton_matrices(model, rng, POLISH_BATCH)
    a64 = random_newton(rng, BATCH, 64)
    a97 = random_newton(rng, 16, 97, scale=0.05)
    # n=22 at the batch of [main] and the screen, and at the polish's
    for name, a in (("n22", a22), ("n22 polish", a22_polish), ("n64", a64)):
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

    # timing at n=22: B=256 is [main]'s and the screen's batch, B=16 the
    # polish's, B=64 [fit-major]'s
    n = 22
    by_batch = {BATCH: a22.to(torch.float32).contiguous(),
                POLISH_BATCH: a22_polish.to(torch.float32).contiguous()}
    for B in TIMED_BATCHES:
        if B not in by_batch:
            by_batch[B] = random_newton(rng, B, n).to(torch.float32)
    a32 = by_batch[BATCH]
    ms_q, ms_h = times_by_batch(
        lambda B: lambda: gpu_lu.gj_inverse_f32(by_batch[B]))
    ms = ms_q[BATCH]
    plain_ms = cuda_ms(lambda: gpu_lu.gj_inverse_f32_plain(a32), reps=10)
    lib_ms = cuda_ms(lambda: torch.linalg.inv(a32), reps=200)
    nbytes = 2 * BATCH * n * n * 4
    # in place: per pivot step n divisions and (n-1) rows of n
    # multiply-adds
    ops = BATCH * n * (n + 2 * n * (n - 1))
    b_ms, b_by = bound_ms(nbytes, ops / F32_FLOPS)
    print(f"[K1] n=22 kernel ms from the queue: {fmt_by_batch(ms_q)}; at "
          f"the host's launch pace: {fmt_by_batch(ms_h)}", flush=True)
    print(f"[K1] B={BATCH} n=22: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.linalg.inv {lib_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})", flush=True)
    return dict(name="gj_inverse_f32", route="cuda",
                ms_by_batch=ms_q, host_paced_ms_by_batch=ms_h,
                max_abs_err_by_case={k: v["abs"] for k, v in rows.items()},
                source="tpusysbio_torch/linalg/csrc/gj_inverse.cu",
                replaces="tpusysbio/linalg/pallas_lu.py:104",
                max_abs_err=rows["n22"]["abs"], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def phase_k2(model, rng):
    import torch

    from tpusysbio_torch.linalg import gpu_lu

    out = {}
    # n=22 at [main]'s batch and at the polish's (every launch of [fit])
    for n, B in ((22, BATCH), (22, POLISH_BATCH), (64, BATCH)):
        a = (newton_matrices(model, rng, B) if n == 22
             else random_newton(rng, B, n))
        b = torch.as_tensor(rng.standard_normal((B, n)), device="cuda")
        x32 = gpu_lu.inverse(a.to(torch.float32))
        got = gpu_lu.refine_solve(x32, a, b)
        ref = gpu_lu.refine_solve_plain(x32, a, b)
        lib = torch.linalg.solve(a, b)
        torch.cuda.synchronize()
        rel_lib = float(((got - lib).abs() / lib.abs().clamp_min(1e-30))
                        .max())
        rel_plain = float((got - ref).abs().max() / ref.abs().max())
        check(rel_lib < 1e-9,
              f"K2 n={n} B={B}: rel err vs torch.linalg.solve {rel_lib:.3e}")
        check(rel_plain <= 1e-12,
              f"K2 n={n} B={B}: rel diff from plain {rel_plain:.3e} > 1e-12")
        print(f"[K2] n={n}: B={B} rel err vs torch.linalg.solve "
              f"{rel_lib:.3e} (bound 1e-9), vs plain {rel_plain:.3e} "
              f"(bound 1e-12)", flush=True)
        out[n, B] = (x32, a, b, float((got - ref).abs().max()))
    n = 22
    by_batch = {B: out[n, B][:3] for B in (BATCH, POLISH_BATCH)}
    for B in TIMED_BATCHES:
        if B not in by_batch:
            a = random_newton(rng, B, n)
            by_batch[B] = (gpu_lu.inverse(a.to(torch.float32)), a,
                           torch.as_tensor(rng.standard_normal((B, n)),
                                           device="cuda"))
    ms_q, ms_h = times_by_batch(
        lambda B: lambda: gpu_lu.refine_solve(*by_batch[B]))
    x32, a, b, abs_err = out[n, BATCH]
    ms = ms_q[BATCH]
    plain_ms = cuda_ms(lambda: gpu_lu.refine_solve_plain(x32, a, b),
                       reps=50)
    lib_ms = cuda_ms(lambda: torch.linalg.solve(a, b), reps=50)
    nbytes = BATCH * (n * n * 4 + n * n * 8 + 2 * n * 8)
    # 4 f32 mat-vecs at the f32 rate, 3 f64 mat-vecs at the f64 rate
    t_ops = BATCH * 2 * n * n * (4 / F32_FLOPS + 3 / F64_FLOPS)
    b_ms, b_by = bound_ms(nbytes, t_ops)
    print(f"[K2] n=22 kernel ms from the queue: {fmt_by_batch(ms_q)}; at "
          f"the host's launch pace: {fmt_by_batch(ms_h)}", flush=True)
    print(f"[K2] B={BATCH} n=22: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.linalg.solve {lib_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})", flush=True)
    return dict(name="refine_solve", route="cuda",
                ms_by_batch=ms_q, host_paced_ms_by_batch=ms_h,
                max_abs_err_by_case={f"n{k[0]} B={k[1]}": v[3]
                                     for k, v in out.items()},
                source="tpusysbio_torch/linalg/csrc/refine_solve.cu",
                replaces="tpusysbio/linalg/pallas_lu.py:492",
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def schur_blocks(rng, batch):
    """The two matrices that block-Schur elimination hands the
    Gauss-Jordan kernel for a 99-state Newton matrix: the leading 64 x 64
    block of ``I - cJ`` (the EGFR-scale model at random states, f32) and
    the 35 x 35 Schur complement of it."""
    import torch

    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    model = library.egfr_like(device="cuda")
    p = library.egfr_true_params(device="cuda")[None] * torch.as_tensor(
        np.exp(rng.normal(scale=0.1, size=(batch, model.n_params))),
        device="cuda")
    y = torch.as_tensor(rng.uniform(0.0, 1.0, size=(batch, model.n_states)),
                        device="cuda")
    J = model.rhs_jac(torch.zeros(batch, dtype=torch.float64, device="cuda"),
                      y, p)
    a = (torch.eye(model.n_states, dtype=torch.float64, device="cuda")
         - 1e-2 * J).to(torch.float32)
    n1 = gpu_lu.MAX_KERNEL_N
    a11 = a[:, :n1, :n1].contiguous()
    x11 = gpu_lu.gj_inverse_f32_plain(a11)
    s = a[:, n1:, n1:] - a[:, n1:, :n1] @ (x11 @ a[:, :n1, n1:])
    return a11, s.contiguous()


def division_operands(rng, count):
    """Numerators and denominators for the check of K3's own division: all
    exponents, both signs, and the values its range check must catch
    (zeros, denormals, infinities, NaN)."""
    def wide():
        with np.errstate(over="ignore"):
            x = np.ldexp(rng.uniform(1.0, 2.0, count),
                         rng.integers(-150, 130, count)).astype(np.float32)
        x *= rng.choice([-1.0, 1.0], count).astype(np.float32)
        for value, share in ((0.0, 64), (-0.0, 64), (np.inf, 256),
                             (np.nan, 256)):
            x[rng.integers(0, count, count // share)] = value
        return x

    return wide(), wide()


def phase_k3_division(rng):
    """K3 divides the pivot row by a branch-free sequence of its own; it
    must round as ``__fdiv_rn`` (K1's division) does, bit for bit."""
    import torch

    from tpusysbio_torch.linalg import _build

    count = 1 << 22
    x, b = (torch.as_tensor(v, device="cuda")
            for v in division_operands(rng, count))
    # the middle range, where the short sequence itself answers
    b[: count // 2] = torch.as_tensor(
        np.ldexp(rng.uniform(1.0, 2.0, count // 2),
                 rng.integers(-30, 30, count // 2)).astype(np.float32),
        device="cuda")
    got, ref = torch.empty_like(x), torch.empty_like(x)
    err = _build.load().tsb_gj_major_divide_check(
        x.data_ptr(), b.data_ptr(), got.data_ptr(), ref.data_ptr(), count,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(err == 0, f"K3 division check: launch failed, cudaError {err}")
    same = ((got.view(torch.int32) == ref.view(torch.int32))
            | (got.isnan() & ref.isnan()))
    bad = int((~same).sum())
    print(f"[K3] the kernel's division against __fdiv_rn on {count} pairs "
          f"(all exponents, zeros, denormals, infinities, NaN): {bad} "
          f"differ", flush=True)
    check(bad == 0, f"K3 division: {bad} quotients differ from __fdiv_rn")


def phase_k3(model, rng):
    """K3, the Gauss-Jordan kernel with the batch in the warp (a group of
    lanes per matrix), against the plain version it shares with K1, and bit
    for bit against K1 (a warp per matrix)."""
    import torch

    from tpusysbio_torch.linalg import gpu_lu

    def k3(a):
        with gj_layout("major"):
            return gpu_lu.gj_inverse_f32(a)

    def k1(a):
        with gj_layout("minor"):
            return gpu_lu.gj_inverse_f32(a)

    phase_k3_division(rng)
    a22 = newton_matrices(model, rng, BATCH).to(torch.float32).contiguous()
    # the batch of [fit-major]
    a22_major = newton_matrices(model, rng, MAJOR_BATCH).to(
        torch.float32).contiguous()
    # the shapes of [egfr-sens], [egfr-fit] and [egfr-major]
    a64_schur, a35_schur = schur_blocks(rng, EGFR_BATCH)
    cases = (("n22", a22), ("n22 fit-major", a22_major),
             ("n22 large", random_newton(rng, 1024, 22).to(torch.float32)),
             ("n22 ragged", random_newton(rng, 67, 22).to(torch.float32)),
             ("n64", random_newton(rng, BATCH, 64).to(torch.float32)),
             ("n33", random_newton(rng, 33, 33).to(torch.float32)),
             ("n32", random_newton(rng, 5, 32).to(torch.float32)),
             ("n1", random_newton(rng, 7, 1).to(torch.float32)),
             ("64x64x64 egfr", a64_schur), ("64x35x35 egfr", a35_schur))
    abs_by_case, k1_abs_by_case = {}, {}
    for name, a32 in cases:
        before = gpu_lu.LAUNCHES["gj_inverse_major_f32"]
        got = k3(a32)
        torch.cuda.synchronize()
        check(gpu_lu.LAUNCHES["gj_inverse_major_f32"] == before + 1,
              f"K3 {name}: the launch was not counted")
        ref = gpu_lu.gj_inverse_major_f32_plain(a32)
        other = k1(a32)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite")
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        check(abs_err <= 1e-5,
              f"K3 {name}: max abs diff from plain {abs_err:.3e} > 1e-5")
        check(bool(torch.equal(got, other)),
              f"K3 {name}: not equal to K1 bit for bit (max abs diff "
              f"{float((got - other).abs().max()):.3e})")
        abs_by_case[name] = abs_err
        k1_abs_by_case[name] = float((other - ref).abs().max())
        print(f"[K3] {name}: B={a32.shape[0]} max abs diff from plain "
              f"{abs_err:.3e} (rel {rel:.3e}, bound 1e-5); equal to K1 bit "
              f"for bit", flush=True)

    # general matrices: most pivot steps exchange rows, which both kernels
    # do by renaming; the groups of a K3 warp pivot on different rows
    for n_gen in (22, 33, 35, 64):
        gen = torch.as_tensor(rng.standard_normal((66, n_gen, n_gen)),
                              dtype=torch.float32, device="cuda")
        got, other = k3(gen), k1(gen)
        check(bool(torch.equal(got, other)),
              f"K3 general n={n_gen}: not equal to K1 bit for bit")
        res = (got.double() @ gen.double()
               - torch.eye(n_gen, device="cuda")).abs().amax(dim=(1, 2))
        check(float(res.median()) < 1e-2,
              f"K3 general n={n_gen}: median ||XA-I||max {float(res.median())}")
    print("[K3] general matrices n=22, 33, 35, 64 (B=66): equal to K1 bit "
          "for bit", flush=True)
    tied = torch.tensor(
        [[[2.0, 1.0, 0.0], [-2.0, 3.0, 1.0], [2.0, 0.0, 5.0]],
         [[0.0, 1.0, 2.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 3.0]]],
        device="cuda")
    check(bool(torch.equal(k3(tied), k1(tied))),
          "K3 tied pivots: not equal to K1 bit for bit")
    tied_err = float((k3(tied) - gpu_lu.gj_inverse_f32_plain(tied)).abs()
                     .max())
    check(tied_err <= 1e-6, f"K3 tied pivots: {tied_err:.3e} from plain")
    print(f"[K3] tied pivots: the lowest row wins, {tied_err:.3e} from "
          f"plain (bound 1e-6), equal to K1 bit for bit", flush=True)

    # inverse() through block-Schur at n=97 with K3 on both blocks
    a97 = random_newton(rng, 16, 97, scale=0.05)
    with gj_layout("major"):
        before = gpu_lu.LAUNCHES["gj_inverse_major_f32"]
        x = gpu_lu.inverse(a97)
        torch.cuda.synchronize()
        n_k3 = gpu_lu.LAUNCHES["gj_inverse_major_f32"] - before
    check(n_k3 == 2, f"K3 n97 Schur: {n_k3} K3 launches, expected 2")
    eye = torch.eye(97, dtype=torch.float64, device="cuda")
    res = float((x @ a97 - eye).abs().sum(-1).max())
    check(res < 1e-11, f"K3 n97 Schur: ||XA - I||inf {res:.3e} >= 1e-11")
    print(f"[K3] n97 (block-Schur under 'major', K3 on both blocks): B=16 "
          f"||XA-I||inf {res:.3e} (bound 1e-11)", flush=True)

    # a NaN gives a non-finite inverse and leaves its neighbours in the
    # warp alone; a singular matrix gives a finite one
    nan = torch.eye(3, device="cuda")[None].clone()
    nan[0, 1, 2] = float("nan")
    check(not bool(torch.isfinite(k3(nan)).all()),
          "K3: NaN input gave a finite inverse")
    mixed = a22[:6].clone()
    mixed[2, 3, 4] = float("nan")
    got = k3(mixed)
    keep = [0, 1, 3, 4, 5]
    check(bool(torch.equal(got[keep], k3(a22[:6])[keep]))
          and not bool(torch.isfinite(got[2]).all()),
          "K3: a NaN member changed its neighbours in the warp")
    sing = torch.tensor([[[1.0, 2.0], [2.0, 4.0]]], device="cuda")
    check(bool(torch.isfinite(k3(sing)).all()),
          "K3: singular input gave a non-finite inverse")
    check(bool(torch.equal(k3(sing), gpu_lu.gj_inverse_f32_plain(sing))),
          "K3: singular input differs from the plain version")
    check(not bool(torch.isfinite(k1(nan)).all()),
          "K1: NaN input gave a finite inverse")
    check(bool(torch.equal(k1(sing), k3(sing))),
          "K1: singular input differs from K3")
    print("[K3] NaN in -> non-finite out, neighbours in the warp unchanged; "
          "singular in -> finite out (K1 too)", flush=True)

    # timing at n=22, K1 beside it in the same call: B=256 is the screen's
    # batch, B=64 [fit-major]'s
    n = 22
    by_batch = {BATCH: a22, MAJOR_BATCH: a22_major}
    for B in (1024, 4096):
        by_batch[B] = random_newton(rng, B, n).to(torch.float32)
    ms_q = {B: cuda_ms(lambda: k3(by_batch[B]), reps=200)
            for B in sorted(by_batch)}
    k1_q = {B: cuda_ms(lambda: k1(by_batch[B]), reps=200)
            for B in sorted(by_batch)}
    ms_h = {B: cuda_ms(lambda: k3(by_batch[B]), reps=200, queued=False)
            for B in sorted(by_batch)}
    ms = ms_q[BATCH]
    plain_ms = cuda_ms(lambda: gpu_lu.gj_inverse_f32_plain(a22), reps=10)
    lib_ms = cuda_ms(lambda: torch.linalg.inv(a22), reps=200)
    nbytes = 2 * BATCH * n * n * 4
    ops = BATCH * n * (n + 2 * n * (n - 1))   # in place, as K1
    b_ms, b_by = bound_ms(nbytes, ops / F32_FLOPS)
    print(f"[K3] n=22 kernel ms from the queue: {fmt_by_batch(ms_q)} (K1 "
          f"in the same call: {fmt_by_batch(k1_q)}); at the host's launch "
          f"pace: {fmt_by_batch(ms_h)}", flush=True)
    print(f"[K3] B={BATCH} n=22: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, torch.linalg.inv {lib_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by})", flush=True)

    # the two block-Schur shapes of the EGFR-scale paths, both kernels
    by_shape, k1_by_shape, bound_by_shape, lib_by_shape = {}, {}, {}, {}
    for a32 in (a64_schur, a35_schur):
        B, m = a32.shape[0], a32.shape[-1]
        tag = f"{B}x{m}x{m}"
        by_shape[tag] = cuda_ms(lambda: k3(a32), reps=200)
        k1_by_shape[tag] = cuda_ms(lambda: k1(a32), reps=200)
        lib_by_shape[tag] = cuda_ms(lambda: torch.linalg.inv(a32), reps=200)
        bound_by_shape[tag] = bound_ms(
            2 * B * m * m * 4,
            B * m * (m + 2 * m * (m - 1)) / F32_FLOPS)
        print(f"[K3] block-Schur shape {tag}: K3 {by_shape[tag]:.4f} ms, K1 "
              f"{k1_by_shape[tag]:.4f} ms from the queue, torch.linalg.inv "
              f"{lib_by_shape[tag]:.4f} ms, bound "
              f"{bound_by_shape[tag][0]:.6f} ms ({bound_by_shape[tag][1]})",
              flush=True)
    shape_keys = dict(
        bound_ms_by_shape={k: v[0] for k, v in bound_by_shape.items()},
        library_ms_by_shape=lib_by_shape)
    return dict(name="gj_inverse_major_f32", route="cuda",
                ms_by_batch=ms_q, host_paced_ms_by_batch=ms_h,
                ms_by_shape=by_shape, **shape_keys,
                max_abs_err_by_case=abs_by_case,
                source="tpusysbio_torch/linalg/csrc/gj_inverse_major.cu",
                replaces="tpusysbio/linalg/pallas_lu.py:55",
                max_abs_err=abs_by_case["n22"], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                beside_k1=dict(ms_by_batch=k1_q, ms_by_shape=k1_by_shape,
                               max_abs_err_by_case=k1_abs_by_case,
                               **shape_keys))


def phase_floor():
    """The launch floor: an empty kernel through the kernels' launch route
    (ctypes entry point, PyTorch's current stream), queued as the kernels
    are timed."""
    import torch

    from tpusysbio_torch.linalg import _build

    fn = _build.load().tsb_launch_floor
    stream = torch.cuda.current_stream().cuda_stream

    def launch(blocks):
        check(fn(blocks, 128, stream) == 0, "floor: the launch failed")

    floor = {g: cuda_ms(lambda: launch(g), reps=200) for g in (16, 256)}
    paced = {g: cuda_ms(lambda: launch(g), reps=200, queued=False)
             for g in (16, 256)}
    print(f"[floor] empty kernel, 128 threads a block, ms from the queue: "
          f"grid 16 {floor[16]:.4f}, grid 256 {floor[256]:.4f}; at the "
          f"host's launch pace (ctypes call alone): grid 16 {paced[16]:.4f}, "
          f"grid 256 {paced[256]:.4f}", flush=True)


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
    for k in ("gj_inverse_f32", "refine_solve"):
        check(launches[k] > 0, f"main path: kernel {k} was never launched")
    check(tuple(res.ys.shape) == (BATCH, N_T, 22)
          and tuple(res.sens.shape) == (BATCH, N_T, 22, 30),
          f"main path: shapes {tuple(res.ys.shape)}, {tuple(res.sens.shape)}")
    check(bool(torch.isfinite(res.ys).all() and torch.isfinite(res.sens)
               .all()), "main path: non-finite outputs")
    nsteps = res.nsteps.cpu().numpy()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"[main] {n_ok}/{BATCH} members status == 1; mean_nsteps "
          f"{nsteps.mean():.2f}; launches {launches}; first batch "
          f"{first_s:.3f} s; best of 2 {best:.3f} s "
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


def build_fit_problem(device):
    """The MAPK-22 headline problem as ``bench/fits_bench.py`` builds it:
    ``fit_data``'s data, the 12 MAPK-layer rate constants free and the
    rest fixed at truth. Returns the tight ``Project``, the screening
    ``Project`` and ``theta_true``."""
    import dataclasses

    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.project import ParameterMap, Project

    model, p_true, t, data, sigma, free = fit_data(device)
    meas = tuple(Measurement(obs_index=i, times=t, values=data[:, i],
                             sigmas=np.full(len(t), sigma))
                 for i in range(model.n_obs))
    batch = ExperimentBatch.from_experiments([Experiment("wt", meas)],
                                             device=device)
    names = model.param_names
    fixed = {n: p_true[names.index(n)] for n in names if n not in free}
    pmap = ParameterMap.create(names, 1, shared=tuple(free), fixed=fixed,
                               device=device)
    tight = Project(model=model, pmap=pmap, batch=batch,
                    config=tight_config())
    screen = dataclasses.replace(tight, config=screen_config())
    theta_true = pmap.pack({n: p_true[names.index(n)] for n in free})
    return tight, screen, theta_true


def two_phase(tight, screen, top_k, screen_iters, polish_iters,
               on_polish=None, mesh=None):
    from tpusysbio_torch import FitConfig
    from tpusysbio_torch.fit import TwoPhaseDriver

    def polish_rj(theta):
        if on_polish is not None:
            on_polish()
        return tight.residuals_and_jacobian(theta)

    return TwoPhaseDriver(
        (screen.residuals, screen.residuals_and_jacobian),
        (tight.residuals, polish_rj),
        FitConfig(max_iter=screen_iters, eval_mode="lockstep", ftol=1e-4,
                  xtol=1e-4),
        FitConfig(max_iter=polish_iters, eval_mode="lockstep"), top_k,
        mesh=mesh, iter_chunk=FIT_ITER_CHUNK, screen_channels="rank",
        run_tag="headline_mapk22")


def phase_fit():
    """The fit path at full width: 256 starts screened, the best 16
    polished, through ``TwoPhaseDriver``; then a small run of the same
    fit on the CPU against the card."""
    import torch

    from tpusysbio_torch.fit import latin_hypercube
    from tpusysbio_torch.linalg import gpu_lu

    tight, screen, theta_true = build_fit_problem("cuda")
    check(tight.n_theta == 12 and tight.n_residuals == 36
          and tight.model.n_states == 22,
          "fit: the problem is not the 22-state, 12-parameter, 36-row one")
    starts = latin_hypercube(torch.Generator().manual_seed(0), FIT_STARTS,
                             theta_true - 1.0, theta_true + 1.0)
    at_screen_end = {}
    fit = two_phase(
        tight, screen, FIT_TOP_K, FIT_SCREEN_ITERS, FIT_POLISH_ITERS,
        on_polish=lambda: at_screen_end.setdefault(
            "launches", dict(gpu_lu.LAUNCHES)))

    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    polish, scr, info = fit.run(starts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    l_screen = at_screen_end["launches"]
    l_polish = {k: launches[k] - l_screen[k] for k in launches}
    for k in ("gj_inverse_f32", "refine_solve"):
        check(launches[k] > 0, f"fit: kernel {k} was never launched")
    check(l_screen["gj_inverse_f32"] > 0 and l_screen["refine_solve"] == 0,
          f"fit: the f32 screen must launch K1 and not K2: {l_screen}")
    check(l_polish["refine_solve"] > 0 and l_polish["gj_inverse_f32"] > 0,
          f"fit: the polish must launch K1 and K2: {l_polish}")
    check(launches["gj_inverse_major_f32"] == 0,
          "fit: K3 was launched under the 'minor' layout")

    s_cost = scr.cost.cpu().numpy()
    n_finite = int(np.isfinite(s_cost).sum())
    check(tuple(scr.theta.shape) == (FIT_STARTS, 12),
          f"fit: screen shape {tuple(scr.theta.shape)}")
    check(n_finite >= 200,
          f"fit: only {n_finite}/{FIT_STARTS} screened costs are finite")
    p_cost = polish.cost.cpu().numpy()
    p_status = polish.status.cpu().numpy()
    check(tuple(polish.theta.shape) == (FIT_TOP_K, 12)
          and tuple(polish.cov.shape) == (FIT_TOP_K, 12, 12),
          f"fit: polish shapes {tuple(polish.theta.shape)}")
    check(bool((p_status >= 0).all()) and bool(np.isfinite(p_cost).all()),
          f"fit: polished status {p_status.tolist()} cost {p_cost.tolist()}")
    best_cost = float(p_cost.min())
    cost_true = float(tight.cost(theta_true))
    check(best_cost <= cost_true,
          f"fit: best polished cost {best_cost} > cost at theta_true "
          f"{cost_true}")
    s_it = scr.n_iter.cpu().numpy()
    p_it = polish.n_iter.cpu().numpy()
    print(f"[fit] N={FIT_STARTS} starts, top_k={FIT_TOP_K}, "
          f"{FIT_SCREEN_ITERS} screen + {FIT_POLISH_ITERS} polish LM "
          f"iterations (iter_chunk {FIT_ITER_CHUNK}): screen "
          f"{info['screen_seconds']:.2f} s, polish "
          f"{info['polish_seconds']:.2f} s, wall {wall:.2f} s, "
          f"{FIT_STARTS / wall * 60.0:.1f} starts/min", flush=True)
    print(f"[fit] screen: {n_finite}/{FIT_STARTS} finite costs, "
          f"{int((scr.status.cpu().numpy() > 0).sum())} converged, mean LM "
          f"iterations {s_it.mean():.2f}, best screened cost "
          f"{float(np.nanmin(s_cost)):.4f}; launches {l_screen}",
          flush=True)
    print(f"[fit] polish: {int((p_status > 0).sum())}/{FIT_TOP_K} "
          f"converged, mean LM iterations {p_it.mean():.2f}, best cost "
          f"{best_cost:.6f} (cost at theta_true {cost_true:.6f}; the "
          f"reference's MINPACK anchor for this problem is "
          f"{MINPACK_ANCHOR_COST}, asserted there only from 1024 starts "
          f"on); launches {l_polish}", flush=True)

    # the same fit on the CPU for the 4 best starts, against the card.
    # Polish row i refits the i-th ranked screened member.
    s_bad = (scr.status.cpu().numpy() < 0) | ~np.isfinite(s_cost)
    ranked = np.argsort(np.where(s_bad, np.inf, s_cost),
                        kind="stable")[:FIT_TOP_K]
    check(bool(torch.equal(polish.theta0, scr.theta[ranked.tolist()])),
          "fit: the polish set is not the ranked screen top_k")
    best4 = ranked[np.argsort(p_cost, kind="stable")[:4]]
    four_starts = starts[best4.tolist()]
    # LM amplifies what the two devices round differently: an iterate
    # moves with the Jacobian, whose f32 sensitivity columns agree to 1e-4
    # at best, and the f32 screening stepper's step sequence itself depends
    # on rounding. So the phases are held apart and each is compared from
    # identical inputs: one screening and one tight evaluation at the same
    # points (held a few times over what the two devices read), the
    # 2-iteration screens from the same starts (equal statuses, and the
    # best member's cost, so that rounding is seen not to grow), and the
    # 3-iteration polishes from the same screened points (the card's).
    c_tight, c_screen, _ = build_fit_problem("cpu")
    d_dev = two_phase(tight, screen, 4, 2, 3)
    d_cpu = two_phase(c_tight, c_screen, 4, 2, 3)
    ev_dev = screen.evaluate(four_starts, with_jac=True)
    ev_cpu = c_screen.evaluate(four_starts.cpu(), with_jac=True)
    check(bool(torch.equal(ev_dev.status.cpu(), ev_cpu.status)),
          "fit CPU cross-check: screening statuses differ")
    ev_rel = float(((ev_dev.cost.cpu() - ev_cpu.cost).abs()
                    / ev_cpu.cost).max())
    j_rel = float((ev_dev.jacobian.cpu() - ev_cpu.jacobian).abs().max()
                  / ev_cpu.jacobian.abs().max())
    dev_polish, dev_screen, _ = d_dev.run(four_starts)
    cpu_screen = d_cpu.screen_run(four_starts.cpu())
    cpu_polish = d_cpu.polish_run(dev_polish.theta0.cpu())
    tv_dev = tight.evaluate(dev_polish.theta0, with_jac=True)
    tv_cpu = c_tight.evaluate(dev_polish.theta0.cpu(), with_jac=True)
    check(bool(torch.equal(tv_dev.status.cpu(), tv_cpu.status)),
          "fit CPU cross-check: tight statuses differ")
    tv_rel = float(((tv_dev.cost.cpu() - tv_cpu.cost).abs()
                    / tv_cpu.cost).max())
    tj_rel = float((tv_dev.jacobian.cpu() - tv_cpu.jacobian).abs().max()
                   / tv_cpu.jacobian.abs().max())
    sc_rels = ((dev_screen.cost.cpu() - cpu_screen.cost).abs()
               / cpu_screen.cost)
    sc_rel = float(sc_rels[int(torch.argmin(cpu_screen.cost))])
    po_rel = float(((dev_polish.cost.cpu() - cpu_polish.cost).abs()
                    / cpu_polish.cost).max())
    print(f"[fit] CPU cross-check (4 best starts): one f32 screening "
          f"evaluation cost rel {ev_rel:.3e}, Jacobian rel {j_rel:.3e} "
          f"(bounds 3e-3, 1e-3); 2 screen iterations: equal statuses, cost "
          f"rel of the best member {sc_rel:.3e} (bound 5e-2; all four "
          f"{[float(f'{v:.3e}') for v in sc_rels.tolist()]}); one tight evaluation cost rel {tv_rel:.3e}, "
          f"Jacobian rel {tj_rel:.3e} (bounds 1e-7, 1e-4); 3 polish "
          f"iterations from the card's screened points cost rel "
          f"{po_rel:.3e} (bound 1e-4, the Jacobian's)", flush=True)
    check(ev_rel <= 3e-3 and j_rel <= 1e-3,
          f"fit CPU cross-check: screening evaluation {ev_rel:.3e}, "
          f"{j_rel:.3e}")
    check(bool(torch.equal(dev_screen.status.cpu(), cpu_screen.status)),
          "fit CPU cross-check: screen statuses differ after 2 iterations")
    check(sc_rel <= 5e-2, f"fit CPU cross-check: screen {sc_rel:.3e}")
    check(bool(torch.equal(dev_polish.status.cpu(), cpu_polish.status)),
          "fit CPU cross-check: polish statuses differ")
    check(tv_rel <= 1e-7 and tj_rel <= 1e-4,
          f"fit CPU cross-check: tight evaluation {tv_rel:.3e}, "
          f"{tj_rel:.3e}")
    check(po_rel <= 1e-4, f"fit CPU cross-check: polish {po_rel:.3e}")
    ranked_polish = polish.ranked()
    fit_ref = {"screen_status": scr.status.cpu().numpy(),
               "screen_cost": scr.cost.cpu().numpy(),
               "polish_theta0": ranked_polish.theta0.cpu().numpy(),
               "polish_cost": ranked_polish.cost.cpu().numpy(),
               "polish_status": ranked_polish.status.cpu().numpy(),
               "wall": wall}
    return ((launches, l_screen, l_polish),
            (tight, screen, theta_true, starts), (polish.theta0, best_cost),
            fit_ref)


def phase_fit_major(problem):
    """The screening phase again with the layout switch set to 'major':
    K3 must take K1's place and give the same costs."""
    import torch

    from tpusysbio_torch import FitConfig
    from tpusysbio_torch.fit import make_multistart_runner
    from tpusysbio_torch.linalg import gpu_lu

    _, screen, _, starts = problem
    run = make_multistart_runner(
        screen.residuals, screen.residuals_and_jacobian,
        FitConfig(max_iter=2, eval_mode="lockstep", ftol=1e-4, xtol=1e-4),
        with_cov=False)
    sub = starts[:MAJOR_BATCH]

    def one(layout):
        with gj_layout(layout):
            gpu_lu.reset_launches()
            t0 = time.perf_counter()
            res = run(sub)
            torch.cuda.synchronize()
            return res, dict(gpu_lu.LAUNCHES), time.perf_counter() - t0

    minor, l_minor, s_minor = one("minor")
    major, l_major, s_major = one("major")
    check(l_major["gj_inverse_major_f32"] > 0,
          "fit-major: K3 was never launched")
    check(l_major["gj_inverse_f32"] == 0,
          f"fit-major: K1 was launched under 'major': {l_major}")
    check(l_minor["gj_inverse_major_f32"] == 0
          and l_minor["gj_inverse_f32"] > 0,
          f"fit-major: the 'minor' run launched {l_minor}")
    a, b = minor.cost.cpu().numpy(), major.cost.cpu().numpy()
    both = np.isfinite(a) & np.isfinite(b)
    check(bool((np.isfinite(a) == np.isfinite(b)).all()) and both.sum() >= 32,
          "fit-major: the layouts disagree on which members are finite")
    rel = float(np.max(np.abs(a[both] - b[both]) / np.abs(a[both])))
    check(rel <= 1e-5, f"fit-major: costs differ by {rel:.3e} > 1e-5")
    print(f"[fit-major] N={MAJOR_BATCH}, 2 LM iterations: 'major' launches {l_major} "
          f"in {s_major:.2f} s, 'minor' launches {l_minor} in "
          f"{s_minor:.2f} s; per-member costs differ by at most {rel:.3e} "
          f"relative (bound 1e-5) over {int(both.sum())} finite members",
          flush=True)
    return l_major


def build_egfr_problem(device):
    """The EGFR-scale fit problem as ``bench/egfr_bench.py`` builds it:
    the 99-species receptor cascade, data at 9 times for its 12 observables
    from an rtol=1e-8 simulation at the true constants (seed-0 noise,
    sigma = 2% of the largest value), the receptor module's and layer 0's
    kinase and phosphatase constants free (11) and the other 135 fixed at
    truth. Returns the ``Project`` and ``theta_true``."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.model import library
    from tpusysbio_torch.project import ParameterMap, Project

    model = library.egfr_like(device=device)
    p_true = library.egfr_true_params(device="cpu").numpy()
    t = np.linspace(0.5, 10.0, 9)
    sim = model.simulate(p_true[None], (0.0, 10.0), t,
                         config=SolverConfig(rtol=1e-8, atol=1e-11,
                                             max_steps=4096), device=device)
    check(int(sim.status[0]) == 1,
          "egfr: the data simulation did not finish")
    p_dev = torch.as_tensor(p_true, device=device)[None].expand(len(t), -1)
    obs = model.observables(sim.ys[0], p_dev).cpu().numpy()
    rng = np.random.default_rng(0)
    sigma = 0.02 * float(np.max(obs))
    data = obs + rng.normal(scale=sigma, size=obs.shape)
    meas = tuple(Measurement(obs_index=i, times=t, values=data[:, i],
                             sigmas=np.full(len(t), sigma))
                 for i in range(model.n_obs))
    batch = ExperimentBatch.from_experiments([Experiment("egf", meas)],
                                             device=device)
    names = model.param_names
    free = [n for n in names if n.startswith(EGFR_FREE_PREFIXES)]
    fixed = {n: p_true[names.index(n)] for n in names if n not in free}
    pmap = ParameterMap.create(names, 1, shared=tuple(free), fixed=fixed,
                               device=device)
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-6, atol=1e-9, max_steps=768,
                                       linear_solver="pallas",
                                       sens_precision="f32",
                                       dense_f32=True))
    theta_true = pmap.pack({n: p_true[names.index(n)] for n in free})
    return proj, theta_true


def project_on_cpu(proj, model):
    """``proj`` with ``model`` and every tensor of its map and batch on the
    CPU, where the kernels' plain versions run (the same data, not a second
    simulation of them)."""
    import dataclasses

    import torch

    def moved(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).cpu()
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})

    return dataclasses.replace(proj, model=model, pmap=moved(proj.pmap),
                               batch=moved(proj.batch))


def gj_shape_counts(name):
    """The launches of Gauss-Jordan kernel ``name`` by matrix size."""
    from tpusysbio_torch.linalg import gpu_lu

    return {n: c for (k, n), c in sorted(gpu_lu.LAUNCHES_BY_N.items())
            if k == name}


def check_schur_launches(tag, launches, by_n, kernel, other):
    """Every factorization of a 99 x 99 matrix launches ``kernel`` once at
    n=64 and once at n=35, and never ``other`` or the fused refined solve
    (n > 64 takes the plain rounds)."""
    total = launches[kernel]
    check(total > 0 and total % 2 == 0,
          f"{tag}: {kernel} launched {total} times, expected an even count")
    check(by_n == {35: total // 2, 64: total // 2},
          f"{tag}: {kernel} launches by n {by_n}, expected half of {total} "
          f"at 64 and half at 35")
    check(launches[other] == 0, f"{tag}: {other} was launched: {launches}")
    check(launches["refine_solve"] == 0,
          f"{tag}: the fused refined solve was launched at n=99: {launches}")


def phase_egfr_sens(card):
    """One batch of 64 evaluations with Jacobian of the EGFR-scale problem
    (n=99, 11 direction columns) through ``Project.evaluate``."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    t0 = time.perf_counter()
    proj, theta_true = build_egfr_problem("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = proj.model
    check(model.n_states == 99 and model.n_params == 146
          and model.n_obs == 12 and proj.n_theta == 11
          and proj.n_residuals == 108 and proj._theta_sens,
          "egfr: the problem is not the 99-state, 146-constant, "
          "11-parameter, 108-row one in theta mode")
    rng = np.random.default_rng(0)
    thetas = theta_true[None] + torch.as_tensor(
        rng.normal(scale=0.1, size=(EGFR_BATCH, 11)), device="cuda")

    def run():
        ev = proj.evaluate(thetas, with_jac=True)
        torch.cuda.synchronize()
        return ev

    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    ev = run()
    first_s = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    by_n = gj_shape_counts("gj_inverse_f32")
    status = ev.status.cpu().numpy().reshape(-1)
    n_ok = int((status == 1).sum())
    check(n_ok == EGFR_BATCH,
          f"egfr-sens: {n_ok}/{EGFR_BATCH} members status == 1")
    check(tuple(ev.residuals.shape) == (EGFR_BATCH, 108)
          and tuple(ev.jacobian.shape) == (EGFR_BATCH, 108, 11),
          f"egfr-sens: shapes {tuple(ev.residuals.shape)}, "
          f"{tuple(ev.jacobian.shape)}")
    check(bool(torch.isfinite(ev.residuals).all()
               and torch.isfinite(ev.jacobian).all()),
          "egfr-sens: non-finite residuals or Jacobian (the Schur guard "
          "poisons a member with NaN)")
    check_schur_launches("egfr-sens", launches, by_n, "gj_inverse_f32",
                         "gj_inverse_major_f32")
    nsteps = ev.nsteps.cpu().numpy().reshape(-1)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"[egfr-sens] {card}: problem built in {build_s:.2f} s (the "
          f"rtol=1e-8 data simulation on the card); {n_ok}/{EGFR_BATCH} "
          f"members status == 1, no NaN; mean_nsteps {nsteps.mean():.2f} "
          f"(max {nsteps.max()}); launches {launches}, K1 by n {by_n}; "
          f"first batch {first_s:.3f} s; best of 2 {best:.3f} s "
          f"({[round(t, 3) for t in times]}); {EGFR_BATCH / best:.2f} "
          f"integrations/s", flush=True)

    # 2 members again on the CPU, where the kernels' plain versions run
    cpu = project_on_cpu(proj, library.egfr_like(device="cpu"))
    ref = cpu.evaluate(thetas[:2].cpu(), with_jac=True)
    r, r_ref = ev.residuals[:2].cpu(), ref.residuals
    J, J_ref = ev.jacobian[:2].cpu(), ref.jacobian
    r_rel = float((r - r_ref).abs().max() / r_ref.abs().max())
    j_rel = float((J - J_ref).abs().max() / J_ref.abs().max())
    ns_cpu = ref.nsteps.numpy().reshape(-1)
    ns_dev = np.abs(nsteps[:2] - ns_cpu) / ns_cpu
    print(f"[egfr-sens] CPU cross-check of 2 members: residuals rel "
          f"{r_rel:.3e} (bound 1e-7), Jacobian rel {j_rel:.3e} (bound "
          f"1e-4), nsteps gpu {nsteps[:2].tolist()} cpu {ns_cpu.tolist()}",
          flush=True)
    check(bool((ref.status == 1).all()), "egfr-sens CPU cross-check: status")
    check(r_rel <= 1e-7,
          f"egfr-sens CPU cross-check: residuals rel {r_rel:.3e} > 1e-7")
    check(j_rel <= 1e-4,
          f"egfr-sens CPU cross-check: Jacobian rel {j_rel:.3e} > 1e-4")
    check(bool((ns_dev <= 0.05).all()),
          f"egfr-sens CPU cross-check: nsteps differ by more than 5%: "
          f"{ns_dev}")

    # the golden SciPy trajectory (tests/golden/egfr.npz) on the card,
    # through block-Schur, with the reference's bound
    g = np.load(os.path.join(ROOT, "tests", "golden", "egfr.npz"))
    gres = model.simulate(
        g["p"][None], tuple(g["t_span"]), g["t_eval"],
        config=SolverConfig(rtol=1e-6, atol=1e-9, max_steps=4096,
                            linear_solver="pallas"), device="cuda")
    err = float(np.max(np.abs(gres.ys[0].cpu().numpy() - g["ys"])
                       / (1e-6 + np.max(np.abs(g["ys"])))))
    print(f"[egfr-sens] golden egfr trajectory on the card: err {err:.3e} "
          f"(bound 1e-3), {int(gres.nsteps[0])} steps", flush=True)
    check(int(gres.status[0]) == 1, "egfr golden: status")
    check(err < 1e-3, f"egfr golden: err {err:.3e} >= 1e-3")
    return launches, (proj, theta_true, thetas, ev)


def phase_egfr_fit(card, problem):
    """64 Latin-hypercube starts of the EGFR-scale fit through
    ``make_multistart_runner`` (chunks of 2 LM iterations), at
    ``EGFR_FIT_ITERS`` iterations."""
    import torch

    from tpusysbio_torch import FitConfig
    from tpusysbio_torch.fit import latin_hypercube, make_multistart_runner
    from tpusysbio_torch.linalg import gpu_lu

    proj, theta_true = problem[0], problem[1]
    starts = latin_hypercube(torch.Generator().manual_seed(0), EGFR_BATCH,
                             theta_true - 0.5, theta_true + 0.5)
    run = make_multistart_runner(
        proj.residuals, proj.residuals_and_jacobian,
        FitConfig(max_iter=EGFR_FIT_ITERS, eval_mode="lockstep"),
        iter_chunk=EGFR_ITER_CHUNK)
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    out = run(starts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    by_n = gj_shape_counts("gj_inverse_f32")
    check_schur_launches("egfr-fit", launches, by_n, "gj_inverse_f32",
                         "gj_inverse_major_f32")
    cost = out.cost.cpu().numpy()
    n_finite = int(np.isfinite(cost).sum())
    check(tuple(out.theta.shape) == (EGFR_BATCH, 11)
          and tuple(out.cov.shape) == (EGFR_BATCH, 11, 11),
          f"egfr-fit: shapes {tuple(out.theta.shape)}")
    check(n_finite >= 56,
          f"egfr-fit: only {n_finite}/{EGFR_BATCH} costs are finite")
    best_cost = float(np.nanmin(cost))
    cost_true = float(proj.cost(theta_true))
    status = out.status.cpu().numpy()
    print(f"[egfr-fit] {card}: N={EGFR_BATCH} starts in theta_true +- 0.5, "
          f"{EGFR_FIT_ITERS} lockstep LM iterations (iter_chunk "
          f"{EGFR_ITER_CHUNK}): wall {wall:.2f} s, "
          f"{EGFR_BATCH / wall * 60.0:.2f} fits/min; {n_finite}/"
          f"{EGFR_BATCH} finite costs, {int((status > 0).sum())} converged, "
          f"mean LM iterations {out.n_iter.cpu().numpy().mean():.2f}; best "
          f"cost {best_cost:.6f}, cost at theta_true {cost_true:.6f}; "
          f"launches {launches}, K1 by n {by_n}", flush=True)
    check(best_cost <= cost_true,
          f"egfr-fit: best cost {best_cost} > cost at theta_true "
          f"{cost_true}")
    return launches


def phase_egfr_major(problem):
    """One EGFR evaluation of 16 members under each layout: K3 takes K1's
    place at both block shapes and gives the same bits."""
    import torch

    from tpusysbio_torch.linalg import gpu_lu

    proj, _, thetas, ev64 = problem
    sub = thetas[:EGFR_MAJOR_BATCH]

    def one(layout):
        with gj_layout(layout):
            gpu_lu.reset_launches()
            t0 = time.perf_counter()
            ev = proj.evaluate(sub, with_jac=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            name = ("gj_inverse_major_f32" if layout == "major"
                    else "gj_inverse_f32")
            return ev, dict(gpu_lu.LAUNCHES), gj_shape_counts(name), secs

    minor, l_minor, n_minor, s_minor = one("minor")
    major, l_major, n_major, s_major = one("major")
    check_schur_launches("egfr-major ('minor' run)", l_minor, n_minor,
                         "gj_inverse_f32", "gj_inverse_major_f32")
    check_schur_launches("egfr-major", l_major, n_major,
                         "gj_inverse_major_f32", "gj_inverse_f32")
    check(bool((major.status == 1).all()),
          "egfr-major: not every member finished")
    check(bool(torch.equal(major.residuals, minor.residuals)),
          f"egfr-major: residuals differ between the layouts by "
          f"{float((major.residuals - minor.residuals).abs().max()):.3e}")
    check(bool(torch.equal(major.jacobian, minor.jacobian)),
          "egfr-major: Jacobians differ between the layouts")
    check(bool(torch.equal(major.nsteps, minor.nsteps)),
          "egfr-major: step counts differ between the layouts")
    # a member's result does not depend on who shares its batch: the first
    # 16 of the batch of 64 took the same steps
    same = bool(torch.equal(minor.nsteps, ev64.nsteps[:EGFR_MAJOR_BATCH]))
    print(f"[egfr-major] N={EGFR_MAJOR_BATCH}: 'major' launches {l_major} "
          f"(K3 by n {n_major}) in {s_major:.2f} s, 'minor' launches "
          f"{l_minor} (K1 by n {n_minor}) in {s_minor:.2f} s; residuals, "
          f"Jacobian and step counts equal bit for bit; step counts equal "
          f"to the same members' in the batch of {EGFR_BATCH}: {same}",
          flush=True)
    return l_major


# --------------------------------------------------------------------------
# The small canonical configs: MM-3, Lotka-Volterra, the repressilator and
# JAK-STAT, whose sensitivities come from sens/forward.py
# --------------------------------------------------------------------------

# name -> (library constructor, n): the size of the Newton matrices that K1
# and K2 get from each model
SMALL_MODELS = {"lotka": ("lotka_volterra", 2), "mm3": ("michaelis_menten", 3),
                "jakstat": ("jak_stat", 4),
                "repressilator": ("repressilator", 6)}
SMALL_BATCHES = (64, 256)
# the golden fixtures' step counts through the JAX package's stepper at
# tests/test_sens.py's config (rtol=1e-8, atol=1e-11), on the CPU
GOLDEN_SMALL_NSTEPS = {"mm3": 385, "lotka": 1184, "repressilator": 586,
                       "jakstat": 444}
CLI_CONFIGS = ("mm3", "repressilator", "jakstat", "mapk22", "egfr")
# name -> (library constructor, the sizes at which the Gauss-Jordan kernel
# sees its Newton matrices, whether the fused refined solve serves it):
# EGFR's n=99 is inverted by block-Schur (64 and 35) with the plain
# refinement rounds
CLI_MODELS = {"mm3": ("michaelis_menten", {3}, True),
              "repressilator": ("repressilator", {6}, True),
              "jakstat": ("jak_stat", {4}, True),
              "mapk22": ("mapk_huang_ferrell", {22}, True),
              "egfr": ("egfr_like", {64, 35}, False)}
# The CPU re-polish of the two best starts agrees with the card's to 1e-6,
# except on MAPK-22: its run file's f32 sensitivity columns differ between
# the card and the CPU in the last f32 bits, its polish stops at the
# iteration cap (status 0) and its normal matrix is ill-conditioned (1σ up
# to 6e4 in log space), so the two LM paths part by ~1e-4 in cost (card
# runs at (1, 2), (1, 6), (1, 10) and the run file's depth: 8.4e-5,
# 1.5e-7, 3.4e-5, 8.8e-5). [fit] bounds the same polish at 1e-4; the
# evaluation at the card's polished θ holds the residuals to 1e-7.
CLI_REPOLISH_BOUND = {"mapk22": 1e-3}
# the JAX package on the CPU: tpusysbio.cli._synth_problem at each run
# file's run settings, then Project.cost(theta_true) with its solver section
JAX_COST_AT_TRUTH = {"mm3": 10.819715803190192,
                     "repressilator": 31.82119529969282,
                     "jakstat": 10.574573602722582,
                     "mapk22": 10.819742406027979,
                     "egfr": 55.108902637808086}
# the JAX package's `tpusysbio profile --model mm3 --n-points 3 --span 0.5`
# on the CPU: log-space intervals of k1, km1, k2, E0
JAX_PROFILE_MM3_CI = ((-np.inf, np.inf), (-np.inf, np.inf),
                      (0.29970668, 0.52895956), (-1.06209201, np.inf))
# the JAX package's examples/jakstat_ensemble.py on the CPU (its own
# PRNGKey starts): the best fit's scale factors, its cost and the cost at
# the true parameters
JAX_JAKSTAT_SCALE = (2.81301785, 0.71606616)
JAX_JAKSTAT_COST, JAX_JAKSTAT_TRUTH = 7.653305674400916, 11.217487684572816


def small_model(name, device):
    from tpusysbio_torch.model import library

    return getattr(library, SMALL_MODELS[name][0])(device=device)


def cli_model(name, device):
    from tpusysbio_torch.model import library

    return getattr(library, CLI_MODELS[name][0])(device=device)


def phase_golden_small(card):
    """simulate_sensitivities on the card against the SciPy fixtures of the
    four small models, with tests/test_sens.py's config and bound."""
    import torch

    from tpusysbio_torch import SolverConfig

    for name in ("mm3", "lotka", "repressilator", "jakstat"):
        g = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        model = small_model(name, "cuda")
        t0 = time.perf_counter()
        res = model.simulate_sensitivities(
            g["p"][None], tuple(g["t_span"]), g["t_eval"],
            config=SolverConfig(rtol=1e-8, atol=1e-11), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        errs = {k: float(np.max(np.abs(getattr(res, k)[0].cpu().numpy()
                                        - g[k]))
                         / (1e-6 + np.max(np.abs(g[k]))))
                for k in ("ys", "sens")}
        nsteps = int(res.nsteps[0])
        print(f"[golden-small] {name}: status {int(res.status[0])}, "
              f"{nsteps} steps (the JAX package: "
              f"{GOLDEN_SMALL_NSTEPS[name]}), ys err {errs['ys']:.3e}, sens "
              f"err {errs['sens']:.3e} (bound 1e-5), {wall:.2f} s on {card}",
              flush=True)
        check(int(res.status[0]) == 1, f"golden-small {name}: status")
        check(errs["ys"] < 1e-5 and errs["sens"] < 1e-5,
              f"golden-small {name}: {errs}")
        check(nsteps == GOLDEN_SMALL_NSTEPS[name],
              f"golden-small {name}: {nsteps} steps")


def small_newton(name, rng, batch):
    """Newton matrices I - cJ of a small model: states along its golden
    trajectory, parameters around the fixture's (log-normal, scale 0.2),
    c log-uniform in [1e-3, 3] (the step sizes times the BDF gammas of the
    screen and the polish); J by forward-mode AD on the card."""
    import torch

    g = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
    model = small_model(name, "cuda")
    n = model.n_states
    y = g["ys"][rng.integers(0, len(g["ys"]), batch)]
    p = g["p"][None] * np.exp(rng.normal(scale=0.2, size=(batch,
                                                          model.n_params)))
    t = g["t_eval"][rng.integers(0, len(g["t_eval"]), batch)]
    J = model.jacobian(*(torch.as_tensor(a, device="cuda")
                         for a in (t, y, p)))
    c = torch.as_tensor(10.0 ** rng.uniform(-3.0, np.log10(3.0), batch),
                        device="cuda")
    return torch.eye(n, dtype=torch.float64, device="cuda") \
        - c[:, None, None] * J


def small_registers(source, tag):
    from tpusysbio_torch.linalg import _build

    regs = [r["registers"] for r in
            _build.resource_report(_build.build_info.get("log", ""))
            if r["source"] == source and tag in r["kernel"]]
    return regs[0] if regs else None


def phase_small_kernels(rng):
    """K1 and K2 against their plain versions at n = 2, 3, 4, 6 (Lotka,
    MM-3, JAK-STAT, the repressilator) and B = 64 and 256 on real Newton
    matrices of the models, timed beside the library call and the bound."""
    import torch

    from tpusysbio_torch.linalg import gpu_lu

    k1, k2 = {}, {}
    regs1 = small_registers("gj_inverse.cu", "ILi8ELi1E")
    regs2 = small_registers("refine_solve.cu", "rows_kernelILi8E")
    for name, (_, n) in sorted(SMALL_MODELS.items(), key=lambda kv: kv[1][1]):
        for B in SMALL_BATCHES:
            a = small_newton(name, rng, B)
            a32 = a.to(torch.float32).contiguous()
            got = gpu_lu.gj_inverse_f32(a32)
            ref = gpu_lu.gj_inverse_f32_plain(a32)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"K1-small n={n} B={B}: non-finite")
            rel = float((got - ref).abs().max() / ref.abs().max())
            check(rel <= 1e-4, f"K1-small n={n} B={B}: rel {rel:.3e}")
            ms = cuda_ms(lambda: gpu_lu.gj_inverse_f32(a32), reps=200)
            paced = cuda_ms(lambda: gpu_lu.gj_inverse_f32(a32), reps=200,
                            queued=False)
            plain = cuda_ms(lambda: gpu_lu.gj_inverse_f32_plain(a32),
                            reps=20)
            lib = cuda_ms(lambda: torch.linalg.inv(a32), reps=200)
            b_ms, b_by = bound_ms(2 * B * n * n * 4,
                                  B * n * (n + 2 * n * (n - 1)) / F32_FLOPS)
            k1[f"n{n} B={B}"] = dict(
                model=name, max_abs_err=float((got - ref).abs().max()),
                ms=ms, host_paced_ms=paced, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)
            print(f"[K1-small] {name} n={n} B={B}: max abs err vs plain "
                  f"{k1[f'n{n} B={B}']['max_abs_err']:.3e} (rel {rel:.3e}, "
                  f"bound 1e-4); queued {ms:.4f} ms, host-paced "
                  f"{paced:.4f} ms, plain {plain:.4f} ms, torch.linalg.inv "
                  f"{lib:.4f} ms, bound {b_ms:.7f} ms ({b_by}); "
                  f"{regs1} registers (W=8)", flush=True)

            b = torch.as_tensor(rng.standard_normal((B, n)), device="cuda")
            x32 = gpu_lu.inverse(a32)
            got = gpu_lu.refine_solve(x32, a, b)
            ref = gpu_lu.refine_solve_plain(x32, a, b)
            sol = torch.linalg.solve(a, b)
            torch.cuda.synchronize()
            rel_plain = float((got - ref).abs().max() / ref.abs().max())
            rel_lib = float(((got - sol).abs()
                             / sol.abs().clamp_min(1e-30)).max())
            check(rel_plain <= 1e-12 and rel_lib < 1e-9,
                  f"K2-small n={n} B={B}: rel vs plain {rel_plain:.3e}, "
                  f"vs torch.linalg.solve {rel_lib:.3e}")
            ms = cuda_ms(lambda: gpu_lu.refine_solve(x32, a, b), reps=200)
            paced = cuda_ms(lambda: gpu_lu.refine_solve(x32, a, b), reps=200,
                            queued=False)
            plain = cuda_ms(lambda: gpu_lu.refine_solve_plain(x32, a, b),
                            reps=50)
            lib = cuda_ms(lambda: torch.linalg.solve(a, b), reps=200)
            b_ms, b_by = bound_ms(
                B * (n * n * 4 + n * n * 8 + 2 * n * 8),
                B * 2 * n * n * (4 / F32_FLOPS + 3 / F64_FLOPS))
            k2[f"n{n} B={B}"] = dict(
                model=name, max_abs_err=float((got - ref).abs().max()),
                ms=ms, host_paced_ms=paced, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)
            print(f"[K2-small] {name} n={n} B={B}: max abs err vs plain "
                  f"{k2[f'n{n} B={B}']['max_abs_err']:.3e} (rel "
                  f"{rel_plain:.3e}, bound 1e-12; vs torch.linalg.solve "
                  f"{rel_lib:.3e}, bound 1e-9); queued {ms:.4f} ms, "
                  f"host-paced {paced:.4f} ms, plain {plain:.4f} ms, "
                  f"torch.linalg.solve {lib:.4f} ms, bound {b_ms:.7f} ms "
                  f"({b_by}); {regs2} registers (W=8)", flush=True)
    return k1, k2


def config_path(name, tmpdir, depth):
    """The run file ``configs/<name>.yaml``, or with ``depth = (screen,
    polish)`` a copy in ``tmpdir`` whose two LM iteration caps are cut to
    those (every other setting, the width included, as in the file)."""
    import re

    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    if depth is None:
        return path
    with open(path) as fh:
        text = fh.read()
    for section, iters in zip(("screen_fit", "fit"), depth):
        text, k = re.subn(rf"(?m)^({section}:\n  max_iter: )\d+",
                          lambda m: m.group(1) + str(iters), text)
        check(k == 1, f"{path}: no '{section}: max_iter' to cut")
    out = os.path.join(tmpdir, f"{name}.yaml")
    with open(out, "w") as fh:
        fh.write(text)
    return out


def phase_cli(name, card, tmpdir, depth, blocks=None):
    """``tpusysbio_torch.cli.main(["multistart", "--config", ...])`` in
    process: the run file's width (starts, top_k) and run settings; its LM
    depth, or ``depth``. Returns the launches and the run's arrays
    (``polish_arrays``), with ``blocks`` those of ``block_reference`` over
    ``blocks`` blocks beside them."""
    import torch

    from tpusysbio_torch import cli
    from tpusysbio_torch.config import load_config
    from tpusysbio_torch.fit import make_multistart_runner
    from tpusysbio_torch.linalg import gpu_lu

    path = config_path(name, tmpdir, depth)
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    out = cli.main(["multistart", "--config", path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    by_n = gj_shape_counts("gj_inverse_f32")
    rec = out["record"]
    _, sizes, with_k2 = CLI_MODELS[name]
    best, truth = rec["best_cost"], out["cost_at_truth"]
    truth_rel = abs(truth - JAX_COST_AT_TRUTH[name]) / JAX_COST_AT_TRUTH[name]
    polish = out["polish"]
    p_it = polish.n_iter.cpu().numpy()
    print(f"[cli-{name}] {card}: {rec['starts']} starts, top_k "
          f"{rec['top_k']}, LM iterations {depth or 'of the run file'}: "
          f"wall {wall:.2f} s ({rec['starts'] / wall * 60.0:.1f} starts/min); "
          f"best cost {best:.6f}, cost at truth {truth:.9f} (the JAX "
          f"package: {JAX_COST_AT_TRUTH[name]:.9f}, rel {truth_rel:.2e}); "
          f"polish statuses {polish.status.cpu().numpy().tolist()}, mean LM "
          f"iterations {p_it.mean():.2f}; launches {launches}, K1 by n "
          f"{by_n}", flush=True)
    check(np.isfinite(best) and best <= truth * (1 + 1e-6),
          f"cli-{name}: best cost {best} > cost at truth {truth}")
    check(truth_rel <= 1e-6, f"cli-{name}: cost at truth rel {truth_rel}")
    check(launches["gj_inverse_f32"] > 0
          and (launches["refine_solve"] > 0) == with_k2,
          f"cli-{name}: K1{' and K2' if with_k2 else ''} must launch"
          f"{'' if with_k2 else ', K2 not (n > 64)'}: {launches}")
    check(launches["gj_inverse_major_f32"] == 0 and set(by_n) == sizes,
          f"cli-{name}: launches {launches}, by n {by_n}")

    # the tight project at the two best polished θ on the CPU: the same
    # inputs give the same residuals (the f64 state column) and Jacobian
    # (f64 columns; f32 ones, whose error no step control bounds, to 1e-3)
    ranked = polish.ranked()
    proj = out["project"]
    cpu = project_on_cpu(proj, cli_model(name, "cpu"))
    ev_dev = proj.evaluate(ranked.theta[:2], with_jac=True)
    ev_cpu = cpu.evaluate(ranked.theta[:2].cpu(), with_jac=True)
    r_rel = rel_err(ev_dev.residuals.cpu().numpy(), ev_cpu.residuals.numpy())
    j_rel = rel_err(ev_dev.jacobian.cpu().numpy(), ev_cpu.jacobian.numpy())
    j_bound = 1e-3 if proj.config.sens_precision == "f32" else 1e-4
    print(f"[cli-{name}] the two best polished theta evaluated again on the "
          f"CPU: residuals rel {r_rel:.3e} (bound 1e-7), Jacobian rel "
          f"{j_rel:.3e} (bound {j_bound:g})", flush=True)
    check(bool(torch.equal(ev_dev.status.cpu(), ev_cpu.status))
          and r_rel <= 1e-7 and j_rel <= j_bound,
          f"cli-{name}: CPU evaluation residuals {r_rel:.3e}, Jacobian "
          f"{j_rel:.3e}")

    # the two best polished members' starts polished again on the CPU
    rerun = make_multistart_runner(
        cpu.residuals, cpu.residuals_and_jacobian, out["polish_config"],
        iter_chunk=load_config(path).run.get("iter_chunk"))(
            ranked.theta0[:2].cpu())
    cpu_cost = rerun.cost.numpy()
    card_cost = ranked.cost[:2].cpu().numpy()
    rel = float(np.max(np.abs(cpu_cost - card_cost) / card_cost))
    bound = CLI_REPOLISH_BOUND.get(name, 1e-6)
    print(f"[cli-{name}] the two best polish starts polished again on the "
          f"CPU: costs {cpu_cost.tolist()} against the card's "
          f"{card_cost.tolist()}, rel {rel:.3e} (bound {bound:g})",
          flush=True)
    check(rel <= bound, f"cli-{name}: CPU re-polish rel {rel:.3e}")
    arrs = polish_arrays(out)
    if blocks:
        t0 = time.perf_counter()
        arrs["blocks"] = block_reference(
            out, load_config(path).run.get("iter_chunk"), blocks)
        print(f"[cli-{name}] the same fit in {blocks} blocks of the starts "
              f"and of the top_k (the sharded fit's reference): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    return launches, arrs


def polish_arrays(out):
    """A ``multistart`` run's screen and polish as numpy arrays: every
    start's screened status and cost, and the polished members in polish
    order, each with the index of its start. The polish starts from the
    screened θ of the top_k starts (``_rank_order`` of the screen, as
    ``TwoPhaseDriver.run`` ranks it), whose bits may depend on the batch
    the screen ran in, so the start index names the member."""
    import torch

    from tpusysbio_torch.fit.multistart import _rank_order

    screen, polish = out["screen"], out["polish"]
    top = _rank_order(screen.status, screen.cost)[:polish.cost.shape[0]]
    check(bool(torch.equal(polish.theta0, screen.theta[top])),
          "the polish did not start from the screen's ranked top_k")
    return {"start": top.cpu().numpy(),
            "screen_cost": screen.cost[top].cpu().numpy(),
            "status": polish.status.cpu().numpy(),
            "cost": polish.cost.cpu().numpy(),
            "all_screen_status": screen.status.cpu().numpy(),
            "all_screen_cost": screen.cost.cpu().numpy()}


def block_reference(out, iter_chunk, n_blocks):
    """What ``TwoPhaseDriver(mesh=)`` computes over ``n_blocks`` ranks,
    in one process and by other code: the screen's contiguous blocks fitted
    one after the other and joined, ranked whole, the top_k's blocks
    polished one after the other. Returns ``polish_arrays``' dict."""
    import types

    import torch

    from tpusysbio_torch.fit import make_multistart_runner
    from tpusysbio_torch.fit.multistart import _rank_order

    def blocks(proj, config, theta, with_cov):
        run = make_multistart_runner(
            proj.residuals, proj.residuals_and_jacobian, config,
            iter_chunk=iter_chunk, with_cov=with_cov)
        parts = [run(b) for b in theta.chunk(n_blocks)]
        return types.SimpleNamespace(**{
            k: torch.cat([getattr(p, k) for p in parts])
            for k in ("status", "cost", "theta")}, theta0=theta)

    top_k = out["polish"].cost.shape[0]
    screen = blocks(out["screen_project"], out["screen_config"],
                    out["starts"], False)
    top = _rank_order(screen.status, screen.cost)[:top_k]
    polish = blocks(out["project"], out["polish_config"], screen.theta[top],
                    True)
    return polish_arrays({"screen": screen, "polish": polish})


def by_start(arrs):
    """A polish's (status, cost) by start index."""
    return {int(i): (int(st), float(c)) for i, st, c in zip(
        arrs["start"], arrs["status"], arrs["cost"])}


def phase_jakstat_ensemble(card, max_iter):
    """``cli.main(["fit", "--example", "jakstat"])`` twice: the two-dose
    ensemble with shared k1-k4, local amp and two scale groups; with
    ``max_iter``, at that LM depth (``--max-iter``)."""
    import torch

    from tpusysbio_torch import cli
    from tpusysbio_torch.linalg import gpu_lu

    depth = [] if max_iter is None else ["--max-iter", str(max_iter)]
    runs = []
    for _ in range(2):
        gpu_lu.reset_launches()
        t0 = time.perf_counter()
        out = cli.main(["fit", "--example", "jakstat"] + depth)
        torch.cuda.synchronize()
        runs.append((out, time.perf_counter() - t0, dict(gpu_lu.LAUNCHES)))
    (a, wall, launches), (b, wall2, _) = runs
    same = {k: bool(np.array_equal(a[k], b[k]))
            for k in ("scale", "theta", "cost")}
    print(f"[jakstat-ensemble] {card}: LM iterations "
          f"{max_iter or 'of the example (60)'}; best status "
          f"{a['status']}, cost {a['cost']:.6f} (at truth "
          f"{a['cost_at_truth']:.6f}; the JAX example: "
          f"{JAX_JAKSTAT_COST:.6f} at truth {JAX_JAKSTAT_TRUTH:.6f}"
          f"); scale factors {a['scale'].tolist()} (the JAX example: "
          f"{list(JAX_JAKSTAT_SCALE)}); wall {wall:.2f} s and {wall2:.2f} "
          f"s; the second run bitwise equal: {same}; launches {launches}",
          flush=True)
    # a converged best fit is asked of the example's own depth; at a cut
    # depth the best member may still be iteration-capped (status 0)
    check(a["status"] > 0 if max_iter is None else a["status"] >= 0,
          f"jakstat-ensemble: status {a['status']}")
    check(a["cost"] <= a["cost_at_truth"],
          f"jakstat-ensemble: cost {a['cost']} > {a['cost_at_truth']}")
    check(abs(a["cost_at_truth"] - JAX_JAKSTAT_TRUTH) <= 1e-6
          * JAX_JAKSTAT_TRUTH, "jakstat-ensemble: cost at truth")
    check(all(same.values()),
          f"jakstat-ensemble: the two runs differ in {same}")
    return same


def phase_profile_mm3(card, fit_iters):
    """``cli.main(["profile", "--model", "mm3", "--n-points", "3",
    "--span", "0.5"])``, the other flags at the CLI's defaults, or with
    ``--fit-iters fit_iters``."""
    import torch

    from tpusysbio_torch import cli
    from tpusysbio_torch.linalg import gpu_lu

    depth = [] if fit_iters is None else ["--fit-iters", str(fit_iters)]
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    out = cli.main(["profile", "--model", "mm3", "--n-points", "3",
                    "--span", "0.5"] + depth)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    costs, ci = out["costs"], out["ci"]
    ref = np.asarray(JAX_PROFILE_MM3_CI)
    center = costs[:, costs.shape[1] // 2]
    same_inf = bool((np.isfinite(ci) == np.isfinite(ref)).all())
    diff = np.where(np.isfinite(ref) & np.isfinite(ci), np.abs(ci - ref), 0.0)
    print(f"[profile-mm3] {card}: LM iterations "
          f"{fit_iters or 'of the CLI (40)'}; wall {wall:.2f} s; fit cost "
          f"{out['record']['fit_cost']:.9f}; unconverged points "
          f"{out['record']['unconverged_points']}; CIs (log space) "
          f"{ci.tolist()} against the JAX CLI's {ref.tolist()}: diff "
          f"{diff.tolist()} (bound 1e-3 on k2's), unbounded sides equal "
          f"{same_inf}; launches {launches}", flush=True)
    check(bool(np.isfinite(costs).all()), "profile-mm3: non-finite cost")
    check(launches["gj_inverse_f32"] > 0 and launches["refine_solve"] > 0,
          f"profile-mm3: K1 and K2 must both launch: {launches}")
    check(bool((costs.min(axis=1) >= center * (1 - 1e-4)).all()),
          "profile-mm3: a row dips below its center")
    # k1 and km1 are identified only together: along that flat valley a
    # pinned re-fit of E0 may end at either end (k1 ~ 20 or ~1e6, the same
    # cost), which moves E0's lower bound between -1.06 and -0.95 with
    # rounding alone (the port on the CPU reaches both, with the 'inv32'
    # and 'pallas' solvers). k2's interval does not depend on it.
    check(same_inf and float(diff[2].max()) <= 1e-3,
          f"profile-mm3: CIs {ci.tolist()} against {ref.tolist()}")
    return launches


# --------------------------------------------------------------------------
# Timed inputs and pre-equilibration: the segment loop and the steady-state
# solve of Project (solvers/steady_state.py)
# --------------------------------------------------------------------------

PULSE_BATCH = 256
PULSE_FIT_ITERS = 1         # the example's 80 (the JAX fit stops at 13,
#                             ~2 evaluations of ~635 steps an iteration);
#                             the first trial step is rejected, as in the
#                             JAX fit (the iterate leaves the start at 5)
PREEQ_BATCH = 64
# the JAX package's examples/jakstat_pulse.py on the CPU: its lm_fit from
# theta_true + 0.7 (log space), at PULSE_FIT_ITERS and at the example's 80
# iterations: (status, cost, theta); and its cost at the true parameters
JAX_PULSE_TRUTH = 5.623395617218944
JAX_PULSE_FIT = {
    None: (2, 4.593483371780147,
           (0.9325519867911326, 1.4453279347345191, -1.2115476031304082,
            -0.4821132308360633)),
    PULSE_FIT_ITERS: (0, 1685.5560729623653,
                      (1.616290731874155, 2.0862943611198905,
                       -0.5039728043259362, 0.18917437623400923))}


def rel_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def phase_pulse(card, max_iter):
    """The stimulus-and-washout example (``examples.jakstat_pulse_*``):
    its LM fit from θ_true + 0.7 at ``max_iter`` iterations (None: the
    example's 80) against the JAX example's fit at that depth; then one
    ``evaluate(with_jac=True)`` of its project at PULSE_BATCH
    Latin-hypercube θ under ``linear_solver='pallas'`` with
    ``sens_precision='f32'`` (three segments; K1 on every factorization,
    K2 on every solve of the f64 state column), 2 members re-run on the
    CPU."""
    import dataclasses

    import torch

    from tpusysbio_torch import examples
    from tpusysbio_torch.fit import latin_hypercube
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    t0 = time.perf_counter()
    out = examples.jakstat_pulse_fit(device="cuda", max_iter=max_iter)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    j_status, j_cost, j_theta = JAX_PULSE_FIT[max_iter]
    cost_rel = abs(out["cost"] - j_cost) / j_cost
    th_err = float(np.max(np.abs(out["theta"] - np.asarray(j_theta))))
    truth_rel = abs(out["cost_at_truth"] - JAX_PULSE_TRUTH) / JAX_PULSE_TRUTH
    print(f"[pulse] {card}: fit from theta_true + 0.7, LM iterations "
          f"{max_iter or 'of the example (80)'}: status {out['status']} "
          f"after {out['n_iter']} iterations, cost {out['cost']:.9f} (the "
          f"JAX example: {j_cost:.9f}, rel {cost_rel:.2e}), theta max abs "
          f"diff {th_err:.2e}; cost at truth {out['cost_at_truth']:.9f} "
          f"(JAX {JAX_PULSE_TRUTH:.9f}, rel {truth_rel:.2e}); wall "
          f"{fit_wall:.2f} s (with the data's simulation)", flush=True)
    check(truth_rel <= 1e-6, f"pulse: cost at truth rel {truth_rel:.2e}")
    check(out["status"] == j_status, f"pulse: fit status {out['status']}")
    check(cost_rel <= 1e-6 and th_err <= 1e-6,
          f"pulse: fit cost rel {cost_rel:.2e}, theta {th_err:.2e}")
    if max_iter is None:
        check(out["status"] > 0 and out["cost"] <= out["cost_at_truth"],
              f"pulse: status {out['status']}, cost {out['cost']} > "
              f"{out['cost_at_truth']}")

    proj = out["project"]
    pallas = dataclasses.replace(proj, config=dataclasses.replace(
        proj.config, linear_solver="pallas", sens_precision="f32"))
    theta_true = torch.as_tensor(out["theta_true"], device="cuda")
    thetas = latin_hypercube(torch.Generator().manual_seed(0), PULSE_BATCH,
                             theta_true - 0.5, theta_true + 0.5)
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    ev = pallas.evaluate(thetas, with_jac=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    status = ev.status.cpu().numpy()
    nsteps = ev.nsteps.cpu().numpy()
    print(f"[pulse] N={PULSE_BATCH} evaluations with Jacobian (3 segments, "
          f"pallas, f32 sensitivities): {wall:.2f} s, "
          f"{int((status == 1).sum())}/{PULSE_BATCH} status 1, mean steps "
          f"{nsteps.mean():.2f}; launches {launches}, K1 by n "
          f"{gj_shape_counts('gj_inverse_f32')}", flush=True)
    check(bool((status == 1).all()), "pulse: not every member finished")
    check(bool(torch.isfinite(ev.residuals).all()
               and torch.isfinite(ev.jacobian).all()),
          "pulse: non-finite residuals or Jacobian")
    check(launches["gj_inverse_f32"] > 0 and launches["refine_solve"] > 0
          and launches["gj_inverse_major_f32"] == 0,
          f"pulse: K1 and K2 must launch: {launches}")

    cpu = project_on_cpu(pallas, library.jak_stat(device="cpu"))
    ref = cpu.evaluate(thetas[:2].cpu(), with_jac=True)
    r_rel = rel_err(ev.residuals[:2].cpu().numpy(), ref.residuals.numpy())
    j_rel = rel_err(ev.jacobian[:2].cpu().numpy(), ref.jacobian.numpy())
    print(f"[pulse] CPU cross-check of 2 members: residuals rel "
          f"{r_rel:.3e} (bound 1e-7), Jacobian rel {j_rel:.3e} (bound "
          f"1e-4), steps {nsteps[:2].ravel().tolist()} against "
          f"{ref.nsteps.numpy().ravel().tolist()}", flush=True)
    check(bool(torch.equal(ev.status[:2].cpu(), ref.status)),
          "pulse CPU cross-check: status")
    check(r_rel <= 1e-7 and j_rel <= 1e-4,
          f"pulse CPU cross-check: residuals {r_rel:.3e}, Jacobian "
          f"{j_rel:.3e}")
    return launches


def inflow_model(device):
    """Two-state inflow chain ``y1' = v - d1 y1``, ``y2' = k y1 - d2 y2``
    with the unique steady state (v/d1, k v/(d1 d2)): tests/test_events.py's
    pre-equilibration model."""
    import torch

    from tpusysbio_torch.model.core import OdeModel

    def rhs(t, y, p):
        return torch.stack([p[:, 0] - p[:, 1] * y[:, 0],
                            p[:, 2] * y[:, 0] - p[:, 3] * y[:, 1]], dim=-1)

    names = ("v", "d1", "k", "d2")
    return OdeModel(name="inflow2", n_states=2, n_params=4, n_obs=2,
                    rhs=rhs, y0=lambda p: 0.0 * p[:, :2] + 0.2,
                    observables=lambda y, p: y, param_names=names,
                    state_names=("y1", "y2"))


def inflow_exact(p, y0, t):
    """The inflow chain's closed-form solution at times ``t`` (d1 != d2)."""
    v, d1, k, d2 = p
    a1 = v / d1
    c = y0[0] - a1
    a2 = k * a1 / d2
    A = k * c / (d2 - d1)
    y1 = a1 + c * np.exp(-d1 * t)
    y2 = a2 + A * np.exp(-d1 * t) + (y0[1] - a2 - A) * np.exp(-d2 * t)
    return np.stack([y1, y2], 1)


def phase_preeq(card):
    """The two-experiment dose step of tests/test_events.py (one experiment
    pre-equilibrated under a basal inflow v=0.5, one started from y0),
    residuals against the exact solution with sigma 1; steady-state
    pre-integration and trajectories under ``linear_solver='pallas'``.
    At rtol=1e-9 the residuals at the true parameters are the integration
    error; at rtol=1e-6, PREEQ_BATCH θ with Jacobian (the steady-state
    solve accepts r < 1e-9 on a residual scaled by atol + rtol |y|, which
    at rtol=1e-9 lies below the rounding floor of f(y*): there the flag is
    rounding's, in the reference too)."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.fit import latin_hypercube
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.project import ParameterMap, Project

    p_true = np.array([2.0, 0.5, 1.0, 0.25])
    t = np.linspace(0.5, 8.0, 7)
    exact = {"dose": inflow_exact(p_true, [1.0, 4.0], t),
             "naive": inflow_exact(p_true, [0.2, 0.2], t)}

    def meas(data):
        return tuple(Measurement(obs_index=i, times=t, values=data[:, i],
                                 sigmas=np.ones(len(t))) for i in range(2))

    model = inflow_model("cuda")
    exps = [Experiment("dose", meas(exact["dose"]), preequilibrate=True,
                       preeq_params={"v": 0.5}),
            Experiment("naive", meas(exact["naive"]))]
    batch = ExperimentBatch.from_experiments(
        exps, param_names=model.param_names, device="cuda")
    pmap = ParameterMap.create(model.param_names, 2,
                               shared=model.param_names, device="cuda")
    theta_true = pmap.pack(dict(zip(model.param_names, p_true)))

    def project(rtol, atol):
        return Project(model=model, pmap=pmap, batch=batch, ss_t_relax=20.0,
                       config=SolverConfig(rtol=rtol, atol=atol,
                                           linear_solver="pallas"))

    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    tight = project(1e-9, 1e-12).evaluate(theta_true[None])
    thetas = latin_hypercube(torch.Generator().manual_seed(0), PREEQ_BATCH,
                             theta_true - 0.5, theta_true + 0.5)
    thetas[0] = theta_true
    proj = project(1e-6, 1e-9)
    ev = proj.evaluate(thetas, with_jac=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    r_truth = float(tight.residuals.abs().max())
    status = ev.status.cpu().numpy()
    print(f"[preeq] {card}: at rtol=1e-9 max |residual| at the true "
          f"parameters {r_truth:.3e} (bound 1e-6; statuses "
          f"{tight.status.cpu().numpy().ravel().tolist()}); N={PREEQ_BATCH} "
          f"evaluations with Jacobian at rtol=1e-6: statuses (dose, naive) "
          f"all 1: {bool((status == 1).all())}, mean steps "
          f"{ev.nsteps.float().mean(0).cpu().numpy().round(2).tolist()}; "
          f"{wall:.2f} s; launches {launches}", flush=True)
    check(r_truth < 1e-6, f"preeq: residual at truth {r_truth:.3e}")
    check(bool((status == 1).all()),
          f"preeq: statuses {np.unique(status, return_counts=True)}")
    check(bool(torch.isfinite(ev.jacobian).all()), "preeq: non-finite J")
    check(launches["gj_inverse_f32"] > 0 and launches["refine_solve"] > 0
          and launches["gj_inverse_major_f32"] == 0,
          f"preeq: K1 and K2 must launch: {launches}")

    cpu = project_on_cpu(proj, inflow_model("cpu"))
    ref = cpu.evaluate(thetas[:2].cpu(), with_jac=True)
    r_rel = rel_err(ev.residuals[:2].cpu().numpy(), ref.residuals.numpy())
    j_rel = rel_err(ev.jacobian[:2].cpu().numpy(), ref.jacobian.numpy())
    print(f"[preeq] CPU cross-check of 2 members: residuals rel {r_rel:.3e}"
          f" (bound 1e-7), Jacobian rel {j_rel:.3e} (bound 1e-4)",
          flush=True)
    check(bool(torch.equal(ev.status[:2].cpu(), ref.status)),
          "preeq CPU cross-check: status")
    check(r_rel <= 1e-7 and j_rel <= 1e-4,
          f"preeq CPU cross-check: residuals {r_rel:.3e}, Jacobian "
          f"{j_rel:.3e}")
    return launches


# --------------------------------------------------------------------------
# EGFR-10k: config 5 at its literal scale (bench/experiments/egfr_10k.py)
# --------------------------------------------------------------------------

EGFR10K_CHUNK = 512
EGFR10K_TOP_K = 64


def phase_egfr_10k(card, n_starts=10000):
    """The ``bench/egfr_bench.py`` problem, ``n_starts`` Latin-hypercube
    starts in θ_true ± 0.5 screened in chunks of 512 by 5 LM iterations on
    the f32 stepper (rtol=1e-3, step cap 136, rank channels), the best 64
    polished by 10 at rtol=1e-6, through ``TwoPhaseDriver`` after its
    warm-up. Not called by ``main()``: a call of its own."""
    import dataclasses

    import torch

    from tpusysbio_torch import FitConfig, SolverConfig
    from tpusysbio_torch.fit import TwoPhaseDriver, latin_hypercube
    from tpusysbio_torch.linalg import gpu_lu

    proj_tight, theta_true = build_egfr_problem("cuda")
    proj_screen = dataclasses.replace(proj_tight, config=SolverConfig(
        rtol=1e-3, atol=1e-6, max_steps=136, linear_solver="pallas",
        mixed_precision=True))
    starts = latin_hypercube(torch.Generator().manual_seed(0), n_starts,
                             theta_true - 0.5, theta_true + 0.5)
    chunk = EGFR10K_CHUNK if n_starts > EGFR10K_CHUNK else None
    driver = TwoPhaseDriver(
        (proj_screen.residuals, proj_screen.residuals_and_jacobian),
        (proj_tight.residuals, proj_tight.residuals_and_jacobian),
        FitConfig(max_iter=5, eval_mode="lockstep", ftol=1e-4, xtol=1e-4),
        FitConfig(max_iter=10, eval_mode="lockstep"), EGFR10K_TOP_K,
        polish_iter_chunk=2, chunk_size=chunk, screen_channels="rank",
        run_tag="egfr10k")
    warm = driver.warmup(theta_true)
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    polish, screen, info = driver.run(starts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    by_n = gj_shape_counts("gj_inverse_f32")
    best = float(polish.ranked().cost[0])
    cost_true = float(proj_tight.cost(theta_true))
    status = screen.status
    converged = int((np.asarray(status.cpu() if isinstance(
        status, torch.Tensor) else status) > 0).sum())
    print(f"[egfr-10k] {card}: {n_starts} starts (chunks of {chunk}, "
          f"{info['n_pad']} padded) -> top {EGFR10K_TOP_K}: wall {wall:.2f} "
          f"s (screen {info['screen_seconds']:.2f} s, polish "
          f"{info['polish_seconds']:.2f} s; warm-up {warm:.2f} s), "
          f"{n_starts / wall * 60.0:.1f} starts/min; screened converged "
          f"{converged}/{n_starts}; best cost {best:.6f}, cost at theta_true"
          f" {cost_true:.6f}; launches {launches}, K1 by n {by_n}",
          flush=True)
    check(best <= cost_true,
          f"egfr-10k: best cost {best} > cost at theta_true {cost_true}")
    return {"wall": wall, "launches": launches, "best": best,
            "cost_at_truth": cost_true, **info}


# --------------------------------------------------------------------------
# Bounded and robust fitting (optim/trf.py, optim/loss.py) and ensemble MCMC
# through the CLI's sample (fit/mcmc.py)
# --------------------------------------------------------------------------

FIT_TRF_ITERS = 2           # TRF iterations of [fit-trf] (own depth: 20,
#                             the headline polish's); its gates hold at 2
FIT_TRF_ROBUST = 4          # members of the 'svd' / 'soft_l1' run
SAMPLE_STEPS = 2            # [sample-mm3] sweeps (the CLI's 400), of which
SAMPLE_BURN = 1             # the first is burned (the CLI's 100)
SAMPLE_FIT_ITERS = 2        # --fit-iters (the CLI's 40; the fit stops at 13)
# the JAX CLI's fit_cost for `sample --model mm3 --fit-iters N` on the CPU
# (tpusysbio.cli.main(["--cpu", "sample", "--model", "mm3", "--fit-iters",
# N, ...]); the walkers and sweeps do not enter the fit)
JAX_SAMPLE_FIT_COST = {2: 10.479623649434698, 40: 10.470494519662243}


def phase_fit_trf(card, problem, fit_top, iters):
    """``multistart_trf`` on the tight MAPK-22 ``Project`` from [fit]'s 16
    best screened points, bounded to θ_true ± 1, ``iters`` TRF iterations;
    then the first ``FIT_TRF_ROBUST`` of them with ``subproblem='svd'`` and
    ``loss='soft_l1'``. Each run is repeated on the CPU from the same
    points, and the tight evaluation at the card's two best θ too."""
    import torch

    from tpusysbio_torch import FitConfig
    from tpusysbio_torch.fit import multistart_trf
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    tight, _, theta_true, _ = problem
    top, lm_best = fit_top
    lb, ub = theta_true - 1.0, theta_true + 1.0
    cfg = FitConfig(max_iter=iters)
    cpu = project_on_cpu(tight, library.mapk_huang_ferrell(device="cpu"))
    cost_true = float(tight.cost(theta_true))
    runs = {"normal/linear": dict(), "svd/soft_l1": dict(
        subproblem="svd", loss="soft_l1")}
    launches = dict.fromkeys(gpu_lu.LAUNCHES, 0)
    results = {}
    for tag, kw in runs.items():
        x0 = top if not kw else top[:FIT_TRF_ROBUST]
        gpu_lu.reset_launches()
        t0 = time.perf_counter()
        res = multistart_trf(tight.residuals, tight.residuals_and_jacobian,
                             x0, lb, ub, cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, v in gpu_lu.LAUNCHES.items():
            launches[k] += v
        l_run = dict(gpu_lu.LAUNCHES)
        results[tag] = res
        th, cost = res.theta.cpu(), res.cost.cpu().numpy()
        status = res.status.cpu().numpy()
        trace = res.cost_trace.cpu().numpy()
        best_by_iter = trace.min(axis=0)
        inside = bool(((th > lb.cpu()) & (th < ub.cpu())).all())
        print(f"[fit-trf] {card}: {tag}, {x0.shape[0]} members x {iters} "
              f"TRF iterations in the box theta_true +- 1: wall {wall:.2f} "
              f"s; statuses {status.tolist()}, iterations "
              f"{res.n_iter.cpu().numpy().tolist()}; best cost "
              f"{float(cost.min()):.6f} by iteration "
              f"{[float(f'{c:.6f}') for c in best_by_iter]} (the LM "
              f"polish's best {lm_best:.6f}, cost at theta_true "
              f"{cost_true:.6f}); every theta strictly inside: {inside}; "
              f"launches {l_run}", flush=True)
        check(inside, f"fit-trf {tag}: a theta left the box")
        check(bool((status >= 0).all()) and bool(np.isfinite(cost).all()),
              f"fit-trf {tag}: statuses {status.tolist()}")
        check(bool((np.diff(best_by_iter) <= 0).all()),
              f"fit-trf {tag}: the best cost rose: {best_by_iter.tolist()}")
        check(l_run["gj_inverse_f32"] > 0 and l_run["refine_solve"] > 0
              and l_run["gj_inverse_major_f32"] == 0,
              f"fit-trf {tag}: K1 and K2 must launch: {l_run}")

        # the same TRF iterations on the CPU from the card's input points
        # (the best four by the card's cost)
        sel = np.argsort(cost, kind="stable")[:4].tolist()
        t0 = time.perf_counter()
        again = multistart_trf(cpu.residuals, cpu.residuals_and_jacobian,
                               x0[sel].cpu(), lb.cpu(), ub.cpu(), cfg, **kw)
        rel = float(np.max(np.abs(again.cost.numpy() - cost[sel])
                           / cost[sel]))
        same = bool(np.array_equal(again.status.numpy(), status[sel]))
        print(f"[fit-trf] {tag}: the same iterations on the CPU from the "
              f"card's input points (members {sel}, "
              f"{time.perf_counter() - t0:.2f} s): statuses equal {same}, "
              f"cost rel {rel:.3e} (bound 1e-4, the bound of [fit]'s "
              f"polish)", flush=True)
        check(same and rel <= 1e-4,
              f"fit-trf {tag}: CPU re-run statuses {same}, cost {rel:.3e}")

    # the tight evaluation at the card's two best theta, again on the CPU
    best2 = results["normal/linear"].ranked().theta[:2]
    ev_dev = tight.evaluate(best2, with_jac=True)
    ev_cpu = cpu.evaluate(best2.cpu(), with_jac=True)
    r_rel = rel_err(ev_dev.residuals.cpu().numpy(), ev_cpu.residuals.numpy())
    j_rel = rel_err(ev_dev.jacobian.cpu().numpy(), ev_cpu.jacobian.numpy())
    print(f"[fit-trf] the two best theta evaluated again on the CPU: "
          f"residuals rel {r_rel:.3e} (bound 1e-7), Jacobian rel "
          f"{j_rel:.3e} (bound 1e-4)", flush=True)
    check(bool(torch.equal(ev_dev.status.cpu(), ev_cpu.status))
          and r_rel <= 1e-7 and j_rel <= 1e-4,
          f"fit-trf: CPU evaluation residuals {r_rel:.3e}, Jacobian "
          f"{j_rel:.3e}")
    return launches


def phase_sample_mm3(card, steps, burn, fit_iters):
    """``cli.main(["sample", "--model", "mm3", ...])`` at the CLI's 32
    walkers, ``steps`` sweeps and ``--fit-iters fit_iters``; then the same
    command with ``--cpu``."""
    import torch

    from tpusysbio_torch import cli
    from tpusysbio_torch.linalg import gpu_lu

    argv = ["sample", "--model", "mm3", "--steps", str(steps), "--burn",
            str(burn), "--fit-iters", str(fit_iters)]
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    t0 = time.perf_counter()
    on_cpu = cli.main(["--cpu"] + argv)
    wall_cpu = time.perf_counter() - t0
    rec, chain, lp = out["record"], out["chain"], out["log_prob"]
    ref = JAX_SAMPLE_FIT_COST.get(fit_iters)
    fit_rel = (abs(rec["fit_cost"] - ref) / ref if ref is not None
               else float("nan"))
    # every walker is an affine combination of the start walkers with
    # weights summing to 1, so an offset of the fit moves the whole chain
    # by it: the chains are compared relative to their fits
    fit_dev = out["fit"].theta[0].cpu().numpy()
    fit_cpu = on_cpu["fit"].theta[0].numpy()
    fit_gap = float(np.max(np.abs(fit_dev - fit_cpu)))
    raw_gap = float(np.max(np.abs(chain - on_cpu["chain"])))
    rel_gap = float(np.max(np.abs((chain - fit_dev)
                                  - (on_cpu["chain"] - fit_cpu))))
    lp_gap = float(np.max(np.abs(lp - on_cpu["log_prob"])))
    sigma = out["samples"].std(axis=0)
    lm_sigma = out["fit"].param_sigma[0].cpu().numpy()
    # the rows carry 1/sigma, so the Laplace covariance is (JᵀJ)⁻¹ itself;
    # param_sigma scales it by the reduced chi-square
    lap_sigma = np.sqrt(np.diag(out["fit"].cov[0].cpu().numpy()))
    print(f"[sample-mm3] {card}: {rec['walkers']} walkers, {steps} sweeps "
          f"(burn {burn}), --fit-iters {fit_iters}: wall {wall:.2f} s (the "
          f"CPU {wall_cpu:.2f} s); fit_cost {rec['fit_cost']:.12f} (the JAX "
          f"CLI's {ref}, rel {fit_rel:.2e}); mean acceptance "
          f"{rec['mean_acceptance']}, max tau {rec['max_autocorr_time']}; "
          f"posterior sigma {sigma.tolist()} against the LM Laplace sigma "
          f"sqrt(diag(cov)) {lap_sigma.tolist()} (param_sigma "
          f"{lm_sigma.tolist()}); launches {launches}", flush=True)
    print(f"[sample-mm3] the same command with --cpu: fit theta apart by "
          f"{fit_gap:.3e}; chains apart by {raw_gap:.3e}, relative to their "
          f"fits by {rel_gap:.3e} (bound 1e-8); log-probs by {lp_gap:.3e}",
          flush=True)
    check(chain.shape == (steps, 32, 4) and lp.shape == (steps, 32),
          f"sample-mm3: chain shape {chain.shape}")
    check(bool(np.isfinite(lp).all()), "sample-mm3: a log-prob not finite")
    check(ref is None or fit_rel <= 1e-6,
          f"sample-mm3: fit_cost rel {fit_rel:.3e} to the JAX CLI's")
    check(float(np.max(np.abs((out["x0"] - fit_dev)
                              - (on_cpu["x0"] - fit_cpu)))) <= 1e-14,
          "sample-mm3: the CPU run starts from another ball")
    check(rel_gap <= 1e-8 and fit_gap <= 1e-4,
          f"sample-mm3: the CPU chain differs by {rel_gap:.3e} relative "
          f"to the fit (fits {fit_gap:.3e} apart)")
    check(launches["gj_inverse_f32"] > 0 and launches["refine_solve"] > 0
          and launches["gj_inverse_major_f32"] == 0,
          f"sample-mm3: K1 and K2 must launch: {launches}")
    return launches


# --------------------------------------------------------------------------
# The other steppers and the BDF's channels: Radau, Rosenbrock, auto,
# dopri5 and Adams, multiple shooting, events and dense output, backward
# integration, the CLI's --solver
# --------------------------------------------------------------------------

RADAU_BATCH = 64            # [radau-mapk22]: bench/harness.py's Radau row
RADAU_T = np.linspace(0.0, 100.0, 21)
AUTO_BATCH = 16             # [auto-mapk22]: the golden p and 15 spread
EXPLICIT_BATCH = 256        # [explicit]: adams_ensemble_bench.py's width
EXPLICIT_MODELS = {"lotka": ("lotka_volterra", 15.0),
                   "repressilator": ("repressilator", 40.0)}
MS_T_END, MS_WINDOWS, MS_SWEEPS = 60.0, 8, 3   # [multishoot] (own depth:
#                                                600, 16, 4 in a call of
#                                                its own)
EVENTS_BATCH, DENSE_BATCH = 64, 16             # [events-mapk22]
# the 41-point grid plus a 0.01 grid over [15, 35], where the terminal
# events fall, so that the terminal steps (~0.05-0.1 long there at rtol
# 1e-8) hold t_eval points
EVENTS_T = np.union1d(np.linspace(0.0, 100.0, 41),
                      np.linspace(15.0, 35.0, 2001))
BACKWARD_BATCH = 64                            # [backward-mm3]
# MM-3 backward over [10, 0] is ill-posed: its fast mode (rate ~7-18)
# grows backward, and SciPy's BDF at rtol=1e-10 stops with a step below
# the spacing of numbers, from y0 and from y(10) alike; from y(10) back to
# t=8 SciPy retraces the forward trajectory to 6e-11, to t=5 only to 1e-2
BACKWARD_SPAN = (10.0, 8.0)
# tests/test_solvers.py's MM-3 bound per solver (Adams: tests/test_adams.py
# on Lotka at the same rtol, 1e-3; auto hands MM-3 to BDF: BDF's)
CLI_SOLVER_BOUND = {"radau": 1e-4, "rosenbrock": 5e-3, "dopri5": 3e-4,
                    "adams": 1e-3, "auto": 3e-4}


class Laps:
    """Wall time between calls, by the label of the phase just ended; each
    call first runs ``Laps.watch`` where it is set."""

    watch = None

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = []

    def __call__(self, label):
        if Laps.watch is not None:
            Laps.watch()
        now = time.perf_counter()
        self.laps.append((label, now - self.t))
        self.t = now

    def report(self, what):
        total = sum(s for _, s in self.laps)
        print(f"[timing] {what}: {total:.1f} s: " + ", ".join(
            f"{label} {s:.1f}" for label, s in self.laps), flush=True)


def spread(p_true, batch, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return np.asarray(p_true)[None] * np.exp(
        rng.normal(scale=scale, size=(batch, len(p_true))))


def launches_now():
    from tpusysbio_torch.linalg import gpu_lu

    return dict(gpu_lu.LAUNCHES), dict(gpu_lu.LAUNCHES_BY_N)


def check_k1_k2(tag, launches, need_k2=True):
    check(launches["gj_inverse_f32"] > 0
          and (launches["refine_solve"] > 0 or not need_k2)
          and launches["gj_inverse_major_f32"] == 0,
          f"{tag}: K1{' and K2' if need_k2 else ''} must launch: "
          f"{launches}")


def phase_radau_mapk22(card):
    """Radau IIA on MAPK-22 with all 30 sensitivities in f32 at 64 members
    under 'pallas' (K1 at n=22 and at the complex matrix's 2n=44
    embedding, K2 on the f64 state column at both); the golden trajectory;
    2 members on the CPU."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    model = library.mapk_huang_ferrell(device="cuda")
    ps = spread(library.mapk_true_params(device="cpu").numpy(),
                RADAU_BATCH)
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=2048,
                       linear_solver="pallas", sens_precision="f32")
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    res = model.simulate_sensitivities(ps, (0.0, 100.0), RADAU_T,
                                       solver="radau", config=cfg,
                                       device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_n = launches_now()
    status = res.status.cpu().numpy()
    nsteps = res.nsteps.cpu().numpy()
    print(f"[radau-mapk22] {card}: {int((status == 1).sum())}/{RADAU_BATCH}"
          f" members status 1, wall {wall:.2f} s, mean_nsteps "
          f"{nsteps.mean():.2f} (max {int(nsteps.max())}), mean nlu "
          f"{res.nlu.float().mean().item():.2f}; launches {launches}, K1 by "
          f"n {by_n}", flush=True)
    check(bool((status == 1).all()), "radau-mapk22: a member not DONE")
    check(by_n.get(("gj_inverse_f32", 22), 0) > 0
          and by_n.get(("gj_inverse_f32", 44), 0) > 0,
          f"radau-mapk22: K1 must launch at n=22 and n=44: {by_n}")
    check_k1_k2("radau-mapk22", launches)
    check(bool(torch.isfinite(res.sens).all()), "radau-mapk22: sens")

    # the golden trajectory (tests/test_solvers.py's Radau MAPK-22 case)
    g = np.load(os.path.join(ROOT, "tests", "golden", "mapk22.npz"))
    gcfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=1024,
                        linear_solver="pallas")
    gres = model.simulate(g["p"][None], tuple(g["t_span"]), g["t_eval"],
                          solver="radau", config=gcfg, device="cuda")
    gerr = rel_err(gres.ys[0].cpu().numpy(), g["ys"])
    print(f"[radau-mapk22] golden mapk22: status {int(gres.status[0])}, "
          f"{int(gres.nsteps[0])} steps (bound < 300), error "
          f"{gerr:.3e} (bound 1e-6)", flush=True)
    check(int(gres.status[0]) == 1 and gerr < 1e-6
          and int(gres.nsteps[0]) < 300, "radau-mapk22: golden")

    # 2 members again on the CPU (the kernels' plain versions)
    t0 = time.perf_counter()
    ref = library.mapk_huang_ferrell(device="cpu").simulate_sensitivities(
        ps[:2], (0.0, 100.0), RADAU_T, solver="radau", config=cfg,
        device="cpu")
    ys_rel = rel_err(res.ys[:2].cpu().numpy(), ref.ys.numpy())
    sens_rel = rel_err(res.sens[:2].cpu().numpy(), ref.sens.numpy())
    cpu_s = time.perf_counter() - t0
    print(f"[radau-mapk22] 2 members on the CPU ({cpu_s:.2f} s): nsteps "
          f"card {nsteps[:2].tolist()} CPU {ref.nsteps.tolist()}, ys rel "
          f"{ys_rel:.3e} (bound 1e-7), sens rel {sens_rel:.3e} (bound "
          f"1e-4)", flush=True)
    check(ys_rel <= 1e-7 and sens_rel <= 1e-4
          and bool((ref.status == 1).all()),
          f"radau-mapk22: CPU ys {ys_rel:.3e}, sens {sens_rel:.3e}")
    return launches, by_n


def phase_rosenbrock_fit(card, problem):
    """One evaluation with Jacobian of [fit]'s MAPK-22 Project at its 256
    screening starts, with solver='rosenbrock' at the screen's tolerances
    in f64 under 'pallas'."""
    import dataclasses

    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    tight, _, _, starts = problem
    proj = dataclasses.replace(
        tight, solver="rosenbrock",
        config=SolverConfig(rtol=1e-3, atol=1e-6, max_steps=512,
                            linear_solver="pallas"))
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    ev = proj.evaluate(starts, with_jac=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = launches_now()
    cost = ev.cost.cpu().numpy()
    n_fin = int(np.isfinite(cost).sum())
    nsteps = ev.nsteps.cpu().numpy()
    print(f"[rosenbrock-fit] {card}: {starts.shape[0]} starts with Jacobian "
          f"in {wall:.2f} s; finite costs {n_fin}/{starts.shape[0]} (bound "
          f">= 240), statuses 1: {int((ev.status.cpu().numpy() == 1).sum())}"
          f", mean_nsteps {nsteps.mean():.2f} (max {int(nsteps.max())}); "
          f"launches {launches}", flush=True)
    check(n_fin >= 240, f"rosenbrock-fit: {n_fin} finite costs")
    check_k1_k2("rosenbrock-fit", launches)
    cpu = project_on_cpu(proj, library.mapk_huang_ferrell(device="cpu"))
    sel = [int(i) for i in np.flatnonzero(np.isfinite(cost))[:2]]
    again = cpu.evaluate(starts[sel].cpu(), with_jac=True)
    r_rel = rel_err(ev.residuals[sel].cpu().numpy(), again.residuals.numpy())
    j_rel = rel_err(ev.jacobian[sel].cpu().numpy(), again.jacobian.numpy())
    print(f"[rosenbrock-fit] starts {sel} on the CPU: residuals rel "
          f"{r_rel:.3e} (bound 1e-7), Jacobian rel {j_rel:.3e} (bound 1e-4)",
          flush=True)
    check(r_rel <= 1e-7 and j_rel <= 1e-4,
          f"rosenbrock-fit: CPU residuals {r_rel:.3e}, Jacobian {j_rel:.3e}")
    return launches


def phase_auto_mapk22(card):
    """``auto_solve`` on the golden MAPK-22 problem (tests/test_solvers.py's
    stiff fallback): the golden p and 15 spread members, nonstiff budget
    256, 'pallas'."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library
    from tpusysbio_torch.solvers import auto_solve

    g = np.load(os.path.join(ROOT, "tests", "golden", "mapk22.npz"))
    model = library.mapk_huang_ferrell(device="cuda")
    ps = np.concatenate([g["p"][None], spread(g["p"], AUTO_BATCH - 1)])
    p = torch.as_tensor(ps, device="cuda")
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=2048,
                       linear_solver="pallas")
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    res = auto_solve(lambda t, y: model.rhs(t, y, p), tuple(g["t_span"]),
                     model.y0(p), torch.as_tensor(g["t_eval"],
                                                  device="cuda"),
                     config=cfg, jac=lambda t, y: model.rhs_jac(t, y, p),
                     nonstiff_budget=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = launches_now()
    status = res.status.cpu().numpy()
    nlu = res.nlu.cpu().numpy()
    err = rel_err(res.ys[0].cpu().numpy(), g["ys"])
    print(f"[auto-mapk22] {card}: {int((status == 1).sum())}/{AUTO_BATCH} "
          f"members status 1 in {wall:.2f} s; nsteps "
          f"{res.nsteps.cpu().numpy().tolist()}; nlu {nlu.tolist()}; golden "
          f"member error {err:.3e} (bound 1e-4); launches {launches}",
          flush=True)
    check(bool((status == 1).all()) and bool((nlu > 0).all()),
          "auto-mapk22: every member DONE after a handoff")
    check(err < 1e-4, f"auto-mapk22: golden error {err:.3e}")
    check_k1_k2("auto-mapk22", launches, need_k2=False)
    return launches


def explicit_run(solver, name, ps, device, cfg, t_span=None, t_eval=None):
    """``solver`` on a small model with its full jvp sensitivities."""
    from tpusysbio_torch.model import library

    build, t_end = EXPLICIT_MODELS[name]
    model = getattr(library, build)(device=device)
    t_span = t_span or (0.0, t_end)
    t_eval = np.linspace(0.0, t_end, 21) if t_eval is None else t_eval
    return model.simulate_sensitivities(ps, t_span, t_eval, solver=solver,
                                        config=cfg, device=device)


def phase_explicit(card):
    """dopri5 and Adams at B=256 with full sensitivities at rtol=1e-6 on
    Lotka-Volterra and the repressilator (bench/experiments/
    adams_ensemble_bench.py), 2 members on the CPU; the golden fixtures at
    tests/test_sens.py's config and bound."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library

    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=16384)
    counters = ("status", "nsteps", "naccepted", "nrejected", "nfev")
    walls = {}
    gpu_lu.reset_launches()
    for name, (build, _) in EXPLICIT_MODELS.items():
        p_true = getattr(library, {"lotka": "LV_TRUE_PARAMS",
                                   "repressilator":
                                   "REPRESSILATOR_TRUE_PARAMS"}[name])
        ps = spread(p_true, EXPLICIT_BATCH)
        for solver in ("dopri5", "adams"):
            t0 = time.perf_counter()
            res = explicit_run(solver, name, ps, "cuda", cfg)
            torch.cuda.synchronize()
            wall = walls[name, solver] = time.perf_counter() - t0
            status = res.status.cpu().numpy()
            again = explicit_run(solver, name, ps[:2], "cpu", cfg)
            same = all(np.array_equal(getattr(res, c)[:2].cpu().numpy(),
                                      getattr(again, c).numpy())
                       for c in counters)
            ys_rel = rel_err(res.ys[:2].cpu().numpy(), again.ys.numpy())
            print(f"[explicit] {card}: {solver} {name} B={EXPLICIT_BATCH}: "
                  f"{int((status == 1).sum())} status 1 in {wall:.2f} s "
                  f"({EXPLICIT_BATCH / wall:.1f} integrations/s), "
                  f"mean_nsteps {res.nsteps.float().mean().item():.2f}, "
                  f"mean nfev {res.nfev.float().mean().item():.1f}, nlu "
                  f"max {int(res.nlu.max())}; 2 members on the CPU: "
                  f"counters equal {same}, ys rel {ys_rel:.3e} (bound "
                  f"1e-9)", flush=True)
            check(bool((status == 1).all()), f"explicit {solver} {name}")
            check(int(res.nlu.max()) == 0 and int(res.njev.max()) == 0,
                  f"explicit {solver} {name}: factorized")
            check(same and ys_rel <= 1e-9,
                  f"explicit {solver} {name}: CPU counters {same}, ys "
                  f"{ys_rel:.3e}")
            check(bool(torch.isfinite(res.sens).all()),
                  f"explicit {solver} {name}: sens")
    launches, _ = launches_now()
    check(sum(launches.values()) == 0, f"explicit: launched {launches}")
    # the golden fixtures, tests/test_sens.py's config and bound
    gcfg = SolverConfig(rtol=1e-8, atol=1e-11, max_steps=16384)
    for name in EXPLICIT_MODELS:
        g = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        for solver in ("dopri5", "adams"):
            res = explicit_run(solver, name, g["p"][None], "cuda", gcfg,
                               tuple(g["t_span"]), g["t_eval"])
            errs = {k: float(np.max(np.abs(getattr(res, k)[0].cpu().numpy()
                                           - g[k]))
                             / (1e-6 + np.max(np.abs(g[k]))))
                    for k in ("ys", "sens")}
            print(f"[explicit] golden {name} {solver}: status "
                  f"{int(res.status[0])}, {int(res.nsteps[0])} steps, ys err "
                  f"{errs['ys']:.3e}, sens err {errs['sens']:.3e} (bound "
                  f"1e-5)", flush=True)
            check(int(res.status[0]) == 1 and max(errs.values()) < 1e-5,
                  f"explicit golden {name} {solver}: {errs}")
    return walls


def phase_multishoot(card, t_end=MS_T_END, windows=MS_WINDOWS,
                     sweeps=MS_SWEEPS, state_bound=1e-5, floor=None):
    """The repressilator ShootingProblem of bench/experiments/
    multishoot_bench.py under 'pallas': a coarse serial init, ``sweeps``
    Newton sweeps on the window states, against the serial BDF. Both runs
    hold rtol 1e-6 locally, so their global gap grows with the horizon:
    ``state_bound`` 1e-5 at the smoke's depth, 1e-4 at the bench's own
    (T 600). There the windows are 37.5 long and the defects reach the
    floor those integrations allow (~1e-4) in one sweep: with ``floor``
    given, the defects must fall in the first sweep and stay below it,
    instead of falling at every sweep."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu, lu
    from tpusysbio_torch.model import library
    from tpusysbio_torch.solvers import bdf_solve
    from tpusysbio_torch.solvers.multishoot import (ShootingProblem,
                                                    window_grid)

    model = library.repressilator(device="cuda")
    p = torch.as_tensor(library.REPRESSILATOR_TRUE_PARAMS, device="cuda")
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=16384,
                       linear_solver="pallas")
    bounds = window_grid((0.0, t_end), windows, device="cuda")
    t0 = time.perf_counter()
    serial = bdf_solve(lambda t, y: model.rhs(t, y, p[None]), (0.0, t_end),
                       model.y0(p[None]), bounds[1:], config=cfg)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    sp = ShootingProblem(model.rhs, (0.0, t_end), model.y0,
                         n_windows=windows, n_params=4,
                         config=SolverConfig(
                             rtol=1e-6, atol=1e-9,
                             max_steps=cfg.max_steps // windows * 4,
                             linear_solver="pallas"))
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    zt = sp.init_z(p)[1:]
    trace = []
    for _ in range(sweeps):
        d, _, Jz, status = sp.defects_and_jac(p, zt)
        dz = lu.lu_solve(lu.lu_factor(Jz[None]), -d.reshape(1, -1))[0]
        zt = zt + dz.reshape(zt.shape)
        trace.append(float(d.abs().max()))
        check(bool((status == 1).all()), f"multishoot: window statuses "
              f"{status.tolist()}")
    d, _, _, status = sp.defects_and_jac(p, zt)
    torch.cuda.synchronize()
    ms_s = time.perf_counter() - t0
    launches, _ = launches_now()
    trace.append(float(d.abs().max()))
    ys = serial.ys[0]
    err = float((zt - ys[:windows - 1]).abs().max() / ys.abs().max())
    print(f"[multishoot] {card}: repressilator T={t_end}, K={windows}, "
          f"{sweeps} sweeps: serial {serial_s:.2f} s ({int(serial.nsteps[0])}"
          f" steps), shooting {ms_s:.2f} s; defects by sweep {trace}; window"
          f" states against the serial run {err:.3e} (bound {state_bound}); "
          f"launches {launches}", flush=True)
    if floor is None:
        check(all(b < a for a, b in zip(trace, trace[1:])),
              f"multishoot: the defects did not fall every sweep: {trace}")
    else:
        check(trace[1] < trace[0] and max(trace[1:]) <= floor,
              f"multishoot: the defects above the floor {floor}: {trace}")
    check(err <= state_bound, f"multishoot: window states {err:.3e}")
    check_k1_k2("multishoot", launches, need_k2=False)
    return launches


def mapk_events(c_rise, c_term):
    """Two events on doubly phosphorylated MAPK (KPP) with per-member
    thresholds (B,): KPP − c_rise rising through 0 (non-terminal), and
    c_term − KPP falling through 0 (terminal)."""
    import torch

    from tpusysbio_torch.solvers import EventSpec

    def fn(t, y):
        kpp = y[:, 10]
        return torch.stack([kpp - c_rise, c_term - kpp], dim=1)

    return EventSpec(fn=fn, direction=(1, -1), terminal=(False, True))


def scipy_mapk(p, t_end, events=None, t_eval=None, dense=False):
    """SciPy's BDF at rtol=1e-10 on one MAPK-22 member (the CPU model's
    RHS and closed-form Jacobian)."""
    import torch
    from scipy.integrate import solve_ivp

    from tpusysbio_torch.model import library

    m = library.mapk_huang_ferrell(device="cpu")
    pt = torch.as_tensor(p)[None]

    def f(t, y):
        return m.rhs(torch.full((1,), t, dtype=torch.float64),
                     torch.as_tensor(y)[None], pt)[0].numpy()

    def jac(t, y):
        return m.rhs_jac(torch.full((1,), t, dtype=torch.float64),
                         torch.as_tensor(y)[None], pt)[0].numpy()

    sol = solve_ivp(f, (0.0, t_end), m.y0(pt)[0].numpy(), method="BDF",
                    rtol=1e-10, atol=1e-13, jac=jac, events=events,
                    t_eval=t_eval, dense_output=dense)
    check(sol.success, f"SciPy: {sol.message}")
    return sol


def phase_events_mapk22(card):
    """``OdeModel.simulate(events=..., dense_output=True)`` on MAPK-22 at
    64 members, rtol 1e-8, 'pallas', against SciPy for 2 members (the
    dense export locates each member's terminal step); then
    ``simulate_sensitivities(dense_output=True)`` at 16 members and
    ``OdeSolution`` against the grid and SciPy's dense output."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library
    from tpusysbio_torch.solvers import OdeSolution

    model = library.mapk_huang_ferrell(device="cuda")
    ps = spread(library.mapk_true_params(device="cpu").numpy(),
                EVENTS_BATCH)
    rng = np.random.default_rng(8)
    c_rise = rng.uniform(0.2, 0.4, EVENTS_BATCH)
    c_term = rng.uniform(0.6, 0.85, EVENTS_BATCH)
    ev = mapk_events(torch.as_tensor(c_rise, device="cuda"),
                     torch.as_tensor(c_term, device="cuda"))
    cfg = SolverConfig(rtol=1e-8, atol=1e-11, max_steps=4096,
                       linear_solver="pallas")
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    res = model.simulate(ps, (0.0, 100.0), EVENTS_T, config=cfg, events=ev,
                         dense_output=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = launches_now()
    status = res.status.cpu().numpy()
    counts = res.event_count.cpu().numpy()
    print(f"[events-mapk22] {card}: {EVENTS_BATCH} members in {wall:.2f} "
          f"s: statuses {np.unique(status, return_counts=True)}, event "
          f"counts (rise, term) {np.unique(counts, axis=0).tolist()}, "
          f"t_final {float(res.t_final.min()):.3f}-"
          f"{float(res.t_final.max()):.3f}, mean_nsteps "
          f"{res.nsteps.float().mean().item():.2f}; launches {launches}",
          flush=True)
    check(bool((status == 7).all()), "events-mapk22: a member did not stop")
    check(bool((counts == 1).all()), "events-mapk22: event counts")
    check(bool((res.t_final > 15.0).all() & (res.t_final < 35.0).all()),
          "events-mapk22: a terminal event outside the fine grid")
    check_k1_k2("events-mapk22", launches)

    worst = 0.0
    for i in range(2):
        def g_rise(t, y, i=i):
            return y[10] - c_rise[i]

        def g_term(t, y, i=i):
            return c_term[i] - y[10]

        g_rise.direction, g_term.direction = 1, -1
        g_term.terminal = True
        sol = scipy_mapk(ps[i], 100.0, events=(g_rise, g_term), dense=True)
        t_ev = np.array([sol.t_events[0][0], sol.t_events[1][0]])
        y_ev = np.stack([sol.y_events[0][0], sol.y_events[1][0]])
        got_t = res.event_t[i, :, 0].cpu().numpy()
        got_y = res.event_y[i, :, 0].cpu().numpy()
        t_rel = float(np.max(np.abs(got_t - t_ev) / t_ev))
        y_rel = rel_err(got_y, y_ev)
        t_stop = float(res.t_final[i])
        filled = EVENTS_T <= t_stop
        ys_i = res.ys[i].cpu().numpy()
        fill = rel_err(ys_i[filled], sol.sol(EVENTS_T[filled]).T)
        # the terminal step starts at the end of the accepted step before
        # it, in the dense export
        nacc = int(res.naccepted[i])
        t_prev = float(res.seg_t[i, nacc - 2])
        last = (EVENTS_T > t_prev) & filled
        term = rel_err(ys_i[last], sol.sol(EVENTS_T[last]).T)
        worst = max(worst, t_rel, y_rel, fill, term)
        print(f"[events-mapk22] member {i} against SciPy (rtol 1e-10): "
              f"event times {got_t.tolist()} vs {t_ev.tolist()} (rel "
              f"{t_rel:.3e}), states rel {y_rel:.3e}; the {int(filled.sum())}"
              f" filled t_eval points rel {fill:.3e}, the {int(last.sum())} "
              f"of the terminal step ({t_prev:.6f}, {t_stop:.6f}] rel "
              f"{term:.3e} (bound 1e-6)", flush=True)
        check(int(last.sum()) > 0, "events-mapk22: no t_eval point in the "
              "terminal step")
    check(worst <= 1e-6, f"events-mapk22: against SciPy {worst:.3e}")

    # dense output: OdeSolution at the grid and off it
    t_eval = np.linspace(0.0, 100.0, 41)
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    dres = model.simulate_sensitivities(ps[:DENSE_BATCH], (0.0, 100.0),
                                        t_eval, config=cfg,
                                        dense_output=True, device="cuda")
    sol = OdeSolution(dres)
    grid = sol(t_eval)
    grid_s = sol.sens(t_eval)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t0
    l_dense, _ = launches_now()
    for k in l_dense:
        launches[k] += l_dense[k]
    g_rel = rel_err(grid[:, 1:].cpu().numpy(), dres.ys[:, 1:].cpu().numpy())
    s_rel = rel_err(grid_s[:, 1:].cpu().numpy(),
                    dres.sens[:, 1:].cpu().numpy())
    ts = np.sort(np.random.default_rng(0).uniform(0.01, 99.99, 200))
    off = sol(ts).cpu().numpy()
    off_rel = 0.0
    for i in range(2):
        ref = scipy_mapk(ps[i], 100.0, t_eval=ts)
        off_rel = max(off_rel, rel_err(off[i], ref.y.T))
    print(f"[events-mapk22] dense output, {DENSE_BATCH} members with 30 "
          f"sensitivities in {dwall:.2f} s ({int(dres.naccepted.max())} "
          f"steps recorded at most): OdeSolution at t_eval against ys rel "
          f"{g_rel:.3e}, sens rel {s_rel:.3e} (bound 1e-10); at 200 off-grid"
          f" times against SciPy (2 members) rel {off_rel:.3e} (bound 1e-6)"
          f"; launches {l_dense}", flush=True)
    check(bool((dres.status == 1).all()), "events-mapk22: dense statuses")
    check(g_rel <= 1e-10 and s_rel <= 1e-10, "events-mapk22: OdeSolution "
          "at the grid")
    check(off_rel <= 1e-6, f"events-mapk22: off-grid {off_rel:.3e}")
    return launches


def phase_backward_mm3(card):
    """MM-3 with sensitivities integrated backward over BACKWARD_SPAN at 64
    members from each member's state at t=10 (a forward run on the card),
    against SciPy's decreasing-t_span BDF and the CPU."""
    import dataclasses

    import torch
    from scipy.integrate import solve_ivp

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.model import library

    model = library.michaelis_menten(device="cuda")
    ps = spread(library.MM_TRUE_PARAMS, BACKWARD_BATCH)
    t1, t0_ = BACKWARD_SPAN
    cfg = SolverConfig(rtol=1e-10, atol=1e-13, max_steps=8192)
    fwd = model.simulate(ps, (0.0, t1), [0.0, t1], config=cfg,
                         device="cuda")
    check(bool((fwd.status == 1).all()), "backward-mm3: forward run")
    start = fwd.ys[:, -1].contiguous()

    def start_of(model_, y):
        # the start is data, not a function of p: zero sensitivity
        return dataclasses.replace(
            model_, y0=lambda pp: (y if pp.shape[0] == y.shape[0]
                                   else y[:1].expand(pp.shape[0], -1)))

    t_back = np.linspace(t1, t0_, 11)
    bcfg = SolverConfig(rtol=1e-8, atol=1e-11, max_steps=8192)
    t0 = time.perf_counter()
    res = start_of(model, start).simulate_sensitivities(
        ps, BACKWARD_SPAN, t_back, config=bcfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu_model = library.michaelis_menten(device="cpu")
    again = start_of(cpu_model, start[:2].cpu()).simulate_sensitivities(
        ps[:2], BACKWARD_SPAN, t_back, config=bcfg, device="cpu")
    worst = 0.0
    for i in range(2):
        pt = torch.as_tensor(ps[i])[None]

        def f(t, y):
            return cpu_model.rhs(torch.full((1,), t, dtype=torch.float64),
                                 torch.as_tensor(y)[None], pt)[0].numpy()

        sol = solve_ivp(f, BACKWARD_SPAN, start[i].cpu().numpy(),
                        method="BDF", t_eval=t_back, rtol=1e-10, atol=1e-13)
        check(sol.success, f"backward-mm3: SciPy {sol.message}")
        worst = max(worst, rel_err(res.ys[i].cpu().numpy(), sol.y.T))
    ys_cpu = rel_err(res.ys[:2].cpu().numpy(), again.ys.numpy())
    s_cpu = rel_err(res.sens[:2].cpu().numpy(), again.sens.numpy())
    print(f"[backward-mm3] {card}: {BACKWARD_BATCH} members with 4 "
          f"sensitivities over {BACKWARD_SPAN} in {wall:.2f} s, statuses 1: "
          f"{int((res.status == 1).sum())}, t_final "
          f"{float(res.t_final.min())}-{float(res.t_final.max())}, "
          f"mean_nsteps {res.nsteps.float().mean().item():.2f}; 2 members "
          f"against SciPy rel {worst:.3e} (bound 1e-6); against the CPU ys "
          f"{ys_cpu:.3e}, sens {s_cpu:.3e} (bound 1e-7)", flush=True)
    check(bool((res.status == 1).all()), "backward-mm3: statuses")
    check(bool((res.t_final == t0_).all()), "backward-mm3: t_final")
    check(worst <= 1e-6, f"backward-mm3: against SciPy {worst:.3e}")
    check(ys_cpu <= 1e-7 and s_cpu <= 1e-7,
          f"backward-mm3: CPU ys {ys_cpu:.3e}, sens {s_cpu:.3e}")


def phase_cli_solvers(card):
    """``cli.main(["simulate", "--model", "mm3", "--solver", s, ...])`` for
    the five new solvers and ``sens --solver radau``, against the MM-3
    golden (its t_eval: --t-end 10 --n-times 21)."""
    from tpusysbio_torch import cli

    g = np.load(os.path.join(ROOT, "tests", "golden", "mm3.npz"))
    base = ["--model", "mm3", "--t-end", "10", "--n-times", "21"]

    def golden_err(ys):
        return float(np.max(np.abs(ys - g["ys"]) / (1e-7 + np.abs(g["ys"]))))

    for solver, bound in CLI_SOLVER_BOUND.items():
        t0 = time.perf_counter()
        out = cli.main(["simulate"] + base + ["--solver", solver])
        err = golden_err(out["ys"])
        print(f"[cli-solvers] {card}: simulate --solver {solver}: "
              f"{out['record']} in {time.perf_counter() - t0:.2f} s; golden "
              f"error {err:.3e} (bound {bound})", flush=True)
        check(out["record"]["status"] == 1 and np.isfinite(out["ys"]).all()
              and err < bound, f"cli-solvers {solver}: {err:.3e}")
    t0 = time.perf_counter()
    out = cli.main(["sens"] + base + ["--solver", "radau"])
    err = golden_err(out["ys"])
    s_err = float(np.max(np.abs(out["sens"] - g["sens"]))
                  / (1e-6 + np.max(np.abs(g["sens"]))))
    print(f"[cli-solvers] sens --solver radau: {out['record']} in "
          f"{time.perf_counter() - t0:.2f} s; golden ys error {err:.3e} "
          f"(bound 1e-4), sens {s_err:.3e} (bound 1e-5)", flush=True)
    check(out["record"]["status"] == 1 and err < 1e-4 and s_err < 1e-5
          and np.isfinite(out["sens"]).all(), "cli-solvers sens radau")


def embedding_gap(got, ref, a):
    """Per matrix: the relative gap of two f32 inverses of ``a``, its bound
    max(1e-4, n·eps32·κ∞(a)) and κ∞(a) itself (numpy, (B,))."""
    import torch

    n = a.shape[-1]
    inv = torch.linalg.inv(a)
    kappa = (a.abs().sum(-1).amax(-1) * inv.abs().sum(-1).amax(-1))
    rel = ((got - ref).abs().amax((-2, -1))
           / ref.abs().amax((-2, -1)))
    eps32 = float(torch.finfo(torch.float32).eps)
    bound = torch.clamp(n * eps32 * kappa, min=1e-4)
    return (rel.double().cpu().numpy(), bound.cpu().numpy(),
            kappa.cpu().numpy())


def phase_n44_kernels(rng):
    """K1 and K2 against their plain versions on Radau's real embeddings
    of MAPK-22 at 2n=44 and B=64, timed beside torch.linalg and the
    bytes bound."""
    import torch

    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library
    from tpusysbio_torch.solvers.radau import newton_matrices

    B, n = RADAU_BATCH, 44
    model = library.mapk_huang_ferrell(device="cuda")
    p = library.mapk_true_params(device="cuda")[None] * torch.as_tensor(
        np.exp(rng.normal(scale=0.1, size=(B, 30))), device="cuda")
    y = torch.as_tensor(rng.uniform(0.0, 1.2, size=(B, 22)), device="cuda")
    J = model.rhs_jac(torch.zeros(B, dtype=torch.float64, device="cuda"),
                      y, p)
    h = torch.as_tensor(10.0 ** rng.uniform(-3.0, np.log10(5.0), B),
                        device="cuda")
    a = newton_matrices(J, h)[1].contiguous()
    a32 = a.to(torch.float32).contiguous()
    got = gpu_lu.gj_inverse_f32(a32)
    ref = gpu_lu.gj_inverse_f32_plain(a32)
    torch.cuda.synchronize()
    rel = float((got - ref).abs().max() / ref.abs().max())
    # the kernel and its plain version round in another order, so per
    # matrix they part by up to ~n·eps32·κ∞; the large steps of a Radau run
    # give condition numbers of 1e3 and more, where that passes 1e-4
    rel_m, bound_m, kappa = embedding_gap(got, ref, a)
    check(bool(torch.isfinite(got).all())
          and bool((rel_m <= bound_m).all()),
          f"K1-n44: rel {rel:.3e}; per matrix {rel_m.max():.3e} against "
          f"max(1e-4, n eps32 kappa) (kappa up to {kappa.max():.3e})")
    k1 = dict(max_abs_err=float((got - ref).abs().max()),
              ms=cuda_ms(lambda: gpu_lu.gj_inverse_f32(a32), reps=200),
              plain_ms=cuda_ms(lambda: gpu_lu.gj_inverse_f32_plain(a32),
                               reps=5),
              library_ms=cuda_ms(lambda: torch.linalg.inv(a32), reps=200))
    k1["bound_ms"], k1["bound_by"] = bound_ms(
        2 * B * n * n * 4, B * n * (n + 2 * n * (n - 1)) / F32_FLOPS)
    b = torch.as_tensor(rng.standard_normal((B, n)), device="cuda")
    x32 = gpu_lu.inverse(a32)
    got = gpu_lu.refine_solve(x32, a, b)
    ref = gpu_lu.refine_solve_plain(x32, a, b)
    sol = torch.linalg.solve(a, b)
    torch.cuda.synchronize()
    rel_plain = float((got - ref).abs().max() / ref.abs().max())
    rel_lib = float(((got - sol).abs() / sol.abs().clamp_min(1e-30)).max())
    check(rel_plain <= 1e-12 and rel_lib < 1e-9,
          f"K2-n44: rel vs plain {rel_plain:.3e}, vs solve {rel_lib:.3e}")
    k2 = dict(max_abs_err=float((got - ref).abs().max()),
              ms=cuda_ms(lambda: gpu_lu.refine_solve(x32, a, b), reps=200),
              plain_ms=cuda_ms(lambda: gpu_lu.refine_solve_plain(x32, a, b),
                               reps=50),
              library_ms=cuda_ms(lambda: torch.linalg.solve(a, b),
                                 reps=200))
    k2["bound_ms"], k2["bound_by"] = bound_ms(
        B * (n * n * 4 + n * n * 8 + 2 * n * 8),
        B * 2 * n * n * (4 / F32_FLOPS + 3 / F64_FLOPS))
    print(f"[K1-n44] per matrix the gap to the plain version is at most "
          f"{float(np.max(rel_m / bound_m)):.3f} of max(1e-4, n eps32 "
          f"kappa); kappa {float(kappa.min()):.3e}-{float(kappa.max()):.3e}"
          f", the largest gap {float(rel_m.max()):.3e}", flush=True)
    for tag, k, r, lib in (("K1-n44", k1, rel, "torch.linalg.inv"),
                           ("K2-n44", k2, rel_plain, "torch.linalg.solve")):
        print(f"[{tag}] Radau's 2n=44 embeddings of MAPK-22, B={B}: max abs "
              f"err vs plain {k['max_abs_err']:.3e} (rel {r:.3e}); kernel "
              f"{k['ms']:.4f} ms queued, plain {k['plain_ms']:.4f} ms, {lib} "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.7f} ms "
              f"({k['bound_by']})", flush=True)
    print(f"[K2-n44] vs torch.linalg.solve rel {rel_lib:.3e} (bound 1e-9)",
          flush=True)
    return k1, k2


def phase_other_steppers(card, problem):
    """Every phase of the other steppers and channels; their launches by
    path."""
    launches, laps = {}, Laps()
    launches["radau-mapk22"], _ = phase_radau_mapk22(card)
    laps("radau-mapk22")
    launches["rosenbrock-fit"] = phase_rosenbrock_fit(card, problem)
    laps("rosenbrock-fit")
    launches["auto-mapk22"] = phase_auto_mapk22(card)
    laps("auto-mapk22")
    phase_explicit(card)
    laps("explicit")
    launches["multishoot"] = phase_multishoot(card)
    laps("multishoot")
    launches["events-mapk22"] = phase_events_mapk22(card)
    laps("events-mapk22")
    phase_backward_mm3(card)
    laps("backward-mm3")
    phase_cli_solvers(card)
    laps("cli-solvers")
    laps.report("the other steppers")
    return launches


# --------------------------------------------------------------------------
# The banded Newton solver and the model and data surfaces
# --------------------------------------------------------------------------

BANDED_N = 200              # [banded]: tests/test_banded.py's relay chain
BANDED_BATCH = 64           # at n = 200, kl = ku = 1, 64 rates
BANDED_K = 2.0              # member 0's rate, the test's
BANDED_T = np.linspace(0.0, 5.0, 6)
# The JAX package's 'banded' BDF run of member 0 (rtol 1e-6, atol 1e-9),
# computed on the CPU: its step count and y(5) at BANDED_IDX
BANDED_IDX = (0, 1, 2, 5, 10, 20)
BANDED_JAX_NSTEPS = 112
BANDED_JAX_Y5 = (4.541100191690356e-05, 0.00045403910264869916,
                 0.00227003498538124, 0.037833101576072704,
                 0.12510986264844703, 0.0018660474620755768)
SBML_BATCH = 256            # [sbml]: repressilator members under 'pallas'
SBML_T = np.linspace(0.0, 30.0, 16)
PETAB_STARTS = 256          # [petab-mapk22]: screened starts
PETAB_TOP_K = 16            # polished by TRF
PETAB_TRF_ITERS = 2         # TRF iterations (the [fit-trf] depth)
# the JAX package's from_petab cost at theta_true on the same files (the
# data from the port's rtol 1e-9 simulation on the CPU; the cost held to
# 1e-6 relative, which that simulation's card/CPU difference keeps far
# inside), computed on the CPU with the tight config's rtol and atol
PETAB_JAX_COST_TRUE = 10.81974397466153


def chain_rhs(k):
    """The relay chain of tests/test_banded.py, one member per rate in
    ``k`` (B, 1): y_i' = k (y_{i-1} - y_i), minus 0.5 y_n² on the last."""
    import torch

    def rhs(t, y):
        inflow = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], dim=1)
        out = k * (inflow - y)
        return torch.cat([out[:, :-1], out[:, -1:] - 0.5 * y[:, -1:] ** 2],
                         dim=1)

    return rhs


def scipy_chain(rate):
    """SciPy's BDF at rtol 1e-10 on the chain with rate ``rate``."""
    from scipy.integrate import solve_ivp

    n = BANDED_N

    def f(t, y):
        inflow = np.concatenate([[0.0], y[:-1]])
        out = rate * (inflow - y)
        out[-1] -= 0.5 * y[-1] ** 2
        return out

    def jac(t, y):
        J = rate * (np.eye(n, k=-1) - np.eye(n))
        J[-1, -1] -= y[-1]
        return J

    y0 = np.zeros(n)
    y0[0] = 1.0
    sol = solve_ivp(f, (0.0, BANDED_T[-1]), y0, method="BDF",
                    t_eval=BANDED_T, rtol=1e-10, atol=1e-13, jac=jac)
    check(sol.success, f"SciPy: {sol.message}")
    return sol.y.T


def allclose_ratio(got, ref, rtol, atol):
    """max |got − ref| / (atol + rtol |ref|): at most 1 where
    ``np.allclose`` holds."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref) / (atol + rtol * np.abs(ref))))


def phase_banded(card):
    """The relay chain at n = 200 under 'banded' and 'lu' on the card:
    statuses, step counts within 2, trajectories within 1e-6; member 0
    against the JAX package's banded run and SciPy; the banded factor and
    solve timed on the path's Newton matrices."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.linalg import make_linear_solver
    from tpusysbio_torch.solvers import bdf_solve

    n, B = BANDED_N, BANDED_BATCH
    rng = np.random.default_rng(0)
    rates = BANDED_K * np.exp(rng.normal(scale=0.1, size=B))
    rates[0] = BANDED_K
    k = torch.as_tensor(rates, device="cuda")[:, None]
    y0 = torch.zeros((B, n), dtype=torch.float64, device="cuda")
    y0[:, 0] = 1.0
    t_eval = torch.as_tensor(BANDED_T, device="cuda")
    runs, walls = {}, {}
    for lin in ("banded", "lu"):
        kw = dict(jac_bandwidth=(1, 1)) if lin == "banded" else {}
        cfg = SolverConfig(rtol=1e-6, atol=1e-9, linear_solver=lin, **kw)
        t0 = time.perf_counter()
        runs[lin] = bdf_solve(chain_rhs(k), (0.0, float(BANDED_T[-1])), y0,
                              t_eval, config=cfg)
        torch.cuda.synchronize()
        walls[lin] = time.perf_counter() - t0
    band, lu = runs["banded"], runs["lu"]
    check(band.status.tolist() == [1] * B and lu.status.tolist() == [1] * B,
          f"banded: statuses {band.status.tolist()} / {lu.status.tolist()}")
    dsteps = int((band.nsteps - lu.nsteps).abs().max())
    ratio = allclose_ratio(band.ys.cpu().numpy(), lu.ys.cpu().numpy(), 1e-6,
                           1e-9)
    ys0 = band.ys[0].cpu().numpy()
    jax_ratio = allclose_ratio(ys0[-1, list(BANDED_IDX)], BANDED_JAX_Y5,
                               1e-6, 1e-9)
    ref = scipy_chain(BANDED_K)
    sp_err = float(np.max(np.abs(ys0 - ref)) / np.max(np.abs(ref)))
    print(f"[banded] n={n}, kl=ku=1, B={B}: 'banded' {walls['banded']:.2f} "
          f"s, mean steps {band.nsteps.double().mean():.2f}, nlu "
          f"{band.nlu.double().mean():.2f}; 'lu' {walls['lu']:.2f} s, mean "
          f"steps {lu.nsteps.double().mean():.2f}; step counts differ by at "
          f"most {dsteps} (bound 2); ys |d|/(1e-9 + 1e-6|y|) {ratio:.3f} "
          f"(bound 1)", flush=True)
    print(f"[banded] member 0 (rate {BANDED_K}): {int(band.nsteps[0])} steps"
          f" (the JAX package's banded run {BANDED_JAX_NSTEPS}), y(5) at "
          f"{BANDED_IDX} against it {jax_ratio:.3f} (bound 1 at rtol 1e-6);"
          f" against SciPy's BDF at rtol 1e-10 {sp_err:.3e} of max |y| "
          f"(bound 1e-5)", flush=True)
    check(dsteps <= 2 and ratio <= 1.0, "banded: 'banded' against 'lu'")
    check(abs(int(band.nsteps[0]) - BANDED_JAX_NSTEPS) <= 2
          and jax_ratio <= 1.0, "banded: member 0 against the JAX package")
    check(sp_err <= 1e-5, "banded: member 0 against SciPy")

    # the path's Newton matrices I - c J at y0, c = 1e-2
    J = torch.func.vmap(torch.func.jacfwd(
        lambda yy, kk: chain_rhs(kk[None])(None, yy[None])[0]))(y0, k)
    A = torch.eye(n, dtype=torch.float64, device="cuda") - 1e-2 * J
    b = torch.as_tensor(rng.normal(size=(B, n, 1)), device="cuda")
    times = {}
    for lin, bw in (("banded", (1, 1)), ("lu", None)):
        factor, solve = make_linear_solver(lin, bw)
        fact = factor(A)
        x = solve(fact, b)
        res = float(((A @ x - b).abs().max() / b.abs().max()))
        check(res < 1e-12, f"banded: {lin} solve residual {res:.3e}")
        times[lin] = (cuda_ms(lambda: factor(A), reps=5, warmup=1,
                              queued=False),
                      cuda_ms(lambda: solve(fact, b), reps=5, warmup=1,
                              queued=False))
    print(f"[banded] one factorization / one solve of B={B} n={n} Newton "
          f"matrices ({card}): 'banded' {times['banded'][0] / 1e3:.4f} s / "
          f"{times['banded'][1] / 1e3:.4f} s; 'lu' "
          f"{times['lu'][0] / 1e3:.4f} s / {times['lu'][1] / 1e3:.4f} s",
          flush=True)


# tests/test_sbml.py's event-lowering document (a dose of A at t=2, a feed
# switched on at t=1.5), copied: the smoke imports no test module
EVENT_T_CSYM = ('<csymbol encoding="text" definitionURL='
           '"http://www.sbml.org/sbml/symbols/time">t</csymbol>')

EVENT_SBML = f"""<?xml version="1.0" encoding="UTF-8"?>
<sbml xmlns="http://www.sbml.org/sbml/level2/version4" level="2" version="4">
 <model id="dosed">
  <listOfCompartments>
   <compartment id="cell" size="1"/>
  </listOfCompartments>
  <listOfSpecies>
   <species id="A" compartment="cell" initialConcentration="1"/>
  </listOfSpecies>
  <listOfParameters>
   <parameter id="kdeg" value="0.3"/>
   <parameter id="inflow" value="0" constant="false"/>
  </listOfParameters>
  <listOfReactions>
   <reaction id="prod" reversible="false">
    <listOfProducts><speciesReference species="A"/></listOfProducts>
    <kineticLaw>
     <math xmlns="http://www.w3.org/1998/Math/MathML"><ci>inflow</ci></math>
    </kineticLaw>
   </reaction>
   <reaction id="deg" reversible="false">
    <listOfReactants><speciesReference species="A"/></listOfReactants>
    <kineticLaw>
     <math xmlns="http://www.w3.org/1998/Math/MathML">
      <apply><times/><ci>kdeg</ci><ci>A</ci></apply>
     </math>
    </kineticLaw>
   </reaction>
  </listOfReactions>
  <listOfEvents>
   <event id="dose">
    <trigger>
     <math xmlns="http://www.w3.org/1998/Math/MathML">
      <apply><geq/>{EVENT_T_CSYM}<cn>2</cn></apply>
     </math>
    </trigger>
    <listOfEventAssignments>
     <eventAssignment variable="A">
      <math xmlns="http://www.w3.org/1998/Math/MathML"><cn>4</cn></math>
     </eventAssignment>
    </listOfEventAssignments>
   </event>
   <event id="feed">
    <trigger>
     <math xmlns="http://www.w3.org/1998/Math/MathML">
      <apply><geq/>{EVENT_T_CSYM}<cn>1.5</cn></apply>
     </math>
    </trigger>
    <listOfEventAssignments>
     <eventAssignment variable="inflow">
      <math xmlns="http://www.w3.org/1998/Math/MathML"><cn>1.5</cn></math>
     </eventAssignment>
    </listOfEventAssignments>
   </event>
  </listOfEvents>
 </model>
</sbml>
"""


def phase_sbml(card):
    """examples/repressilator.sbml.xml imported on the card, 256 members
    under 'pallas' against the library repressilator; the MAPK-22 SBML
    round trip's RHS; the lowered-event model of tests/test_sbml.py
    through ``Project`` against the SciPy piecewise oracle."""
    import torch
    from scipy.integrate import solve_ivp

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model import library
    from tpusysbio_torch.model.sbml_export import to_sbml
    from tpusysbio_torch.model.sbml_import import from_sbml
    from tpusysbio_torch.project import ParameterMap, Project

    model, p0 = from_sbml(os.path.join(ROOT, "examples",
                                       "repressilator.sbml.xml"))
    lib = library.repressilator(device="cuda")
    check(model.param_names == lib.param_names
          and model.state_names == lib.state_names,
          "sbml: the repressilator's names differ from the library's")
    ps = spread(library.REPRESSILATOR_TRUE_PARAMS, SBML_BATCH)
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, linear_solver="pallas")
    runs, walls = {}, {}
    gpu_lu.reset_launches()
    for tag, m in (("sbml", model), ("library", lib)):
        t0 = time.perf_counter()
        runs[tag] = m.simulate(ps, (0.0, float(SBML_T[-1])), SBML_T,
                               config=cfg, device="cuda")
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        if tag == "sbml":
            launches = dict(gpu_lu.LAUNCHES)
    a, b = runs["sbml"], runs["library"]
    check(a.status.tolist() == [1] * SBML_BATCH
          and b.status.tolist() == [1] * SBML_BATCH,
          "sbml: a repressilator member did not finish")
    dsteps = int((a.nsteps - b.nsteps).abs().max())
    same = int((a.nsteps == b.nsteps).sum())
    ratio = allclose_ratio(a.ys.cpu().numpy(), b.ys.cpu().numpy(), 1e-6,
                           1e-9)
    print(f"[sbml] repressilator from SBML, B={SBML_BATCH} under 'pallas': "
          f"{walls['sbml']:.2f} s (library {walls['library']:.2f} s), mean "
          f"steps {a.nsteps.double().mean():.2f} ({b.nsteps.double().mean():.2f}"
          f"); {same}/{SBML_BATCH} equal step counts, at most {dsteps} apart "
          f"(bound 2); ys |d|/(1e-9 + 1e-6|y|) {ratio:.3f} (bound 1); "
          f"launches {launches}", flush=True)
    check(dsteps <= 2 and ratio <= 1.0, "sbml: against the library model")
    check_k1_k2("sbml", launches, need_k2=False)

    net = library._mapk_network(device="cuda")
    p_true = library.mapk_true_params(device="cpu").numpy()
    mapk = library.mapk_huang_ferrell(device="cuda")
    y0 = mapk.y0(torch.as_tensor(p_true, device="cuda")[None])[0]
    imported, p_doc = from_sbml(to_sbml(net, y0.cpu().numpy(), p_true,
                                        name="mapk22"))
    check(np.array_equal(np.asarray(p_doc), p_true),
          "sbml: the MAPK-22 document's constants")
    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.uniform(0.0, 1.2, (256, 22)), device="cuda")
    pt = torch.as_tensor(spread(p_true, 256, seed=3), device="cuda")
    t = torch.zeros(256, dtype=torch.float64, device="cuda")
    got, want = imported.rhs(t, y, pt), mapk.rhs(t, y, pt)
    rhs_rel = float(((got - want).abs().max(1).values
                     / want.abs().max(1).values).max())
    print(f"[sbml] MAPK-22 through to_sbml/from_sbml: the RHS at 256 random "
          f"states {rhs_rel:.3e} from the library's, relative (bound 1e-13)",
          flush=True)
    check(rhs_rel <= 1e-13, "sbml: the MAPK-22 round trip's RHS")

    # tests/test_sbml.py's dosing (species) and feed (parameter) events
    ev_model, _, lowered = from_sbml(EVENT_SBML, events="lower")
    t_obs = np.linspace(0.5, 6.0, 8)
    oracle = np.zeros(8)
    yv = np.array([1.0])
    for t_lo, t_hi, infl, dose in ((0.0, 1.5, 0.0, None),
                                   (1.5, 2.0, 1.5, None),
                                   (2.0, 6.0, 1.5, 4.0)):
        if dose is not None:
            yv = np.array([dose])
        pts = sorted({float(x) for x in t_obs if t_lo < x <= t_hi} | {t_hi})
        sol = solve_ivp(lambda tt, yy: [infl - 0.3 * yy[0]], (t_lo, t_hi),
                        yv, method="BDF", t_eval=pts, rtol=1e-10, atol=1e-13)
        check(sol.success, "sbml: the SciPy oracle")
        for i, tk in enumerate(t_obs):
            if t_lo < tk <= t_hi:
                oracle[i] = sol.y[0, pts.index(float(tk))]
        yv = sol.y[:, -1]
    exp = Experiment(
        "dosed", (Measurement(0, t_obs, oracle, np.ones(8)),),
        inputs=tuple((t_, g, v) for kind, t_, g, v in lowered
                     if kind == "param"),
        input_states=tuple((t_, g, v) for kind, t_, g, v in lowered
                           if kind == "state"))
    batch = ExperimentBatch.from_experiments(
        [exp], param_names=ev_model.param_names,
        state_names=ev_model.state_names, device="cuda")
    pmap = ParameterMap.create(ev_model.param_names, 1, shared=("kdeg",),
                               fixed={"inflow": [0.0]}, device="cuda")
    proj = Project(model=ev_model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-9, atol=1e-12))
    r = proj.residuals(pmap.pack({"kdeg": 0.3}))
    r_max = float(r.abs().max())
    print(f"[sbml] lowered events {lowered} through Project on the card: "
          f"max |residual| against the SciPy piecewise oracle {r_max:.3e} "
          f"(bound 1e-6)", flush=True)
    check(r_max < 1e-6, "sbml: the lowered-event model against SciPy")
    return launches


def fit_data(device):
    """[fit]'s data: MAPK-22 at the true rates, 12 times, 3 observables,
    seed-0 noise, sigma = 2% of the largest value. Returns the model, the
    true rates, the times, the data (12, 3), sigma and the free names."""
    import torch

    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.model import library

    model = library.mapk_huang_ferrell(device=device)
    p_true = library.mapk_true_params(device="cpu").numpy()
    t = np.linspace(5.0, 100.0, 12)
    sim = model.simulate(p_true[None], (0.0, 100.0), t,
                         config=SolverConfig(rtol=1e-9, atol=1e-12,
                                             max_steps=2048), device=device)
    check(int(sim.status[0]) == 1, "fit: the data simulation did not finish")
    p_dev = torch.as_tensor(p_true, device=device)[None].expand(12, -1)
    obs = model.observables(sim.ys[0], p_dev).cpu().numpy()
    rng = np.random.default_rng(0)
    sigma = 0.02 * float(np.max(obs))
    data = obs + rng.normal(scale=sigma, size=obs.shape)
    names = model.param_names
    free = [n for n in names if n.startswith(("KKPP+K", "KPase+KP"))]
    return model, p_true, t, data, sigma, free


def tight_config():
    from tpusysbio_torch import SolverConfig

    return SolverConfig(rtol=1e-6, atol=1e-9, max_steps=512,
                        linear_solver="pallas", sens_precision="f32",
                        dense_f32=True)


def screen_config():
    from tpusysbio_torch import SolverConfig

    return SolverConfig(rtol=1e-3, atol=1e-6, max_steps=192,
                        linear_solver="pallas", mixed_precision=True)


def write_petab_mapk22(dirpath, device):
    """[fit]'s problem as PEtab files in ``dirpath``: the SBML export of
    the MAPK-22 network with its y0 and true rates; parameters (the 12
    free rates estimated with bounds k·e^-1 and k·e^1, natural-log θ_true
    ± 1, the rest fixed at their values); the observables KKKs, KKPP and
    KPP with the constant sigma; one condition; the measurements, also as
    a tidy CSV. Returns the problem file's and the CSV's paths."""
    import torch

    from tpusysbio_torch.model import library
    from tpusysbio_torch.model.sbml_export import to_sbml

    model, p_true, t, data, sigma, free = fit_data(device)
    net = library._mapk_network(device=device)
    y0 = model.y0(torch.as_tensor(p_true, device=device)[None])[0]
    doc = to_sbml(net, y0.cpu().numpy(), p_true, name="mapk22")
    with open(os.path.join(dirpath, "model.xml"), "w") as fh:
        fh.write(doc)
    # the document's parameter ids, in reaction order (its listOfParameters)
    import re
    ids = re.findall(r'<parameter id="([^"]+)"', doc)
    check(len(ids) == len(p_true), "petab: the document's parameter ids")
    rows = ["parameterId\tparameterScale\tlowerBound\tupperBound\t"
            "nominalValue\testimate"]
    for name, pid, k in zip(model.param_names, ids, p_true):
        if name in free:
            rows.append(f"{pid}\tlog\t{float(k * np.exp(-1.0))!r}\t"
                        f"{float(k * np.exp(1.0))!r}\t{float(k)!r}\t1")
        else:
            rows.append(f"{pid}\tlog\t\t\t{float(k)!r}\t0")
    obs_names = ("KKKs", "KKPP", "KPP")
    files = {
        "parameters.tsv": rows,
        "observables.tsv": ["observableId\tobservableFormula\tnoiseFormula"]
        + [f"obs_{s}\t{s}\t{sigma!r}" for s in obs_names],
        "conditions.tsv": ["conditionId", "wt"],
        "measurements.tsv": [
            "observableId\tsimulationConditionId\ttime\tmeasurement"] + [
            f"obs_{s}\twt\t{float(ti)!r}\t{float(data[i, j])!r}"
            for j, s in enumerate(obs_names) for i, ti in enumerate(t)],
        "data.csv": ["experiment,observable,time,value,sigma"] + [
            f"wt,{s},{float(ti)!r},{float(data[i, j])!r},{sigma!r}"
            for j, s in enumerate(obs_names) for i, ti in enumerate(t)],
        "problem.yaml": [
            "format_version: 1", "parameter_file: parameters.tsv",
            "problems:", "  - sbml_files: [model.xml]",
            "    condition_files: [conditions.tsv]",
            "    observable_files: [observables.tsv]",
            "    measurement_files: [measurements.tsv]"],
    }
    for name, lines in files.items():
        with open(os.path.join(dirpath, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return (os.path.join(dirpath, "problem.yaml"),
            os.path.join(dirpath, "data.csv"))


def phase_petab_mapk22(card, problem):
    """[fit]'s problem reached through to_sbml, the PEtab tables and the
    CSV: the costs at θ_true against the native Project and the JAX
    package's from_petab; one screening evaluation with Jacobian at 256
    ``sample_startpoints`` (K1); ``multistart_trf`` from the best 16 at
    ``PETAB_TRF_ITERS`` iterations in the PEtab box (K1 and K2); two
    members on the CPU. Returns the launches and a function that times
    the screening evaluation beside [fit]'s native one."""
    import dataclasses

    import torch

    from tpusysbio_torch import FitConfig
    from tpusysbio_torch.data import ExperimentBatch, experiments_from_csv
    from tpusysbio_torch.fit import multistart_trf
    from tpusysbio_torch.linalg import gpu_lu
    from tpusysbio_torch.model.sbml_import import from_sbml
    from tpusysbio_torch.petab_import import from_petab
    from tpusysbio_torch.project import ParameterMap, Project

    tight_native, screen_native, theta_true, _ = problem
    with tempfile.TemporaryDirectory() as tmp:
        yaml_path, csv_path = write_petab_mapk22(tmp, "cuda")
        t0 = time.perf_counter()
        prob = from_petab(yaml_path, config=tight_config(), device="cuda")
        load_s = time.perf_counter() - t0
        prob_cpu = from_petab(yaml_path, config=tight_config(), device="cpu")
        sbml_model, p_doc = from_sbml(os.path.join(tmp, "model.xml"))
        exps = experiments_from_csv(csv_path, model=sbml_model)
    check(prob.project.n_theta == 12 and prob.model.n_states == 22
          and prob.project.n_residuals == 36,
          "petab: not the 22-state, 12-parameter, 36-row problem")
    th_true = theta_true.to(torch.float64)
    cost_petab = float(prob.project.cost(th_true))
    cost_native = float(tight_native.cost(theta_true))
    names = sbml_model.param_names
    free_ids = prob.x_ids
    fixed = {n: v for n, v in zip(names, p_doc) if n not in free_ids}
    pmap = ParameterMap.create(names, 1, shared=free_ids, fixed=fixed,
                               device="cuda")
    csv_proj = Project(model=sbml_model, pmap=pmap,
                       batch=ExperimentBatch.from_experiments(
                           exps, device="cuda"), config=tight_config())
    cost_csv = float(csv_proj.cost(th_true))
    rel = {tag: abs(c - cost_petab) / cost_petab for tag, c in (
        ("native", cost_native), ("JAX", PETAB_JAX_COST_TRUE),
        ("CSV", cost_csv))}
    print(f"[petab-mapk22] from_petab on the card in {load_s:.2f} s; cost at "
          f"theta_true {cost_petab:.9f}: the native [fit] Project's "
          f"{cost_native:.9f} ({rel['native']:.2e}), the JAX package's "
          f"from_petab {PETAB_JAX_COST_TRUE:.9f} ({rel['JAX']:.2e}), the CSV "
          f"records' Project {cost_csv:.9f} ({rel['CSV']:.2e}); bound 1e-6 "
          f"relative", flush=True)
    check(max(rel.values()) <= 1e-6, f"petab: costs at theta_true {rel}")

    lb = torch.as_tensor(prob.lb, device="cuda")
    ub = torch.as_tensor(prob.ub, device="cuda")
    box = float(torch.max((lb - (th_true - 1.0)).abs().max(),
                          (ub - (th_true + 1.0)).abs().max()))
    check(box <= 1e-12, f"petab: the box is not theta_true ± 1 ({box})")
    screen = dataclasses.replace(prob.project, config=screen_config())
    starts = prob.sample_startpoints(torch.Generator().manual_seed(0),
                                     PETAB_STARTS)
    gpu_lu.reset_launches()
    ev = screen.evaluate(starts, with_jac=True)
    l_screen = dict(gpu_lu.LAUNCHES)
    native_ev = screen_native.evaluate(starts, with_jac=True)
    s_cost = ev.cost.cpu().numpy()
    n_bad = int((~np.isfinite(s_cost)).sum())
    n_bad_native = int((~np.isfinite(native_ev.cost.cpu().numpy())).sum())
    print(f"[petab-mapk22] one screening evaluation with Jacobian of "
          f"{PETAB_STARTS} sample_startpoints: non-finite costs {n_bad} "
          f"(native {n_bad_native}; bound 56); launches {l_screen}",
          flush=True)
    check(n_bad <= 56, f"petab: {n_bad} non-finite screened costs")
    check(l_screen["gj_inverse_f32"] > 0
          and l_screen["gj_inverse_major_f32"] == 0,
          f"petab: the screen must launch K1: {l_screen}")

    order = np.argsort(np.where(np.isfinite(s_cost), s_cost, np.inf),
                       kind="stable")[:PETAB_TOP_K]
    x0 = starts[order.tolist()]
    c_start = prob.project.cost(x0)
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    res = multistart_trf(prob.project.residuals,
                         prob.project.residuals_and_jacobian, x0, lb, ub,
                         FitConfig(max_iter=PETAB_TRF_ITERS))
    torch.cuda.synchronize()
    trf_s = time.perf_counter() - t0
    l_trf = dict(gpu_lu.LAUNCHES)
    launches = {k: l_screen[k] + l_trf[k] for k in l_trf}
    inside = bool(((res.theta > lb) & (res.theta < ub)).all())
    best0, best = float(c_start.min()), float(res.cost.min())
    status = res.status.cpu().numpy()
    print(f"[petab-mapk22] multistart_trf from the best {PETAB_TOP_K} at "
          f"{PETAB_TRF_ITERS} iterations: {trf_s:.2f} s, best cost "
          f"{best0:.6f} -> {best:.6f} (cost at theta_true "
          f"{cost_petab:.6f}), statuses {status.tolist()}, every θ inside "
          f"the box: {inside}; launches {l_trf}", flush=True)
    check(inside and bool((status >= 0).all())
          and bool(np.isfinite(res.cost.cpu().numpy()).all()),
          "petab: TRF left the box or failed")
    check(best <= best0, f"petab: the best cost rose {best0} -> {best}")
    check_k1_k2("petab-mapk22", launches)

    two = res.theta[:2]
    dev_ev = prob.project.evaluate(two, with_jac=True)
    cpu_ev = prob_cpu.project.evaluate(two.cpu(), with_jac=True)
    r_rel = float((dev_ev.residuals.cpu() - cpu_ev.residuals).abs().max()
                  / cpu_ev.residuals.abs().max())
    j_rel = float((dev_ev.jacobian.cpu() - cpu_ev.jacobian).abs().max()
                  / cpu_ev.jacobian.abs().max())
    print(f"[petab-mapk22] two members on the CPU: residuals {r_rel:.3e} "
          f"(bound 1e-7), Jacobian {j_rel:.3e} (bound 1e-3, f32 "
          f"sensitivity columns)", flush=True)
    check(bool(torch.equal(dev_ev.status.cpu(), cpu_ev.status)),
          "petab: CPU statuses differ")
    check(r_rel <= 1e-7 and j_rel <= 1e-3, "petab: the CPU re-run")

    def timed():
        """The two screening evaluations again, timed: the imported
        model's against [fit]'s native one."""
        secs = []
        for proj in (screen, screen_native):
            t0 = time.perf_counter()
            proj.evaluate(starts, with_jac=True)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print(f"[petab-mapk22] one screening evaluation with Jacobian of "
              f"{PETAB_STARTS} sample_startpoints ({card}): {secs[0]:.2f} "
              f"s, [fit]'s native screening Project at the same starts "
              f"{secs[1]:.2f} s (ratio {secs[0] / secs[1]:.2f})",
              flush=True)

    return launches, timed


def phase_compat(card):
    """The SciPy facades on the card against SciPy: solve_ivp('BDF') on
    the MAPK-22 RHS as an unbatched torch function; a terminal event's
    grid; odeint on MM-3; least_squares (trf, bounds, soft_l1) and
    leastsq on an MM-3 fit."""
    import scipy.integrate as si
    import scipy.optimize as so
    import torch

    from tpusysbio_torch import SolverConfig, compat
    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.model import library
    from tpusysbio_torch.project import ParameterMap, Project

    mapk = library.mapk_huang_ferrell(device="cuda")
    p_true = library.mapk_true_params(device="cpu").numpy()
    pt = torch.as_tensor(p_true, device="cuda")[None]

    def f(t, y):
        return mapk.rhs(t.reshape(1), y[None], pt)[0]

    y0 = mapk.y0(pt)[0].cpu().numpy()
    t_eval = np.linspace(0.0, 100.0, 11)
    t0 = time.perf_counter()
    ours = compat.solve_ivp(f, (0.0, 100.0), y0, method="BDF", t_eval=t_eval,
                            rtol=1e-8, atol=1e-12, device="cuda")
    wall = time.perf_counter() - t0
    ref = scipy_mapk(p_true, 100.0, t_eval=t_eval)
    err = float(np.max(np.abs(ours.y - ref.y)) / np.max(np.abs(ref.y)))
    print(f"[compat] solve_ivp('BDF') on the MAPK-22 RHS (an unbatched torch "
          f"function) at rtol 1e-8: {wall:.2f} s, status {ours.status}, nfev "
          f"{ours.nfev}, nlu {ours.nlu}; {err:.3e} of max |y| from SciPy's "
          f"BDF at rtol 1e-10 (bound 1e-6)", flush=True)
    check(ours.status == 0 and err <= 1e-6, "compat: solve_ivp on MAPK-22")

    def decay(t, y):
        return torch.stack([-0.5 * y[0] + 40.0 * (y[1] - y[0]),
                            -40.0 * (y[1] - y[0]) - 0.1 * y[1]])

    def decay_np(t, y):
        return np.asarray([-0.5 * y[0] + 40.0 * (y[1] - y[0]),
                           -40.0 * (y[1] - y[0]) - 0.1 * y[1]])

    def event(t, y):
        return y[0] - 0.5

    event.terminal, event.direction = True, -1.0
    ours = compat.solve_ivp(decay, (0.0, 5.0), [1.0, 0.0], method="BDF",
                            events=[event], rtol=1e-8, atol=1e-10,
                            device="cuda")
    ref = si.solve_ivp(decay_np, (0.0, 5.0), [1.0, 0.0], method="BDF",
                       events=[event], rtol=1e-10, atol=1e-12)
    ev_err = abs(ours.t[-1] - ref.t[-1]) / ref.t[-1]
    print(f"[compat] terminal event, t_eval=None: the grid ends at "
          f"{float(ours.t[-1])!r} = t_event {float(ours.t_events[0][0])!r} "
          f"(SciPy {float(ref.t[-1])!r}, {ev_err:.2e}), y there "
          f"{ours.y[:, -1].tolist()}", flush=True)
    check(ours.status == 1 and ours.t[-1] == ours.t_events[0][0]
          and ev_err <= 1e-6 and abs(ours.y[0, -1] - 0.5) <= 1e-7,
          "compat: the terminal event's grid")

    mm = library.michaelis_menten(device="cuda")
    pm = torch.as_tensor(library.MM_TRUE_PARAMS, device="cuda")[None]
    t_mm = np.linspace(0.0, 10.0, 21)
    ys = compat.odeint(lambda y, t: mm.rhs(t.reshape(1), y[None], pm)[0],
                       [1.0, 0.0, 0.0], t_mm, device="cuda")
    mm_cpu = library.michaelis_menten(device="cpu")
    pm_cpu = torch.as_tensor(library.MM_TRUE_PARAMS)[None]
    ys_ref = si.odeint(lambda y, t: mm_cpu.rhs(
        torch.full((1,), t, dtype=torch.float64), torch.as_tensor(y)[None],
        pm_cpu)[0].numpy(), [1.0, 0.0, 0.0], t_mm)
    ode_err = float(np.max(np.abs(ys - ys_ref)))
    print(f"[compat] odeint on MM-3: {ode_err:.3e} from SciPy's odeint "
          f"(bound 1e-6)", flush=True)
    check(ode_err <= 1e-6, "compat: odeint on MM-3")

    # an MM-3 fit: the port's Project gives residuals and the Jacobian to
    # both optimizers (on the card to the facades, on the CPU to SciPy);
    # each side keeps its last evaluation, so a Jacobian at the θ of the
    # residuals just computed costs no second integration
    t_d = np.linspace(0.2, 2.0, 10)
    sim = mm_cpu.simulate(library.MM_TRUE_PARAMS[None], (0.0, 2.0), t_d,
                          config=SolverConfig(rtol=1e-10, atol=1e-12),
                          device="cpu").ys[0].numpy()
    rng = np.random.default_rng(0)
    data = sim + rng.normal(scale=0.01, size=sim.shape)
    meas = tuple(Measurement(i, t_d, data[:, i], np.full(10, 0.01))
                 for i in (0, 2))
    names = mm.param_names

    def project(device):
        model = library.michaelis_menten(device=device)
        pmap = ParameterMap.create(names, 1, shared=tuple(names[:3]),
                                   fixed={"E0": library.MM_TRUE_PARAMS[3]},
                                   device=device)
        batch = ExperimentBatch.from_experiments(
            [Experiment("mm", meas)], device=device)
        return Project(model=model, pmap=pmap, batch=batch,
                       config=SolverConfig(rtol=1e-5, atol=1e-8))

    proj, proj_cpu = project("cuda"), project("cpu")

    def last_of(pr):
        memo = {}

        def rj(th):
            th = torch.as_tensor(th, dtype=torch.float64)
            key = tuple(th.tolist())
            if key not in memo:
                memo.clear()
                memo[key] = pr.residuals_and_jacobian(
                    th.to(pr.batch.device)[None])
            return memo[key]

        return rj

    rj_dev, rj_cpu = last_of(proj), last_of(proj_cpu)

    def r_dev(th):
        return rj_dev(th)[0][0]

    def j_dev(th):
        return rj_dev(th)[1][0]

    def r_np(th):
        return rj_cpu(th)[0][0].numpy()

    def j_np(th):
        return rj_cpu(th)[1][0].numpy()

    x0 = np.log(library.MM_TRUE_PARAMS[:3]) + np.asarray([0.1, -0.1, 0.05])
    lb, ub = x0 - 0.5, x0 + 0.5
    t0 = time.perf_counter()
    ours = compat.least_squares(r_dev, x0, jac=j_dev, bounds=(lb, ub),
                                loss="soft_l1", device="cuda")
    ls_s = time.perf_counter() - t0
    ref = so.least_squares(r_np, x0, jac=j_np, bounds=(lb, ub),
                           loss="soft_l1")
    x_err = float(np.max(np.abs(ours.x - ref.x)))
    c_rel = abs(ours.cost - ref.cost) / ref.cost
    t0 = time.perf_counter()
    lx, ier = compat.leastsq(r_dev, x0, Dfun=j_dev, device="cuda")
    lsq_s = time.perf_counter() - t0
    rx, rier = so.leastsq(r_np, x0, Dfun=j_np)
    lx_err = float(np.max(np.abs(lx - rx)))
    print(f"[compat] MM-3 fit: least_squares(trf, bounds, soft_l1) "
          f"{ls_s:.2f} s, nfev {ours.nfev}, x {x_err:.2e} from SciPy's "
          f"(bound 1e-4), cost rel {c_rel:.2e} (bound 1e-6); leastsq "
          f"{lsq_s:.2f} s, ier {ier} (SciPy {rier}), x {lx_err:.2e} "
          f"(bound 1e-4)", flush=True)
    check(ours.success and ref.success and x_err <= 1e-4 and c_rel <= 1e-6,
          "compat: least_squares against SciPy")
    check(ier in (1, 2, 3, 4) and rier in (1, 2, 3, 4) and lx_err <= 1e-4,
          "compat: leastsq against SciPy")


def phase_plot(card):
    """``cli.main`` ``multistart --plot`` and ``profile --plot`` on MM-3 at
    the smallest depth: the PNGs where matplotlib imports, else the CLI's
    ImportError naming it."""
    from tpusysbio_torch import cli

    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    runs = (["multistart", "--model", "mm3", "--screen-iters", "1",
             "--polish-iters", "1"],
            ["profile", "--model", "mm3", "--n-points", "3", "--span",
             "0.5", "--fit-iters", "1"])
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "mm3")
        for argv in runs:
            if not have:
                try:
                    cli.main(argv + ["--plot", prefix])
                except ImportError as e:
                    check("matplotlib" in str(e),
                          f"plot: the ImportError does not name matplotlib: "
                          f"{e}")
                    continue
                fail(f"plot: {argv[0]} --plot ran without matplotlib")
            t0 = time.perf_counter()
            cli.main(argv + ["--plot", prefix])
            wall = time.perf_counter() - t0
            names = (("_waterfall.png", "_fit.png") if argv[0] ==
                     "multistart" else ("_profiles.png",))
            sizes = {n: os.path.getsize(prefix + n)
                     if os.path.exists(prefix + n) else 0 for n in names}
            print(f"[plot] {argv[0]} --plot: {wall:.2f} s, {sizes}",
                  flush=True)
            check(all(s > 0 for s in sizes.values()),
                  f"plot: {argv[0]} wrote {sizes}")
    print(f"[plot] matplotlib imports on this machine: {have}; "
          + ("the PNGs were written" if have else
             "the CLI raised the ImportError naming matplotlib"), flush=True)


def phase_surfaces(card, problem):
    """The model and data surfaces' phases: their launches by path, and
    [petab-mapk22]'s timing function."""
    import torch

    try:
        import sympy
        sympy_version = sympy.__version__
    except ImportError:
        fail("sympy is not installed: the SBML and PEtab surfaces need it")
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    print(f"[surfaces] torch {torch.__version__}, sympy {sympy_version}, "
          f"matplotlib imports: {have_mpl}", flush=True)
    launches, laps = {}, Laps()
    from tpusysbio_torch.linalg import gpu_lu

    launches["sbml"] = phase_sbml(card)
    laps("sbml")
    launches["petab-mapk22"], petab_timed = phase_petab_mapk22(card, problem)
    laps("petab-mapk22")
    gpu_lu.reset_launches()
    phase_compat(card)
    launches["compat"] = dict(gpu_lu.LAUNCHES)
    laps("compat")
    gpu_lu.reset_launches()
    phase_plot(card)
    launches["plot"] = dict(gpu_lu.LAUNCHES)
    laps("plot")
    laps.report("the model and data surfaces")
    return launches, petab_timed


def jakstat_screen():
    """The screening ``Project`` of ``configs/jakstat.yaml`` and its 256
    starts, as ``cli.py`` builds them."""
    import argparse

    import torch

    from tpusysbio_torch import cli
    from tpusysbio_torch.config import load_config
    from tpusysbio_torch.fit import latin_hypercube
    from tpusysbio_torch.project import Project

    spec = load_config(os.path.join(ROOT, "configs", "jakstat.yaml"))
    run = spec.run
    model, batch, pmap, _, theta = cli._synth_problem(
        argparse.Namespace(model=spec.model, **run), torch.device("cuda"))
    screen = Project(model=model, pmap=pmap, batch=batch,
                     config=spec.screen_solver)
    starts = latin_hypercube(torch.Generator().manual_seed(run["seed"]),
                             run["starts"], theta - run["spread"],
                             theta + run["spread"])
    return screen, starts


def phase_profile(run, label):
    """One call of ``run`` under torch.profiler: device-busy share, the
    number of device kernels and device time by kernel name."""
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
    print(f"[profile] {label}: wall {wall:.3f} s, device kernels "
          f"{len(events)}, device busy {busy_us / 1e6:.3f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall; idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%)", flush=True)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {tot / 1e3:9.2f} ms {cnt:7d}x  {name[:90]}")
    # the port's own kernels and the library's matrix products (the Schur
    # products of a factorization and the f32 solves among them)
    for label, part in (("Gauss-Jordan kernels", "gj_inverse"),
                        ("refined-solve kernel", "refine_solve"),
                        ("matrix products (gemm kernels)", "gemm")):
        tot = sum(v[0] for k, v in by_name.items() if part in k)
        cnt = sum(v[1] for k, v in by_name.items() if part in k)
        print(f"[profile]   {label}: {tot / 1e3:.2f} ms in {cnt} kernels "
              f"({100 * tot / 1e6 / wall:.2f}% of wall, "
              f"{100 * tot / max(busy_us, 1):.1f}% of device busy)",
              flush=True)


def phase_cli_paths(card, depth, ensemble_iters, profile_fit_iters):
    """The CLI paths; returns their launch counts by path."""
    launches, ref = {}, {}
    with tempfile.TemporaryDirectory() as tmpdir:
        for name in CLI_CONFIGS:
            launches[f"cli-{name}"], ref[name] = phase_cli(
                name, card, tmpdir, depth,
                MESH_RANKS if name == "mapk22" else None)
        launches["cli-mapk22-mesh"] = phase_cli_mesh(
            "mapk22", card, tmpdir, depth, ref["mapk22"])
    phase_jakstat_ensemble(card, ensemble_iters)
    launches["profile-mm3"] = phase_profile_mm3(card, profile_fit_iters)
    return launches


# --------------------------------------------------------------------------
# Multi-device: ranks of a process group sharing the one card
# --------------------------------------------------------------------------

MESH_RANKS = 2               # [mesh-fit], [cli-mapk22-mesh]
MESH_RANK_FLAG = "--mesh-rank"
MESH_TIMEOUT = 600.0         # seconds for a rank process, start-up included
MESH_GROUP_TIMEOUT = 300.0   # the process group's own timeout


def start_ranks(kind, rendezvous, outdir, extra=(), env=None):
    """``mesh_rank_main`` in ``MESH_RANKS`` processes on this card; ``env``
    maps a rank to the extra environment of its process."""
    procs = []
    for r in range(MESH_RANKS):
        penv = dict(os.environ, **(env(r) if env else {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), MESH_RANK_FLAG, kind,
             str(r), str(MESH_RANKS), rendezvous, outdir, *extra],
            cwd=ROOT, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def join_ranks(tag, procs, outdir):
    """Wait for the ranks (killing all of them past ``MESH_TIMEOUT``),
    show their error output, check their exit codes, and return their
    standard outputs and the records they wrote."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail(f"{tag}: a rank ran past {MESH_TIMEOUT:.0f} s")
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print("\n".join(f"[{tag} rank {r}] {line}" for line in (
                out.splitlines() + err.splitlines())[-60:]), flush=True)
        check(p.returncode == 0, f"{tag}: rank {r} exited with "
              f"{p.returncode}")
    recs = []
    for r in range(len(procs)):
        with open(os.path.join(outdir, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
    return [out for out, _ in outs], recs


def check_rank_launches(tag, recs):
    """K1 and K2 launched in every rank, K3 in none; the sum by kernel."""
    for rec in recs:
        check_k1_k2(f"{tag} rank {rec['rank']}", rec["launches"])
    return {k: sum(rec["launches"][k] for rec in recs)
            for k in recs[0]["launches"]}


# the bound on [mesh-fit]'s polished costs against [fit]'s: the ranks
# fit half batches, and on the card a member's bits depend on the size of
# its batch ([cli-mapk22-mesh] shows the sharded fit equal to the same fit
# by blocks bit for bit, and not to the whole batch); the unconverged
# polish grows that to 2.7e-6 (PERF.md §6). [fit]'s CPU cross-check holds
# the same polish to this bound.
MESH_ROUNDING_BOUND = 1e-4


def phase_mesh_fit(card, fit_ref):
    """``[fit]``'s problem and starts through ``TwoPhaseDriver(mesh=)``
    over two ranks sharing the card (gloo): 128 starts screened a rank,
    the gathered screen ranked on both, the 16 best polished 8 + 8. Both
    ranks must return the same gathered results bit for bit, the screened
    statuses, the polished set and the polished statuses ``[fit]``'s, and
    the ranked polished costs ``[fit]``'s to ``MESH_ROUNDING_BOUND``; K1
    and K2 launched in each rank."""
    bound = MESH_ROUNDING_BOUND
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = start_ranks("fit", os.path.join(d, "init"), d)
        _, recs = join_ranks("mesh-fit", procs, d)
        wall = time.perf_counter() - t0
        arrs = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                for r in range(MESH_RANKS)]
    diff = [k for k in arrs[0] if not np.array_equal(arrs[0][k], arrs[1][k])]
    got = arrs[0]
    s_same = bool(np.array_equal(got["screen_status"],
                                 fit_ref["screen_status"]))
    s_cost = got["screen_cost"]
    s_rel = float(np.nanmax(np.abs(s_cost - fit_ref["screen_cost"])
                            / np.abs(fit_ref["screen_cost"])))
    ref_cost = fit_ref["polish_cost"]
    rel = float(np.max(np.abs(got["polish_cost"] - ref_cost)
                       / np.abs(ref_cost)))
    bitwise = bool(np.array_equal(got["polish_cost"], ref_cost))
    same_set = bool(np.array_equal(
        np.sort(got["polish_theta0"], axis=0),
        np.sort(fit_ref["polish_theta0"], axis=0)))
    for rec in recs:
        print(f"[mesh-fit] rank {rec['rank']} of {MESH_RANKS}: backend "
              f"{rec['backend']}, device {rec['mesh_device']} "
              f"({rec['device']}), TwoPhaseDriver run {rec['wall']:.2f} s "
              f"(screen {rec['screen_seconds']:.2f} s, polish "
              f"{rec['polish_seconds']:.2f} s); launches {rec['launches']}",
              flush=True)
    print(f"[mesh-fit] {card}: {FIT_STARTS} starts over {MESH_RANKS} ranks "
          f"on one card, top_k {FIT_TOP_K} polished "
          f"{FIT_TOP_K // MESH_RANKS} a rank, {FIT_SCREEN_ITERS} screen + "
          f"{FIT_POLISH_ITERS} polish LM iterations: phase wall {wall:.2f} "
          f"s with the ranks' start-up ([fit]'s run in one process: "
          f"{fit_ref['wall']:.2f} s); the ranks' gathered results differ in "
          f"{diff or 'nothing'}; screened statuses [fit]'s: {s_same} ("
          f"{int(np.isfinite(s_cost).sum())}/{FIT_STARTS} finite costs, "
          f"largest rel {s_rel:.3e} from [fit]'s); polished sets "
          f"[fit]'s: {same_set}; ranked polished costs "
          f"{got['polish_cost'][:4].tolist()}... against [fit]'s: bit for "
          f"bit {bitwise}, largest rel {rel:.3e} (bound {bound:g})",
          flush=True)
    check(not diff, f"mesh-fit: the ranks' results differ in {diff}")
    check(s_same, "mesh-fit: the screened statuses differ from [fit]'s")
    check(same_set, "mesh-fit: another top_k was polished than [fit]'s")
    check(bool(np.array_equal(got["polish_status"],
                              fit_ref["polish_status"])),
          "mesh-fit: the polished statuses differ from [fit]'s")
    check(rel <= bound, f"mesh-fit: polished costs rel {rel:.3e}")
    return check_rank_launches("mesh-fit", recs)


# the bound on [cli-mapk22-mesh]'s best cost against [cli-mapk22]'s (the
# whole batch in one process, whose members round otherwise): the same
# start is best in both, 1.524e-4 apart on the H100 (PERF.md §6); other
# polished starts part by up to 7.4e-3, so this bound holds the best alone
CLI_MESH_BOUND = 1e-3


def phase_cli_mesh(name, card, tmpdir, depth, ref):
    """``multistart --config configs/<name>.yaml`` (its ``mesh:`` section)
    at ``depth``, launched as ``torchrun --nproc_per_node=2`` launches it:
    two processes with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set, in which the CLI joins the group itself. Rank 0
    prints the record, rank 1 nothing; both ranks hold the same screen and
    polish bit for bit, and they are those of ``block_reference`` (the
    same fit in one process by blocks, ``ref["blocks"]``) bit for bit: each
    start's screened status and cost, the polished starts, their statuses
    and costs. Against the whole batch in one process (``ref``), whose
    members round otherwise, the polished sets and costs are printed and
    the best cost is held to ``CLI_MESH_BOUND``; the best cost at most the
    cost at truth."""
    import socket

    path = config_path(name, tmpdir, depth)
    with open(path) as fh:
        check("\nmesh:" in fh.read(), f"{path} has no mesh section")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    def env(r):
        return {"RANK": str(r), "LOCAL_RANK": str(r),
                "WORLD_SIZE": str(MESH_RANKS),
                "LOCAL_WORLD_SIZE": str(MESH_RANKS),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = start_ranks("cli", "env", d, (path,), env)
        stdouts, recs = join_ranks(f"cli-{name}-mesh", procs, d)
        wall = time.perf_counter() - t0
        arrs = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                for r in range(MESH_RANKS)]
    lines = stdouts[0].strip().splitlines()
    rec = json.loads(lines[0])
    best, truth = rec["best_cost"], recs[0]["cost_at_truth"]
    diff = [k for k in arrs[0] if not np.array_equal(arrs[0][k], arrs[1][k])]
    block_diff = [k for k in arrs[0]
                  if not np.array_equal(arrs[0][k], ref["blocks"][k])]
    # against the whole batch, start by start
    got, want = by_start(arrs[0]), by_start(ref)
    common = [k for k in want if k in got]
    statuses = sum(got[k][0] == want[k][0] for k in common)
    rels = np.array([abs(got[k][1] - want[k][1]) / abs(want[k][1])
                     for k in common])
    s_rel = float(np.nanmax(np.abs(arrs[0]["all_screen_cost"]
                                   - ref["all_screen_cost"])
                            / np.abs(ref["all_screen_cost"])))
    s_same = int((arrs[0]["all_screen_status"]
                  == ref["all_screen_status"]).sum())
    ref_best = float(ref["cost"].min())
    best_rel = abs(best - ref_best) / abs(ref_best)
    best_start = (int(arrs[0]["start"][np.argmin(arrs[0]["cost"])]),
                  int(ref["start"][np.argmin(ref["cost"])]))
    for line in lines:
        print(f"[cli-{name}-mesh] rank 0 printed: {line}", flush=True)
    for r in recs:
        print(f"[cli-{name}-mesh] rank {r['rank']}: device {r['device']}, "
              f"cli.main {r['wall']:.2f} s, best cost {r['best_cost']:.9f}; "
              f"launches {r['launches']}", flush=True)
    n = len(arrs[0]["all_screen_cost"])
    print(f"[cli-{name}-mesh] {card}: {rec['starts']} starts over "
          f"{MESH_RANKS} ranks (backend {recs[0]['backend']}), top_k "
          f"{rec['top_k']}, LM iterations {depth or 'of the run file'}: "
          f"phase wall {wall:.2f} s with the ranks' start-up; the ranks' "
          f"screen and polish differ in {diff or 'nothing'}; from the same "
          f"fit by blocks in one process in {block_diff or 'nothing'}. "
          f"Against the whole batch in one process: screened statuses equal "
          f"on {s_same} of {n} starts, screened costs largest rel "
          f"{s_rel:.3e}; {len(common)} of {len(want)} polished starts in "
          f"both, statuses equal on {statuses} of them, their polished "
          f"costs largest rel {float(rels.max()):.3e}, median "
          f"{float(np.median(rels)):.3e}; best cost {best:.9f} at start "
          f"{best_start[0]} (one process: {ref_best:.9f} at start "
          f"{best_start[1]}, rel {best_rel:.3e}, bound {CLI_MESH_BOUND:g}), "
          f"cost at truth {truth:.9f}; rank 1 printed {len(stdouts[1])} "
          "characters", flush=True)
    check(stdouts[1] == "", f"cli-{name}-mesh: rank 1 printed "
          f"{stdouts[1][:200]!r}")
    check(not diff, f"cli-{name}-mesh: the ranks' results differ in {diff}")
    check(not block_diff, f"cli-{name}-mesh: the sharded fit differs from "
          f"the same fit by blocks in {block_diff}")
    check(best == float(arrs[0]["cost"].min()),
          f"cli-{name}-mesh: the record's best cost is not the polish's")
    check(best_rel <= CLI_MESH_BOUND, f"cli-{name}-mesh: best cost rel "
          f"{best_rel:.3e} from the whole batch's")
    check(np.isfinite(best) and best <= truth * (1 + 1e-6),
          f"cli-{name}-mesh: best cost {best} > cost at truth {truth}")
    return check_rank_launches(f"cli-{name}-mesh", recs)


def mesh_fit_rank(mesh, outdir):
    """One rank of ``[mesh-fit]``: the same starts as every rank (checked
    by a gathered digest), the driver's run, its launches."""
    import hashlib

    import torch
    import torch.distributed as dist

    from tpusysbio_torch import utils
    from tpusysbio_torch.fit import latin_hypercube
    from tpusysbio_torch.linalg import gpu_lu

    tight, screen, theta_true = build_fit_problem(mesh.device)
    starts = latin_hypercube(torch.Generator().manual_seed(0), FIT_STARTS,
                             theta_true - 1.0, theta_true + 1.0)
    digest = torch.tensor(list(hashlib.sha256(
        starts.cpu().numpy().tobytes()).digest()), dtype=torch.uint8)
    check(all(torch.equal(d, digest) for d in utils.all_gather(digest, mesh)),
          "mesh-fit: the ranks built different starts")
    fit = two_phase(tight, screen, FIT_TOP_K, FIT_SCREEN_ITERS,
                    FIT_POLISH_ITERS, mesh=mesh)
    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    polish, scr, info = fit.run(starts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gpu_lu.LAUNCHES)
    ranked = polish.ranked()
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"),
             screen_status=scr.status.cpu().numpy(),
             screen_cost=scr.cost.cpu().numpy(),
             screen_theta=scr.theta.cpu().numpy(),
             polish_cost=ranked.cost.cpu().numpy(),
             polish_status=ranked.status.cpu().numpy(),
             polish_theta=ranked.theta.cpu().numpy(),
             polish_theta0=ranked.theta0.cpu().numpy())
    rec = {"launches": launches, "wall": wall,
           "screen_seconds": info["screen_seconds"],
           "polish_seconds": info["polish_seconds"],
           "backend": dist.get_backend(), "mesh_device": str(mesh.device)}
    dist.destroy_process_group()
    return rec


def cli_mesh_rank(path, outdir, rank):
    """One rank of ``[cli-<name>-mesh]``: ``cli.main`` with the group's
    environment, as ``torchrun`` runs ``python -m tpusysbio_torch.cli``;
    the ranked polish to ``outdir/rank<rank>.npz``."""
    import torch

    from tpusysbio_torch import cli, utils
    from tpusysbio_torch.linalg import gpu_lu

    gpu_lu.reset_launches()
    t0 = time.perf_counter()
    out = cli.main(["multistart", "--config", path])
    torch.cuda.synchronize()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             **polish_arrays(out))
    # the backend that the CLI's distributed_initialize chose (it leaves
    # the group before returning)
    backend = utils.default_backend(torch.cuda.device_count(),
                                    int(os.environ["LOCAL_WORLD_SIZE"]))
    return {"launches": dict(gpu_lu.LAUNCHES),
            "wall": time.perf_counter() - t0,
            "best_cost": out["record"]["best_cost"],
            "cost_at_truth": out["cost_at_truth"], "backend": backend}


def mesh_rank_main(kind, rank, world, rendezvous, outdir, *extra):
    """A rank process of ``[mesh-fit]`` (``kind`` fit: the group joined
    through the file ``rendezvous``) or ``[cli-<name>-mesh]`` (``kind``
    cli: the CLI joins it from the environment). It loads the kernels that
    the parent built (never builds them: two ranks must not race nvcc)
    and writes its record to ``outdir/rank<rank>.json``."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, ROOT)
    import tpusysbio_torch  # noqa: F401  (sets true-f32 matmuls)
    from tpusysbio_torch import utils
    from tpusysbio_torch.linalg import _build, gpu_lu

    gpu_lu._LAYOUT = "minor"
    rank, world = int(rank), int(world)
    _build.load()
    check(_build.build_info.get("cached"),
          f"{kind} rank {rank}: the kernels were not built before the "
          "ranks started")
    if kind == "fit":
        utils.distributed_initialize(num_processes=world, process_id=rank,
                                     init_method=f"file://{rendezvous}",
                                     timeout_s=MESH_GROUP_TIMEOUT)
        rec = mesh_fit_rank(utils.make_mesh(), outdir)
    else:
        rec = cli_mesh_rank(extra[0], outdir, rank)
    rec.update(rank=rank, device=torch.cuda.get_device_name(
        torch.cuda.current_device()))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


CLI_GROUP_FLAG = "--cli-group"
CLI_GROUP_TIMEOUT = 1100.0   # seconds from the start to the CLI group's end


def start_cli_group(launches_path):
    """``cli_group_main`` in a second process on the same card, its output
    on this one's: every path is host-bound (the card idle ~95%, PERF.md
    §5), and in one process the whole took 1013-1406 s against the 1200 s
    limit (PERF.md §4). It writes its launches by path to
    ``launches_path``."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             CLI_GROUP_FLAG, launches_path], cwd=ROOT)


def watch_cli_group(proc):
    """Fail at once where the CLI group has failed (run at every lap)."""
    code = proc.poll()
    if code not in (None, 0):
        fail(f"the CLI group exited with {code}")


def join_cli_group(proc, launches_path, t_start):
    """Wait for the CLI group, check its exit code and return its
    launches by path."""
    try:
        code = proc.wait(timeout=max(
            1.0, CLI_GROUP_TIMEOUT - (time.perf_counter() - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        code = None
    check(code == 0, f"the CLI group exited with {code}")
    with open(launches_path) as fh:
        return json.load(fh)


def cli_group_main(launches_path):
    """The second process: the CLI paths, the pulse, pre-equilibration and
    sampling paths, their laps and launches."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, ROOT)
    import tpusysbio_torch  # noqa: F401  (sets true-f32 matmuls)
    from tpusysbio_torch.linalg import _build, gpu_lu

    gpu_lu._LAYOUT = "minor"
    card = phase_device()
    _build.load()
    laps = Laps()
    launches = phase_cli_paths(card, CLI_DEPTH, ENSEMBLE_ITERS,
                               PROFILE_FIT_ITERS)
    laps("cli-*, jakstat-ensemble, profile-mm3")
    launches["pulse"] = phase_pulse(card, PULSE_FIT_ITERS)
    laps("pulse")
    launches["preeq"] = phase_preeq(card)
    laps("preeq")
    launches["sample-mm3"] = phase_sample_mm3(card, SAMPLE_STEPS, SAMPLE_BURN,
                                              SAMPLE_FIT_ITERS)
    laps("sample-mm3")
    laps.report("the CLI group (a process of its own)")
    with open(launches_path, "w") as fh:
        json.dump(launches, fh)


def parent_paths(card, laps):
    """The paths of the first process that run beside the CLI group: the
    main path, the fit and EGFR paths, the small models' golden runs, the
    TRF path, the other steppers and the surfaces."""
    l_main, run = phase_main_path()
    laps("main")
    (l_fit, l_screen, l_polish), problem, fit_top, fit_ref = phase_fit()
    laps("fit")
    l_major = phase_fit_major(problem)
    laps("fit-major")
    l_mesh = phase_mesh_fit(card, fit_ref)
    laps("mesh-fit")
    l_egfr_sens, egfr = phase_egfr_sens(card)
    laps("egfr-sens")
    l_egfr_fit = phase_egfr_fit(card, egfr)
    laps("egfr-fit")
    l_egfr_major = phase_egfr_major(egfr)
    laps("egfr-major")
    phase_golden_small(card)
    laps("golden-small")
    l_small = {"mesh-fit": l_mesh,
               "fit-trf": phase_fit_trf(card, problem, fit_top,
                                        FIT_TRF_ITERS)}
    laps("fit-trf")
    l_small.update(phase_other_steppers(card, problem))
    laps("the other steppers")
    l_surf, petab_timed = phase_surfaces(card, problem)
    l_small.update(l_surf)
    laps("the model and data surfaces")
    return l_small, problem, egfr, run, petab_timed, (
        l_main, (l_fit, l_screen, l_polish), l_major, l_egfr_sens,
        l_egfr_fit, l_egfr_major)


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

    from tpusysbio_torch.linalg import gpu_lu

    # every phase names the layout it runs; none takes it from the caller's
    # environment
    gpu_lu._LAYOUT = "minor"
    t_start = time.perf_counter()
    laps = Laps()
    card = phase_device()
    phase_build()
    laps("device, build")
    model = library.mapk_huang_ferrell(device="cuda")
    rng = np.random.default_rng(1234)
    kernels = [phase_k1(model, rng), phase_k2(model, rng),
               phase_k3(model, rng)]
    phase_floor()
    laps("K1, K2, K3, floor")
    with tempfile.TemporaryDirectory() as group_dir:
        group_launches = os.path.join(group_dir, "launches.json")
        group = start_cli_group(group_launches)
        Laps.watch = lambda: watch_cli_group(group)
        try:
            l_small, problem, egfr, run, petab_timed, rest = parent_paths(
                card, laps)
        except BaseException:
            group.kill()
            raise
        Laps.watch = None
        l_small.update(join_cli_group(group, group_launches, t_start))
    laps("the CLI group's remainder")
    # with no second process: the banded path and its timings, the
    # imported model's evaluation beside the native one, and the kernel
    # timings at n = 2-6 and n = 44
    gpu_lu.reset_launches()
    phase_banded(card)
    l_small["banded"] = dict(gpu_lu.LAUNCHES)
    laps("banded")
    petab_timed()
    laps("petab-mapk22 timed")
    k1_small, k2_small = phase_small_kernels(rng)
    kernels[0]["small_n"], kernels[1]["small_n"] = k1_small, k2_small
    kernels[2]["small_n"] = {}
    k1_n44, k2_n44 = phase_n44_kernels(rng)
    laps("K1-small, K2-small, K1-n44, K2-n44")
    l_main, (l_fit, l_screen, l_polish), l_major = rest[:3]
    l_egfr_sens, l_egfr_fit, l_egfr_major = rest[3:]
    laps.report("the whole script")
    if "--profile" in sys.argv[1:]:
        phase_profile(run, "one main-path batch")
        screen, starts = problem[1], problem[3]
        phase_profile(lambda: (screen.residuals_and_jacobian(starts),
                               torch.cuda.synchronize()),
                      "one screening evaluation of 256 starts")
        phase_profile(lambda: (egfr[0].evaluate(egfr[2], with_jac=True),
                               torch.cuda.synchronize()),
                      "one EGFR evaluation of 64 members with Jacobian")
        jak_screen, jak_starts = jakstat_screen()
        phase_profile(lambda: (jak_screen.residuals_and_jacobian(jak_starts),
                               torch.cuda.synchronize()),
                      "one JAK-STAT screening evaluation of 256 starts")
    # the kernels' share of [fit]: each phase's launches times the
    # kernel's time at that phase's batch
    k1_ms, k2_ms = kernels[0]["ms_by_batch"], kernels[1]["ms_by_batch"]
    fit_ms = (l_screen["gj_inverse_f32"] * k1_ms[BATCH]
              + l_polish["gj_inverse_f32"] * k1_ms[POLISH_BATCH]
              + l_polish["refine_solve"] * k2_ms[POLISH_BATCH])
    print(f"[fit] device time of the kernels: screen K1 "
          f"{l_screen['gj_inverse_f32']} x {k1_ms[BATCH]:.4f} ms (B={BATCH})"
          f" + polish K1 {l_polish['gj_inverse_f32']} x "
          f"{k1_ms[POLISH_BATCH]:.4f} ms + K2 {l_polish['refine_solve']} x "
          f"{k2_ms[POLISH_BATCH]:.4f} ms (B={POLISH_BATCH}) = "
          f"{fit_ms / 1e3:.4f} s", flush=True)
    # K1 at the block-Schur shapes was timed beside K3 in [K3]
    beside = kernels[2].pop("beside_k1")
    kernels[0]["ms_by_batch"] = {**kernels[0]["ms_by_batch"],
                                 4096: beside["ms_by_batch"][4096]}
    kernels[0]["max_abs_err_by_case"].update(
        {k: v for k, v in beside["max_abs_err_by_case"].items()
         if "egfr" in k})
    for key in ("ms_by_shape", "bound_ms_by_shape", "library_ms_by_shape"):
        kernels[0][key] = dict(beside[key])
        kernels[1][key] = {}
    # the Gauss-Jordan kernel's share of one [egfr-sens] batch
    egfr_ms = sum(l_egfr_sens["gj_inverse_f32"] / 2 * ms
                  for ms in kernels[0]["ms_by_shape"].values())
    print(f"[egfr-sens] device time of the kernel: K1 "
          f"{l_egfr_sens['gj_inverse_f32'] // 2} x "
          f"({' + '.join(f'{v:.4f}' for v in kernels[0]['ms_by_shape'].values())}"
          f") ms = {egfr_ms / 1e3:.4f} s per batch", flush=True)
    # K1 and K2 on Radau's 2n=44 embeddings of MAPK-22
    shape = f"({RADAU_BATCH}, 44, 44) radau"
    for kern, got in ((kernels[0], k1_n44), (kernels[1], k2_n44)):
        kern["ms_by_shape"][shape] = got["ms"]
        kern["bound_ms_by_shape"][shape] = got["bound_ms"]
        kern["library_ms_by_shape"][shape] = got["library_ms"]
        kern["max_abs_err_by_case"]["n44 radau"] = got["max_abs_err"]
    for kern in kernels:
        name = kern["name"]
        by_path = {"main": l_main[name], "fit": l_fit[name],
                   "fit-major": l_major[name],
                   "egfr-sens": l_egfr_sens[name],
                   "egfr-fit": l_egfr_fit[name],
                   "egfr-major": l_egfr_major[name],
                   **{path: l[name] for path, l in l_small.items()}}
        kern["launches_by_path"] = by_path
        kern["launches"] = sum(by_path.values())
        check(kern["launches"] > 0,
              f"kernel {kern['name']} was launched on none of the paths")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "max_abs_err_by_case", "ms",
            "ms_by_batch", "host_paced_ms_by_batch", "ms_by_shape",
            "bound_ms_by_shape", "library_ms_by_shape", "small_n",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [CLI_GROUP_FLAG]:
        cli_group_main(sys.argv[2])
    elif sys.argv[1:2] == [MESH_RANK_FLAG]:
        mesh_rank_main(*sys.argv[2:])
    else:
        main()
