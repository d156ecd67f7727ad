"""What the per-layer readers share: each metric file names one quantity
and calls one of these on the run's ``trace.Recorder``. Every reader
returns None when the run gave it nothing to read."""

from __future__ import annotations

from pathlib import Path

from portbench.metrics import _counting as cnt

HERE = Path(__file__).resolve().parent


def _calls(units):
    return [c for u in units for c in u["calls"]]


def ms_per_trip(trace):
    """Wall of the stepper calls over the trips of their batched step
    loops (each call's largest ``nsteps``), in ms."""
    calls = _calls(trace.measured())
    trips = sum(c["max_nsteps"] for c in calls)
    if not trips:
        return None
    return 1e3 * sum(c["wall"] for c in calls) / trips


def reject_pct(trace):
    calls = _calls(trace.measured())
    steps = sum(c["nsteps"] for c in calls)
    if not steps:
        return None
    return 100.0 * sum(c["nrejected"] for c in calls) / steps


def mean_info(trace, key):
    vals = [u["info"][key] for u in trace.measured() if key in u["info"]]
    return sum(vals) / len(vals) if vals else None


def evals_per_iter(trace):
    units = trace.measured()
    calls = sum(u["counts"]["residual_calls"] + u["counts"]["jacobian_calls"]
                for u in units)
    iters = sum(u["info"].get("lm_iters", 0) for u in units)
    return calls / iters if iters else None


def span_ms(trace, prefix):
    walls = [w for u in trace.measured() for name, w in u["spans"]
             if name.startswith(prefix)]
    return 1e3 * sum(walls) / len(walls) if walls else None


def _roofline(trace, work, peak, kernel_list):
    calls = _calls(trace.profiled())
    flops = sum(work(c)[0] for c in calls)
    nbytes = sum(work(c)[1] for c in calls)
    seconds = trace.kernel_seconds(cnt.kernel_patterns(HERE / kernel_list))
    if not flops or seconds is None:
        return None
    return 100.0 * cnt.least_seconds(flops, nbytes, peak) / seconds


def lu_roofline(trace):
    """The factorizations' least time over the device time of the
    factorization kernels, in the profiled unit."""
    return _roofline(trace, cnt.lu_work, cnt.F32_FLOPS, "lu_kernels.txt")


def solve_roofline(trace):
    """The f64 state-column solves' least time over the device time of
    the refined-solve kernels, in the profiled unit."""
    return _roofline(trace, cnt.state_solve_work, cnt.F64_FLOPS,
                     "solve_kernels.txt")


def idle_pct(trace):
    prof = trace.profile
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def step_mfu(trace):
    """The time the integrations' flops take at the card's peaks, over
    the window's wall, in %."""
    units = trace.measured()
    wall = sum(u["wall"] for u in units)
    shapes = cnt.Shapes(trace.cfg["network"])
    free = trace.cfg.get("fit", {}).get("free", [])
    names = [r[0] for r in trace.cfg["network"]["reactions"]]
    cols = [names.index(f) for f in free]
    nnz_free = int((shapes.S[:, cols] != 0).sum()) if cols else 0
    t = 0.0
    for c in _calls(units):
        dirs = None if c["K"] == shapes.m else nnz_free
        f64, f32 = cnt.step_flops(c, shapes, dirs)
        t += f64 / cnt.F64_FLOPS + f32 / cnt.F32_FLOPS
    if not wall or not t:
        return None
    return 100.0 * t / wall
