"""Spans, counters and the profiler's reduction of a traced run.

The benchmark records from its own files, around its calls into the
program's layers; nothing inside ``tpusysbio_torch`` is instrumented:

- every stepper call (``tpusysbio_torch.solvers.SOLVERS``, through which
  ``OdeModel`` and ``Project`` both reach the steppers) is wrapped for the
  run: its host-clock wall, ending in a synchronise, and the per-member
  counters its result carries (``nsteps``, ``naccepted``, ``nrejected``,
  ``nfev``, ``njev``, ``nlu``), with the shapes the work counts need;
- the entries add spans (``Recorder.span``) and call counts
  (``Recorder.count``) around the callables they hand the program;
- one unit runs under ``torch.profiler``; its events stay in memory and
  are reduced to the device's busy time, the device time by kernel name,
  and the idle time by what the host was doing (no trace file is
  written).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import numpy as np

COUNTERS = ("nsteps", "naccepted", "nrejected", "nfev", "njev", "nlu")
TOP = 10


class Recorder:
    """What a traced run records, unit by unit."""

    def __init__(self, cell, cfg, device):
        self.cell, self.cfg, self.device = cell, cfg, device
        self.units = []
        self.cur = None
        self.profile = None

    # -- units ---------------------------------------------------------
    def begin_unit(self, index, profiled):
        self.cur = dict(index=index, profiled=profiled, calls=[], spans=[],
                        counts=defaultdict(int), info={},
                        t0=time.perf_counter())

    def end_unit(self, out):
        self.cur["wall"] = time.perf_counter() - self.cur["t0"]
        self.cur["out"] = out
        self.units.append(self.cur)
        self.cur = None

    def measured(self):
        """The window's units (the profiled one is not timed)."""
        return [u for u in self.units if not u["profiled"]]

    def profiled(self):
        return [u for u in self.units if u["profiled"]]

    # -- spans and counts ----------------------------------------------
    @contextlib.contextmanager
    def span(self, name):
        """A host-clock span ending in a synchronise, also labelled for
        the profiler."""
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        _sync(self.device)
        if self.cur is not None:
            self.cur["spans"].append((name, time.perf_counter() - t0))

    def count(self, name, k=1):
        """Count ``name`` in the current unit (set-up counts nothing)."""
        if self.cur is not None:
            self.cur["counts"][name] += k

    def info(self, **kw):
        self.cur["info"].update(kw)

    # -- the stepper wrapper --------------------------------------------
    def _wrap(self, fn):
        def solve(*args, **kwargs):
            import torch

            from tpusysbio_torch.config import SolverConfig

            t0 = time.perf_counter()
            with torch.profiler.record_function("bdf_solve"):
                res = fn(*args, **kwargs)
            _sync(self.device)
            wall = time.perf_counter() - t0
            y0 = args[2]
            config = kwargs.get("config") or SolverConfig()
            s0 = kwargs.get("s0")
            K = int(s0.shape[-1]) if s0 is not None else 0
            sums = torch.stack([getattr(res, c).to(torch.int64).sum()
                                for c in COUNTERS]).tolist()
            mixed = bool(config.mixed_precision
                         and y0.dtype == torch.float64)
            call = dict(wall=wall, B=int(y0.shape[0]), n=int(y0.shape[1]),
                        K=K, mixed=mixed,
                        split=(config.sens_precision == "f32" and K > 0
                               and not mixed
                               and not config.sens_error_control),
                        linear_solver=config.linear_solver,
                        initial_fev=1 + (2 if config.first_step is None
                                         else 0),
                        max_nsteps=int(res.nsteps.max()),
                        **dict(zip(COUNTERS, sums)))
            if self.cur is not None:
                self.cur["calls"].append(call)
            return res

        return solve

    @contextlib.contextmanager
    def installed(self):
        """The stepper wrapper in place for the ``with`` block."""
        from tpusysbio_torch import solvers

        saved = dict(solvers.SOLVERS)
        try:
            for name, fn in saved.items():
                solvers.SOLVERS[name] = self._wrap(fn)
            yield self
        finally:
            solvers.SOLVERS.clear()
            solvers.SOLVERS.update(saved)

    # -- profile ---------------------------------------------------------
    def kernel_seconds(self, patterns):
        """Device seconds of the profiled unit's kernels whose names hold
        one of ``patterns``; None without a profile or such a kernel."""
        if self.profile is None:
            return None
        total = sum(s for name, s in self.profile["by_kernel"].items()
                    if any(p in name for p in patterns))
        return total if total > 0 else None


def is_span(name: str) -> bool:
    """Whether a profiler event is one of the benchmark's own spans."""
    return name in ("portbench.unit", "bdf_solve") or name.startswith(
        "project.")


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _merge(starts, ends):
    """The union of intervals, as sorted disjoint (starts, ends)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    ms = s[idx]
    me = np.append(run_end[idx[1:] - 1], run_end[-1]) if len(idx) else idx
    return ms, me


def _top_level(starts, ends, names):
    """Host operations not nested in another: sorted, disjoint."""
    order = np.argsort(starts, kind="stable")
    keep, last_end = [], -1
    for i in order:
        if starts[i] >= last_end:
            keep.append(i)
            last_end = ends[i]
        elif ends[i] > last_end:
            last_end = ends[i]
    keep = np.asarray(keep, dtype=np.int64)
    return starts[keep], ends[keep], [names[i] for i in keep]


def _label_at(t, starts, ends, names, default):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ends[i] >= t:
        return names[i]
    return default


def reduce_profile(prof, wall: float) -> dict:
    """Busy and idle time of the device over the profiled unit, device
    seconds by kernel name, and idle seconds by what the host was doing
    when each gap began (the benchmark span it falls in and the host
    operation running, or ``python`` between operations)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    d_s, d_e, d_name = [], [], []
    h_s, h_e, h_name = [], [], []
    a_s, a_e, a_name = [], [], []
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if is_span(name):        # the spans' copies on the device
                continue
            d_s.append(s)
            d_e.append(e)
            d_name.append(name)
        elif is_span(name):
            a_s.append(s)
            a_e.append(e)
            a_name.append(name)
        else:
            h_s.append(s)
            h_e.append(e)
            h_name.append(name)
    by_kernel = defaultdict(float)
    for s, e, name in zip(d_s, d_e, d_name):
        by_kernel[name[:160]] += (e - s) * 1e-9
    out = dict(window_s=float(wall), busy_s=0.0, by_kernel=dict(by_kernel),
               n_device_ops=len(d_s))
    unit = [(s, e) for s, e, n in zip(a_s, a_e, a_name)
            if n == "portbench.unit"]
    if not d_s:
        out["breakdown"] = {"device_ops": [], "idle_gaps": []}
        return out
    ms, me = _merge(np.asarray(d_s, np.int64), np.asarray(d_e, np.int64))
    # without host operations there are no spans: the unit's bounds are
    # then the host's first and last event
    u0, u1 = unit[0] if unit else (min(h_s + [int(ms[0])]),
                                   max(h_e + [int(me[-1])]))
    out["busy_s"] = float(np.sum(me - ms) * 1e-9)
    # idle gaps inside the unit: before the first op, between, after
    g_s = np.concatenate([[u0], me])
    g_e = np.concatenate([ms, [u1]])
    ok = g_e > g_s
    g_s, g_e = g_s[ok], g_e[ok]
    spans = sorted((s, e, n) for s, e, n in zip(a_s, a_e, a_name)
                   if n != "portbench.unit")
    sp_s, sp_e, sp_n = _top_level(np.asarray([s for s, _, _ in spans]),
                                  np.asarray([e for _, e, _ in spans]),
                                  [n for _, _, n in spans]) \
        if spans else ([], [], [])
    inner = [(s, e, n) for s, e, n in spans if n == "bdf_solve"]
    in_s = [s for s, _, _ in inner]
    in_e = [e for _, e, _ in inner]
    in_n = [n for _, _, n in inner]
    hs, he, hn = _top_level(np.asarray(h_s, np.int64),
                            np.asarray(h_e, np.int64), h_name) \
        if h_s else ([], [], [])
    hs, he = list(hs), list(he)
    sp_s, sp_e = list(sp_s), list(sp_e)
    idle = defaultdict(float)
    for s, e in zip(g_s.tolist(), g_e.tolist()):
        where = _label_at(s, in_s, in_e, in_n,
                          _label_at(s, sp_s, sp_e, sp_n, "portbench.unit"))
        what = _label_at(s, hs, he, hn, "python")
        idle[f"{where}: {what}"] += (e - s) * 1e-9
    top_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    out["breakdown"] = {"device_ops": [[k, v] for k, v in top_ops],
                        "idle_gaps": [[k, v] for k, v in top_idle]}
    return out
