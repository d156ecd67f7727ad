"""The benchmark's driver: one cell, one seed, one run.

Everything that belongs to a configuration, a cell or a per-layer metric
is found by its name in ``BENCHMARK.json``:

- ``portbench/configs/<config>.json``: the model configuration (its
  source, sizes, solver settings and a frozen copy of its network);
- ``portbench/workloads/<cell>.json``: the cell (its configuration, the
  entry it drives, its traffic mix's name and parameters: sizes, spreads,
  solver settings, and the limits of its comparison; ``rate_metric``
  where its rate has another name than the entry's; ``reduced``, each
  traffic key cut and the value it was cut from);
- ``portbench/entries/<kind>.py``: the driver of one entry the window
  drives (``Entry``);
- ``portbench/metrics/<metric>.py``: the reader of one per-layer metric
  (``read(trace)``, None when it finds nothing to read).

A run: set up and warm up the cell's entry (``setup_s``), run whole units
back to back for ``seconds`` (the unit running when time is up finishes
and counts), read the device's memory peak, free the program's state, then
compare what the window produced with the plain reference
(``portbench/reference/``). A traced run takes host-clock spans and
counters over the window's units, then profiles one more unit; it reports
the per-layer metrics in place of the end-to-end ones.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusysbio")


class Refused(RuntimeError):
    """The run cannot produce a result (no card, a forbidden import)."""


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_cell(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def load_module(path: Path, tag: str):
    """Import the file ``path`` as a module of its own (metric files have
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{tag}_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the draw ``keys`` of run ``seed`` (any integer,
    also past 64 bits)."""
    words = [(k if isinstance(k, int)
              else int.from_bytes(k.encode(), "little")) % (1 << 64)
             for k in (seed, *keys)]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run may not load, each
    compared whole (``tpusysbio_torch`` is not ``tpusysbio``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs():
    """Keep every kernel cache at a fixed path inside the checkout: the
    port builds into ``build/tpusysbio_torch_kernels`` beside its package,
    and Triton, when a later kernel uses it, into ``build/triton``."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def check_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA devices, "
                      f"{torch.cuda.device_count()} found")


class Context:
    """What an entry is given: the cell, its configuration, the seed, the
    device, the recorder of a traced run (None otherwise) and the control
    that replaces the program (None in the benchmark's own runs)."""

    def __init__(self, cell, cfg, seed, device, recorder=None,
                 control=None):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device, self.recorder, self.control = device, recorder, control
        self.traffic = cell["traffic"]

    def solver_config(self, key: str):
        """The port's ``SolverConfig`` of the configuration's solver
        ``key``."""
        from tpusysbio_torch import SolverConfig

        return SolverConfig(**self.cfg["solvers"][key])

    def model(self):
        from tpusysbio_torch.model import library

        port = self.cfg["port_model"]
        return getattr(library, port["factory"])(**port["kwargs"],
                                                 device=self.device)


def load_entry(ctx: Context):
    mod = load_module(HERE / "entries" / f"{ctx.cell['entry']}.py", "entry")
    return mod.Entry(ctx)


def synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(entry, seconds: float, device, first: int = 0,
               recorder=None) -> dict:
    """Whole units back to back from unit ``first`` until ``seconds`` have
    passed; the unit running at the end finishes and counts."""
    totals = dict(units=0, attempted=0, failed=0, work=0, unit_seconds=[])
    i = first
    t0 = time.perf_counter()
    while True:
        if recorder is not None:
            recorder.begin_unit(i, profiled=False)
        t_unit = time.perf_counter()
        out = entry.unit(i)
        synchronize(device)
        totals["unit_seconds"].append(time.perf_counter() - t_unit)
        if recorder is not None:
            recorder.end_unit(out)
        for k in ("attempted", "failed", "work"):
            totals[k] += out[k]
        totals["units"] += 1
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    totals["seconds"] = time.perf_counter() - t0
    return totals


def profiled_unit(entry, device, recorder, index: int,
                  host_ops: bool = True) -> dict:
    """Unit ``index`` under ``torch.profiler``, reduced in memory to what
    the metrics read. ``host_ops=False`` records the device's activity and
    the CUDA calls alone, not every host operation: a unit of millions of
    operations then stays inside a run's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace

    recorder.begin_unit(index, profiled=True)
    acts = [ProfilerActivity.CPU] if host_ops else []
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.unit"):
            out = entry.unit(index)
        synchronize(device)
        wall = time.perf_counter() - t0
    recorder.end_unit(out)
    t0 = time.perf_counter()
    recorder.profile = trace.reduce_profile(prof, wall)
    log(f"profile of unit {index}: {wall:.1f} s, reduced in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{recorder.profile['n_device_ops']} device operations")
    return out


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def read_metrics(names, trace) -> dict:
    """Each named per-layer metric that its reader finds."""
    bench = {m["name"]: m for m in benchmark()["per_layer"]}
    out = {}
    for name in names:
        mod = load_module(HERE / "metrics" / f"{name}.py", "metric")
        value = mod.read(trace)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {name} read {value}")
        out[name] = {"value": float(value), "unit": bench[name]["unit"]}
    return out


def cell_metrics(cell_name: str, kind: str) -> list:
    """The names of the ``end_to_end`` or ``per_layer`` metrics this cell
    reports."""
    bench = benchmark()
    if kind == "end_to_end":
        return [m["name"] for m in bench["end_to_end"]
                if cell_name in m.get("workloads", [cell_name])]
    e2e = set(cell_metrics(cell_name, "end_to_end"))
    return [m["name"] for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in e2e]


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float = None, cell: dict = None,
             cfg: dict = None, control: str = None) -> dict:
    """One run of ``cell_name``; returns the result line as a dict. Tests
    pass ``cell`` and ``cfg`` of a tiny cell of their own and
    ``device="cpu"``."""
    import torch

    from portbench import trace

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(cell_name) if cell is None else cell
    cfg = load_config(cell["config"]) if cfg is None else cfg
    on_card = torch.device(device).type == "cuda"
    if on_card:
        check_device(cell["chips"])
        torch.cuda.reset_peak_memory_stats()
    set_cache_dirs()
    recorder = trace.Recorder(cell, cfg, device) if traced else None
    ctx = Context(cell, cfg, seed, device, recorder, control)
    entry = load_entry(ctx)
    entry.warmup()
    synchronize(device)
    setup_s = time.perf_counter() - t_start

    log(f"set-up {setup_s:.1f} s")
    if traced:
        # the window first: a profiled unit leaves the process slower
        with recorder.installed():
            totals = run_window(entry, seconds, device, recorder=recorder)
            profiled_unit(entry, device, recorder, totals["units"],
                          cell["traffic"].get("profile_host_ops", True))
    else:
        totals = run_window(entry, seconds, device)
    log(f"window {totals['seconds']:.1f} s, {totals['units']} units")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rate = entry.rate(totals)
    entry.free()
    t0 = time.perf_counter()
    checks = entry.checks()
    log(f"checks {time.perf_counter() - t0:.1f} s")
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that a run may not load: {found}")

    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if traced:
        names = cell_metrics(cell_name, "per_layer")
        metrics = read_metrics(names, recorder)
    else:
        value, unit = rate
        metrics = {cell.get("rate_metric", entry.rate_metric):
                   {"value": float(value), "unit": unit}}
        metrics["setup_s"] = {"value": float(setup_s), "unit": "s"}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]) if on_card else 1,
           "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(totals["attempted"]),
            "failed": int(totals["failed"]), "metrics": metrics,
            "device": dev}
    if traced:
        dev["busy_s"] = recorder.profile["busy_s"]
        dev["window_s"] = recorder.profile["window_s"]
        line["breakdown"] = recorder.profile["breakdown"]
    line["unit_seconds"] = totals["unit_seconds"]
    line["checks"] = checks
    return line
