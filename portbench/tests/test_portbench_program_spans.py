"""The readers of the program's own spans and counters
(``portbench/metrics/_program.py``): a tiny traced run of each entry on
the CPU reports them, finite and >= 0, and a program without the trace
module gives each reader None."""

import math
import sys

import pytest

from portbench import harness
from portbench.tests import _tiny

NEW = {
    "integrate": ["bdf.syncs_per_trip.sens", "bdf.host_ms_per_trip.sens",
                  "bdf.wait_ms_per_trip.sens"],
    "fit": ["bdf.syncs_per_trip.fit", "bdf.host_ms_per_trip.fit",
            "bdf.wait_ms_per_trip.fit", "lm.self_ms_per_iter.fit",
            "project.self_ms_per_eval.fit"],
}
TEN_K = ["bdf.syncs_per_trip.10k", "bdf.host_ms_per_trip.10k",
         "bdf.wait_ms_per_trip.10k"]


def _traced(kind, tmp_path):
    cell, cfg = _tiny.cell_and_config(kind, tmp_path)
    # the CPU profiler needs its CPU activity (the card's fit profiles
    # the device alone)
    cell["traffic"]["profile_host_ops"] = True
    return harness.run_cell(cell["name"], 2**40 + 11, 0.01, True,
                            device="cpu", cell=cell, cfg=cfg)


@pytest.mark.parametrize("kind", sorted(NEW))
def test_traced_run_reports_the_program_metrics(kind, tmp_path):
    from tpusysbio_torch import trace

    trace.reset()
    line = _traced(kind, tmp_path)
    assert line["correct"], line["checks"]
    for name in NEW[kind]:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    m = line["metrics"]
    # 5 reads a trip and one a Newton pass, at least one pass a trip
    assert m[NEW[kind][0]]["value"] > 6
    # and the earlier metrics the CPU can read beside them
    cell = _tiny.cell_and_config(kind, tmp_path)[0]["name"]
    source = {e["name"]: e["source"] for e in harness.benchmark()["per_layer"]}
    assert set(m) == {n for n in harness.cell_metrics(cell, "per_layer")
                      if source[n] != "device_trace"}


def test_ten_k_cell_lists_the_same_readers():
    names = harness.cell_metrics("mapk22-sens-10k", "per_layer")
    assert set(TEN_K) <= set(names)
    for a, b in zip(TEN_K, NEW["integrate"]):
        src_a = (harness.HERE / "metrics" / f"{a}.py").read_text()
        src_b = (harness.HERE / "metrics" / f"{b}.py").read_text()
        assert src_a.split('"""', 2)[2] == src_b.split('"""', 2)[2]


def test_readers_give_none_without_the_trace_module(monkeypatch):
    """The parent's program has no ``tpusysbio_torch.trace``."""
    import tpusysbio_torch

    monkeypatch.delattr(tpusysbio_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "tpusysbio_torch.trace", None)
    for names in NEW.values():
        for name in names:
            mod = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                      "metric")
            assert mod.read(None) is None, name


def test_readers_give_none_when_nothing_was_recorded():
    from tpusysbio_torch import trace

    trace.reset()
    for names in NEW.values():
        for name in names:
            mod = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                      "metric")
            assert mod.read(None) is None, name
