"""The cell ``jakstat-fit`` at a size the CPU runs in well under a minute:
its entry through the harness's own driver code is correct, the bf16
control and two planted faults of the multi-experiment Jacobian are not,
and a traced run reports the AD and scale-factor metrics, whose readers
give None where the program records nothing."""

import math
import sys

import pytest
import torch

from portbench import harness

NEW = ["ad.ms_per_trip.jakstat", "ad.jvps_per_trip.jakstat",
       "project.scale_ms_per_eval.jakstat"]


def tiny_cell():
    """4 starts in theta_true +- 0.5, 8 screen iterations (fewer leave
    the polished starts of so few far out along k2, where the polish
    keeps its start and a faulty step cannot show), the best 2
    polished, in the cell's fits a unit."""
    cell = harness.load_cell("jakstat-fit")
    cell["traffic"].update(starts=4, box=0.5, top_k=2, screen_iters=8,
                           check_polished=2, warmup_max_steps=4)
    return cell


def run(traced=False, control=None):
    return harness.run_cell("jakstat-fit", 2**41 + 7, 0.01, traced,
                            device="cpu", cell=tiny_cell(), control=control)


def test_tiny_cell_is_correct():
    line = run()
    assert line["correct"], line["checks"]
    # one unit of the cell's fits, each of its own 4 starts
    fits = tiny_cell()["traffic"]["fits_per_unit"]
    assert fits > 1
    assert line["attempted"] == 4 * fits and line["failed"] == 0
    assert set(line["metrics"]) == {"starts_per_min", "setup_s"}
    assert set(line["checks"]) == {"top_k_miss", "step_err", "polish_err"}


def test_bf16_control_is_not_correct():
    line = run(control="bf16")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["no_dB", "amp_swapped"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    """``no_dB``: the scale factors' gradient left out of the Jacobian
    (which the gradient ``J^T r`` does not see at the optimal scale
    factors, the step does); ``amp_swapped``: dose 2's ``amp`` column of
    the chain ``dp/dtheta`` swapped with dose 1's."""
    from tpusysbio_torch.project import mapping, residuals

    if fault == "no_dB":
        real = residuals._scale_factors_and_grad

        def with_grad(*args, **kwargs):
            B, dB = real(*args, **kwargs)
            return B, torch.zeros_like(dB)

        monkeypatch.setattr(residuals, "_scale_factors_and_grad",
                            with_grad)
    else:
        real = mapping.ParameterMap.chain

        def chain(self, theta):
            return real(self, theta)[..., [0, 1, 2, 3, 5, 4]]

        monkeypatch.setattr(mapping.ParameterMap, "chain", chain)
    line = run()
    step = line["checks"]["step_err"]
    assert not line["correct"] and step["value"] > step["limit"], \
        line["checks"]


def test_traced_run_reports_the_new_metrics():
    from tpusysbio_torch import trace

    trace.reset()
    cell = tiny_cell()
    # the CPU profiler needs its CPU activity, which slows a unit: a
    # shorter screen keeps the run short
    cell["traffic"].update(profile_host_ops=True, screen_iters=2)
    line = harness.run_cell("jakstat-fit", 2**41 + 9, 0.01, True,
                            device="cpu", cell=cell)
    assert line["correct"], line["checks"]
    m = line["metrics"]
    for name in NEW:
        assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
    # the 6 columns once a Newton pass, at least one pass a trip
    assert m["ad.jvps_per_trip.jakstat"]["value"] >= 6
    assert "setup_s" not in m


def _readers():
    return [harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                "metric") for name in NEW]


def test_readers_give_none_without_the_trace_module(monkeypatch):
    import tpusysbio_torch

    monkeypatch.delattr(tpusysbio_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "tpusysbio_torch.trace", None)
    for mod in _readers():
        assert mod.read(None) is None


def test_readers_give_none_where_the_program_records_nothing():
    """A program without these spans and counter (the parent of the
    change that added them) records trips, evaluations and nothing
    else."""
    from tpusysbio_torch import trace

    trace.reset()
    trace.count("bdf.trips", 3)
    with trace.recording():
        with trace.span("project.evaluate"):
            with trace.span("bdf.trip"):
                pass
    try:
        for mod in _readers():
            assert mod.read(None) is None
    finally:
        trace.reset()
