"""The port's spans and counters (``tpusysbio_torch/trace.py``): nothing
recorded with recording off, the same bits with it on, the span tree, the
shared clock with ``torch.profiler``, and the stepper's host reads against
a hand count."""

import bisect
import collections
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpusysbio_torch import FitConfig, SolverConfig, cli, trace
from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
from tpusysbio_torch.model import library
from tpusysbio_torch.optim import lm_fit
from tpusysbio_torch.project import ParameterMap, Project

torch.set_num_threads(1)

# MAPK-22 as the benchmark integrates it, over a short horizon: 2 members
# with all 30 sensitivities, f32 columns, the Newton kernels' CPU twins
MAPK_CFG = SolverConfig(rtol=1e-6, atol=1e-9, linear_solver="pallas",
                        sens_precision="f32")


def _integrate():
    model = library.mapk_huang_ferrell(device="cpu")
    p = library.mapk_true_params(device="cpu")[None].repeat(2, 1)
    p = p * torch.tensor([[1.0], [1.1]], dtype=p.dtype)
    return model.simulate_sensitivities(p, (0.0, 5.0), np.linspace(0, 5, 6),
                                        config=MAPK_CFG, device="cpu")


def _fit_problem():
    """MM-3's synthetic problem as a ``Project``, and 3 starts."""
    args = SimpleNamespace(model="mm3", t_end=4.0, n_times=5, seed=0,
                           noise=0.02)
    model, batch, pmap, _, theta_true = cli._synth_problem(args, "cpu")
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-6, atol=1e-9))
    starts = theta_true[None] + torch.tensor([[0.2], [-0.3], [0.4]],
                                             dtype=theta_true.dtype)
    return proj, starts


def _fit(proj, starts):
    """Three lockstep LM iterations."""
    return lm_fit(proj.residuals, proj.residuals_and_jacobian, starts,
                  FitConfig(max_iter=3, eval_mode="lockstep"))


@pytest.fixture(scope="module")
def integration():
    """The integration with recording off, then on: results, counters and
    spans of each."""
    out = {}
    for mode in ("off", "on"):
        trace.reset()
        with trace.recording() if mode == "on" else contextlib.nullcontext():
            res = _integrate()
        out[mode] = (res, trace.counters(), trace.spans())
    return out


def _names(spans):
    return collections.Counter(s.name for s in spans)


def test_recording_off_records_no_span(integration):
    res, counts, spans = integration["off"]
    assert spans == []
    assert counts["bdf.trips"] > 0 and counts["bdf.reads"] > 0
    trace.reset()
    with trace.span("outside"):
        assert trace.read(torch.tensor(True), "demo.reads")
    assert trace.spans() == [] and trace.counters() == {"demo.reads": 1}


def test_integration_is_bit_identical_with_recording_on(integration):
    off, on = integration["off"][0], integration["on"][0]
    for field in off._fields:
        a, b = getattr(off, field), getattr(on, field)
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b), field
    assert integration["off"][1] == integration["on"][1]


def test_lockstep_fit_is_bit_identical_with_recording_on():
    proj, starts = _fit_problem()
    trace.reset()
    off = _fit(proj, starts)
    n_off = trace.counters()
    trace.reset()
    with trace.recording():
        on = _fit(proj, starts)
    spans = trace.spans()
    for field in ("theta", "cost", "grad_norm", "status", "n_iter",
                  "cost_trace"):
        assert torch.equal(getattr(off, field), getattr(on, field)), field
    assert trace.counters() == n_off
    # one lm.iter a pass of the loop, and its reads: one a pass plus the
    # check that ends the loop
    names = _names(spans)
    iters = int(on.n_iter.max())
    assert names["lm.init"] == 1 and names["lm.iter"] == iters
    assert names["lm.read"] == n_off["lm.reads"] == iters + 1
    # each evaluation sits under lm.init or an lm.iter, each stepper call
    # directly under its evaluation
    for s in spans:
        if s.name == "project.evaluate":
            assert spans[s.parent].name in ("lm.init", "lm.iter")
        if s.name == "bdf.solve":
            assert spans[s.parent].name == "project.evaluate"
        if s.name == "project.observe":
            assert spans[s.parent].name == "project.evaluate"
    assert names["project.evaluate"] == names["bdf.solve"] == iters + 1


def test_segments_hold_one_stepper_call_each():
    """A timed input splits the integration into two segments: each
    ``project.segment`` under the evaluation holds one ``bdf.solve``."""
    model = library.michaelis_menten(device="cpu")
    names = list(model.param_names)
    t = np.array([1.0, 2.0, 3.0])
    meas = (Measurement(obs_index=0, times=t, values=np.zeros(3),
                        sigmas=np.ones(3)),)
    batch = ExperimentBatch.from_experiments(
        [Experiment("pulse", meas, inputs=((1.5, "k1", 0.0),))],
        param_names=names, device="cpu")
    pmap = ParameterMap.create(names, 1, shared=tuple(names), device="cpu")
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-6, atol=1e-9))
    theta = torch.log(torch.as_tensor(library.MM_TRUE_PARAMS))[None]
    trace.reset()
    with trace.recording():
        proj.residuals_and_jacobian(theta.repeat(2, 1))
    spans = trace.spans()
    # the stepper's phases and the AD derivatives inside them aside
    top = [(i, s.name) for i, s in enumerate(spans)
           if not s.name.startswith(("bdf.", "ad."))
           or s.name == "bdf.solve"]
    assert [n for _, n in top] == [
        "project.evaluate", "project.segment", "bdf.solve",
        "project.segment", "bdf.solve", "project.observe"]
    (ev, _), (s1, _), (b1, _), (s2, _), (b2, _), (ob, _) = top
    assert [spans[i].parent for i in (s1, s2, ob)] == [ev] * 3
    assert (spans[b1].parent, spans[b2].parent) == (s1, s2)
    assert {s.root for s in spans} == {ev}


def test_span_tree_and_self_time():
    trace.reset()
    with trace.recording():
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    pass
            trace.read(torch.tensor(False), "x.reads")
        with trace.span("d"):
            pass
    spans = trace.spans()
    assert [s.name for s in spans] == ["a", "b", "c", "x.read", "d"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert [s.root for s in spans] == [0, 0, 0, 0, 4]
    for s in spans:
        assert s.start_ns <= s.end_ns
    for i, s in enumerate(spans):
        kids = [c for c in spans if c.parent == i]
        for c in kids:
            assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
        assert trace.self_ns(spans, i) == (
            s.end_ns - s.start_ns
            - sum(c.end_ns - c.start_ns for c in kids))
    assert trace.self_ns(spans, 2) == spans[2].end_ns - spans[2].start_ns
    assert trace.counters() == {"x.reads": 1}
    events = trace.chrome_events(spans, base_ns=spans[0].start_ns, first=1)
    assert [e["name"] for e in events] == ["b", "c", "x.read", "d"]
    assert events[0]["ts"] == (spans[1].start_ns - spans[0].start_ns) / 1e3
    assert {e["ph"] for e in events} == {"X"}


def test_spans_record_inside_a_profiler_session_on_its_clock():
    """Each operation the profiler saw during a program span lies inside
    that span on the profiler's clock; no span emits a profiler event."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            x = torch.ones(64, dtype=torch.float64) + 1.0
            with trace.span("inner"):
                y = torch.cumprod(x, 0)
        z = y * 2.0
    assert float(z[0]) == 4.0
    spans = {s.name: s for s in trace.spans()}
    assert set(spans) == {"outer", "inner"}
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    names = {n for n, _, _ in events}
    assert not names & {"outer", "inner"}

    def inside(name, span):
        hits = [(s, e) for n, s, e in events if n == name]
        assert hits, name
        return all(span.start_ns <= s <= e <= span.end_ns for s, e in hits)

    assert inside("aten::ones", spans["outer"])
    assert inside("aten::add", spans["outer"])
    assert inside("aten::cumprod", spans["inner"])
    assert not inside("aten::mul", spans["outer"])


def test_stepper_under_the_profiler_lines_up_with_its_operations():
    """A traced integration under ``torch.profiler``: every top-level
    operation that starts inside a trip ends inside it, and each Newton
    pass's right-hand side holds operations."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _integrate()
    spans = trace.spans()
    trips = [s for s in spans if s.name == "bdf.trip"]
    assert trips and len(trips) == trace.counters()["bdf.trips"]
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("aten::"))
    starts = [s for s, _ in ops]
    for trip in trips:
        lo = bisect.bisect_left(starts, trip.start_ns)
        hi = bisect.bisect_right(starts, trip.end_ns)
        assert hi > lo
        assert all(e <= trip.end_ns for _, e in ops[lo:hi])
    for rhs in (s for s in spans if s.name == "bdf.rhs"):
        lo = bisect.bisect_left(starts, rhs.start_ns)
        assert lo < len(starts) and starts[lo] <= rhs.end_ns


def test_stepper_reads_equal_the_hand_count(integration):
    """5 host reads a trip (rescale, factorization, the Newton loop's
    last check, the Jacobian refresh, the trip loop's check), one more a
    Newton pass, and the trip loop's first check."""
    _, counts, spans = integration["on"]
    names = _names(spans)
    trips, passes = counts["bdf.trips"], names["bdf.rhs"]
    assert names["bdf.trip"] == trips and names["bdf.lsolve"] == passes
    assert passes >= trips
    assert counts["bdf.reads"] == 5 * trips + passes + 1
    assert names["bdf.read"] == counts["bdf.reads"]
    assert names["bdf.solve"] == 1


def test_trip_phases_nest_and_cover_the_trip(integration):
    _, _, spans = integration["on"]
    phases = {"bdf.predict", "bdf.factor", "bdf.newton", "bdf.jac",
              "bdf.control", "bdf.dense", "bdf.read"}
    solve = next(i for i, s in enumerate(spans) if s.name == "bdf.solve")
    for i, s in enumerate(spans):
        parent = spans[s.parent].name if s.parent >= 0 else None
        if s.name == "bdf.trip":
            assert s.parent == solve
        elif s.name in ("bdf.rhs", "bdf.lsolve"):
            assert parent == "bdf.newton"
        elif s.name in phases - {"bdf.read"}:
            assert parent == "bdf.trip"
        elif s.name == "bdf.read":
            assert parent in phases | {"bdf.trip", "bdf.solve"}
        assert s.root == solve
    kids = collections.defaultdict(set)
    for s in spans:
        if s.parent >= 0 and spans[s.parent].name == "bdf.trip":
            kids[s.parent].add(s.name)
    assert all(k >= phases for k in kids.values())
