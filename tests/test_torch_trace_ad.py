"""The spans and counters of the forward-mode AD derivatives and of the
pooled scale factors (``tpusysbio_torch/trace.py``): where they nest, the
jvp count against a hand count from the stepper's own counters, and a
mass-action model, whose derivatives are closed-form, recording none."""

import numpy as np
import pytest
import torch

from tpusysbio_torch import SolverConfig, trace
from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
from tpusysbio_torch.model import library
from tpusysbio_torch.project import ParameterMap, Project

torch.set_num_threads(1)


def _ancestors(spans, i):
    names = []
    j = spans[i].parent
    while j >= 0:
        names.append(spans[j].name)
        j = spans[j].parent
    return names


@pytest.fixture(scope="module")
def jakstat_run():
    """One JAK-STAT member with its 6 sensitivities over (0, 20) at rtol
    1e-3, where Newton fails twice on a stale Jacobian: the result, the
    counters and the spans."""
    model = library.jak_stat(device="cpu")
    p = torch.as_tensor(library.JAKSTAT_TRUE_PARAMS)[None]
    trace.reset()
    with trace.recording():
        res = model.simulate_sensitivities(
            p, (0.0, 20.0), np.linspace(0.0, 20.0, 5),
            config=SolverConfig(rtol=1e-3, atol=1e-6), device="cpu")
    return res, trace.counters(), trace.spans()


def test_ad_spans_nest_in_the_stepper_phases(jakstat_run):
    res, _, spans = jakstat_run
    jac_parents, sens_parents = [], []
    for i, s in enumerate(spans):
        up = _ancestors(spans, i)
        if s.name in ("ad.jac", "ad.sens"):
            assert "bdf.solve" in up
            if "bdf.trip" in up:
                (jac_parents if s.name == "ad.jac"
                 else sens_parents).append(spans[s.parent].name)
    # the first Jacobian and right-hand side are the stepper's set-up;
    # every later one is a trip's refresh or Newton pass
    assert jac_parents and set(jac_parents) == {"bdf.jac"}
    assert len(jac_parents) == int(res.njev[0]) - 1
    assert sens_parents and set(sens_parents) == {"bdf.rhs"}
    assert sum(s.name == "bdf.rhs" for s in spans) == len(sens_parents)


def test_ad_jvps_match_a_hand_count(jakstat_run):
    """n = 4 jvps a Jacobian (``njev`` counts the first), m = 6 a call of
    the sensitivity RHS: the initial one and one a Newton iteration
    (``nfev`` less the two evaluations of the initial step's choice)."""
    res, counts, spans = jakstat_run
    njev, nfev = int(res.njev[0]), int(res.nfev[0])
    assert njev > 1
    assert counts["ad.jvps"] == 4 * njev + 6 * (nfev - 2)
    assert sum(s.name == "ad.jac" for s in spans) == njev
    assert sum(s.name == "ad.sens" for s in spans) == nfev - 2


def test_project_scale_nests_in_project_evaluate():
    """A two-dose JAK-STAT ``Project`` with two scale groups, with and
    without its Jacobian: one ``project.scale`` an evaluation."""
    model = library.jak_stat(device="cpu")
    t = np.linspace(2.0, 10.0, 3)
    exps = [Experiment(f"dose_{e}", tuple(
        Measurement(obs_index=i, times=t, values=np.full(len(t), 1.0 + i),
                    sigmas=np.full(len(t), 0.1), scale_group=g)
        for i, g in enumerate(("pstat", "tstat")))) for e in range(2)]
    batch = ExperimentBatch.from_experiments(exps, device="cpu")
    pmap = ParameterMap.create(model.param_names, 2,
                               shared=("k1", "k2", "k3", "k4"),
                               local=("amp",), fixed={"tau": 6.0},
                               device="cpu")
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-4, atol=1e-7))
    theta = pmap.pack({"k1": 2.5, "k2": 4.0, "k3": 0.3, "k4": 0.6,
                       "amp": [1.0, 0.4]})[None].repeat(2, 1)
    trace.reset()
    with trace.recording():
        proj.evaluate(theta, with_jac=True)
        proj.evaluate(theta, with_jac=False)
    spans = trace.spans()
    scale = [i for i, s in enumerate(spans) if s.name == "project.scale"]
    assert len(scale) == 2
    for i in scale:
        assert spans[spans[i].parent].name == "project.evaluate"
    assert sum(s.name == "project.evaluate" for s in spans) == 2


def test_mass_action_records_no_ad_span():
    """MAPK-22 with all 30 sensitivities on the CPU's twin of the
    mass-action kernel: closed-form derivatives, no jvp."""
    model = library.mapk_huang_ferrell(device="cpu")
    p = library.mapk_true_params(device="cpu")[None]
    trace.reset()
    with trace.recording():
        model.simulate_sensitivities(
            p, (0.0, 2.0), np.linspace(0.0, 2.0, 3),
            config=SolverConfig(rtol=1e-6, atol=1e-9,
                                linear_solver="pallas",
                                sens_precision="f32"), device="cpu")
    spans = trace.spans()
    assert any(s.name == "bdf.trip" for s in spans)
    assert not [s.name for s in spans if s.name.startswith("ad.")]
    assert trace.counters().get("ad.jvps", 0) == 0
