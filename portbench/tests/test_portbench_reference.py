"""The plain reference: its frozen networks are the program's, it agrees
with the program on the CPU at a tiny size, it imports nothing of the
program, and the stored fit data are what it makes."""

import ast
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference.data import make_fit_data
from portbench.reference.network import Network
from portbench.reference.solve import residual_job, sens_solve

CONFIGS = ["mapk22"]


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_network_is_the_libraries(name):
    from tpusysbio_torch.model import library

    cfg = harness.load_config(name)
    port = cfg["port_model"]
    model = getattr(library, port["factory"])(**port["kwargs"],
                                              device="cpu")
    net = Network(cfg["network"])
    assert tuple(net.species) == model.state_names
    assert tuple(net.reaction_names) == model.param_names
    # the right-hand side at a random state: stoichiometry and rate laws
    rng = np.random.default_rng(0)
    y = rng.uniform(0.1, 1.0, net.n)
    k = rng.uniform(0.5, 2.0, net.m)
    f_port = model.rhs(torch.zeros(1, dtype=torch.float64),
                       torch.as_tensor(y[None]), torch.as_tensor(k[None]))
    np.testing.assert_allclose(net.rhs(y, k), f_port[0].numpy(),
                               rtol=1e-12, atol=1e-14)
    J_port = model.rhs_jac(torch.zeros(1, dtype=torch.float64),
                           torch.as_tensor(y[None]),
                           torch.as_tensor(k[None]))
    np.testing.assert_allclose(net.jac(y, k), J_port[0].numpy(),
                               rtol=1e-12, atol=1e-14)
    true = library.mapk_true_params(device="cpu").numpy()
    np.testing.assert_array_equal(net.rates, true)
    y0 = model.y0(torch.as_tensor(true[None]))[0].numpy()
    np.testing.assert_array_equal(net.y0, y0)
    obs = model.observables(torch.as_tensor(y[None]),
                            torch.as_tensor(k[None]))[0].numpy()
    np.testing.assert_array_equal(net.observables(y), obs)
    assert cfg["n_species"] == net.n and cfg["n_rate_constants"] == net.m


def test_second_derivatives_match_differences():
    cfg = harness.load_config("mapk22")
    net = Network(cfg["network"])
    y = np.random.default_rng(1).uniform(0.1, 1.0, net.n)
    h = 1e-6
    eye = np.eye(net.n)
    fd = np.stack([(net.dmono(y + h * eye[l]) - net.dmono(y - h * eye[l]))
                   / (2 * h) for l in range(net.n)], axis=-1)
    np.testing.assert_allclose(net.d2mono(y), fd, atol=1e-8)


def test_reference_agrees_with_the_port_on_mapk22():
    """Two members, a short horizon, all 30 sensitivities."""
    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.model import library

    cfg = harness.load_config("mapk22")
    net = Network(cfg["network"])
    model = library.mapk_huang_ferrell(device="cpu")
    rng = np.random.default_rng(2)
    ps = net.rates[None] * np.exp(0.1 * rng.normal(size=(2, net.m)))
    t = np.linspace(0.0, 5.0, 6)
    res = model.simulate_sensitivities(
        ps, (0.0, 5.0), t, config=SolverConfig(rtol=1e-9, atol=1e-12),
        device="cpu")
    for b in range(2):
        ys, sens = sens_solve(net, ps[b], (0.0, 5.0), t)
        np.testing.assert_allclose(res.ys[b].numpy(), ys, rtol=1e-6,
                                   atol=1e-12)
        scale = np.abs(sens).max()
        assert np.abs(res.sens[b].numpy() - sens).max() < 1e-6 * scale


def test_reference_residuals_agree_with_the_port_on_mapk22():
    """One parameter set of the MAPK fit, its first two measurement
    times: residuals and the Jacobian in theta."""
    from tpusysbio_torch import SolverConfig
    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.model import library
    from tpusysbio_torch.project import ParameterMap, Project

    cfg = harness.load_config("mapk22")
    data = harness.load_json(harness.HERE / "data" / cfg["fit"]["data"])
    data = dict(data, times=data["times"][:2], values=data["values"][:2])
    t = np.asarray(data["times"])
    values = np.asarray(data["values"])
    model = library.mapk_huang_ferrell(device="cpu")
    meas = tuple(Measurement(obs_index=i, times=t, values=values[:, i],
                             sigmas=np.full(len(t), data["sigma"]))
                 for i in range(values.shape[1]))
    batch = ExperimentBatch.from_experiments([Experiment("e", meas)],
                                             device="cpu")
    names = list(model.param_names)
    rates = dict(zip(names, cfg["network"]["rates"]))
    free = cfg["fit"]["free"]
    pmap = ParameterMap.create(names, 1, shared=tuple(free),
                               fixed={n: v for n, v in rates.items()
                                      if n not in free}, device="cpu")
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-9, atol=1e-12))
    theta = np.log([rates[n] for n in free]) + 0.05
    ev = proj.evaluate(torch.as_tensor(theta[None]), with_jac=True)
    r, J = residual_job(cfg["network"], free, data, theta, True)
    np.testing.assert_allclose(ev.residuals[0].numpy(), r, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(ev.jacobian[0].numpy() - J).max() < 1e-5 * np.abs(J).max()


@pytest.mark.parametrize("name", CONFIGS)
def test_stored_fit_data_match_the_reference(name):
    cfg = harness.load_config(name)
    stored = harness.load_json(harness.HERE / "data" / cfg["fit"]["data"])
    made = make_fit_data(cfg)
    assert stored["times"] == made["times"]
    assert stored["observables"] == made["observables"]
    np.testing.assert_allclose(stored["values"], made["values"], rtol=1e-8,
                               atol=1e-12)
    assert stored["sigma"] == pytest.approx(made["sigma"], rel=1e-9)


def test_bf16_columns_differ_from_f64_by_rounding():
    cfg = harness.load_config("mapk22")
    net = Network(cfg["network"])
    t = np.linspace(0.0, 2.0, 3)
    _, s64 = sens_solve(net, net.rates, (0.0, 2.0), t)
    _, s16 = sens_solve(net, net.rates, (0.0, 2.0), t,
                        sens_dtype="bfloat16")
    gap = np.abs(s16 - s64).max() / np.abs(s64).max()
    assert 1e-4 < gap < 5e-2


def test_lm_step_gaps():
    """No step gives away the model's whole reduction, a reversed step
    four times it; the LM step solves the damped normal equations."""
    from portbench.reference import lm

    rng = np.random.default_rng(3)
    J, r = rng.normal(size=(9, 4)), rng.normal(size=9)
    step = lm.lm_step(r, J, 1e-3)
    M = lm.damped(J, 1e-3)
    np.testing.assert_allclose(M @ step, -(J.T @ r), rtol=1e-10)
    assert lm.step_gap(step, step, M) == 0.0
    assert lm.step_gap(np.zeros(4), step, M) == pytest.approx(1.0)
    assert lm.step_gap(-step, step, M) == pytest.approx(2.0)
    # a linear residual realises the model's reduction, and the damping's
    # small share on top
    c0 = lm.cost(r)
    c1 = lm.cost(r + J @ step)
    assert 1.0 <= lm.kept_gap(c0, c1, step, M) < 1.01
    assert lm.kept_gap(c0, c0 + 1.0, step, M) == 0.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((harness.HERE / "reference").glob("*.py")):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("tpusysbio_torch", "tpusysbio", "jax",
                               "jaxlib", "flax"), (path.name, mod)


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in sorted(harness.HERE.rglob("*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("tpusysbio", "jax", "jaxlib",
                                             "flax"), (path.name, mod)


def test_configs_state_their_frozen_sizes():
    for name in CONFIGS:
        cfg = harness.load_config(name)
        assert json.dumps(cfg["published"])
        assert cfg["published"]["n_species"] == cfg["n_species"]
