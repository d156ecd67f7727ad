"""The port's objective assembly (``data``, ``project``) against the
reference's.

The headline problem is built by the reference exactly as
``bench/fits_bench.py::build_problem`` builds it (MAPK-22, 12 free rate
constants, 3 observables × 12 times, the tight solver configuration) and
carried across with ``tpusysbio_torch.convert``; the same numpy θ go
through both ``Project``s. The reference integrates with its Pallas kernels
in interpret mode, the port with its kernels' plain versions.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench.fits_bench import build_problem
from tpusysbio import data as jdata
from tpusysbio import project as jproject
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio_torch import SolverConfig, convert, utils
from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
from tpusysbio_torch.model import library
from tpusysbio_torch.project import (ParameterMap, Priors, Project,
                                     ProjectEval, scale_factors,
                                     scale_factors_and_grad)

torch.set_num_threads(1)

N_THETA = 3


def _fields(obj):
    """A reference dataclass as ``{field: numpy array or static value}``."""
    return {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


def _carry(jproj, **kw):
    return Project(
        model=library.mapk_huang_ferrell(device="cpu"),
        pmap=convert.pmap_from_reference(_fields(jproj.pmap), device="cpu"),
        batch=convert.batch_from_reference(_fields(jproj.batch),
                                           device="cpu"),
        config=SolverConfig(**dataclasses.asdict(jproj.config)), **kw)


@pytest.fixture(scope="module")
def headline():
    jproj, theta_true = build_problem()
    rng = np.random.default_rng(0)
    thetas = np.asarray(theta_true)[None] + rng.uniform(
        -0.5, 0.5, size=(N_THETA, jproj.n_theta))
    ev = jax.jit(jax.vmap(lambda th: jproj.evaluate(th, with_jac=True)))(
        jnp.asarray(thetas))
    return jproj, thetas, jax.tree.map(np.asarray, ev)


@pytest.fixture(scope="module")
def port_eval(headline):
    jproj, thetas, _ = headline
    proj = _carry(jproj)
    return proj, proj.evaluate(torch.as_tensor(thetas), with_jac=True)


def test_headline_shapes_and_sens_mode(headline, port_eval):
    jproj, _, _ = headline
    proj, ev = port_eval
    assert isinstance(ev, ProjectEval)
    assert proj.n_residuals == jproj.n_residuals == 36
    assert proj.n_theta == jproj.n_theta == 12
    assert proj._theta_sens and jproj._theta_sens
    assert tuple(ev.residuals.shape) == (N_THETA, 36)
    assert tuple(ev.jacobian.shape) == (N_THETA, 36, 12)
    assert tuple(ev.status.shape) == (N_THETA, 1)


def test_headline_residuals_and_status_agree(headline, port_eval):
    """f64 state column on both sides, the trajectory bound of
    ``tests/test_torch_bdf.py`` carried through the observables and 1/σ:
    1e-7 relative."""
    _, _, ref = headline
    _, ev = port_eval
    np.testing.assert_array_equal(ev.status.numpy(), ref.status)
    r, rr = ev.residuals.numpy(), ref.residuals
    assert np.max(np.abs(r - rr)) / np.max(np.abs(rr)) <= 1e-7
    np.testing.assert_allclose(ev.cost.numpy(), ref.cost, rtol=1e-7)
    np.testing.assert_array_equal(ev.nsteps.numpy(), ref.nsteps)


def test_headline_jacobian_agrees(headline, port_eval):
    """The sensitivity columns live in f32 on both sides: 1e-4 relative."""
    _, _, ref = headline
    _, ev = port_eval
    J, Jr = ev.jacobian.numpy(), ref.jacobian
    assert np.max(np.abs(J - Jr)) / np.max(np.abs(Jr)) <= 1e-4


def test_convenience_closures_and_single_theta(headline, port_eval):
    _, thetas, ref = headline
    proj, ev = port_eval
    th = torch.as_tensor(thetas)
    r = proj.residuals(th)
    np.testing.assert_allclose(r.numpy(), ev.residuals.numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(proj.cost(th[:1]).numpy(), ref.cost[:1],
                               rtol=1e-7)
    one = proj.evaluate(th[0])
    assert tuple(one.residuals.shape) == (36,) and one.jacobian is None
    assert one.cost.ndim == 0
    with pytest.raises(ValueError):
        proj.evaluate(th[:, :5])


def test_theta_mode_matches_params_mode(headline, port_eval):
    """Chain rule inside the integrator (12 columns) against chaining the
    30 parameter columns afterwards: same math, f32 sensitivity columns."""
    jproj, thetas, _ = headline
    _, ev = port_eval
    proj_p = _carry(jproj, sens_mode="params")
    assert not proj_p._theta_sens
    r_p, J_p = proj_p.residuals_and_jacobian(torch.as_tensor(thetas))
    np.testing.assert_array_equal(r_p.numpy(), ev.residuals.numpy())
    J = ev.jacobian.numpy()
    assert np.max(np.abs(J_p.numpy() - J)) / np.max(np.abs(J)) <= 1e-4


# --------------------------------------------------------------------------
# E > 1: padding, per-experiment grids, one scale group
# --------------------------------------------------------------------------

def _two_experiments(meas_cls, exp_cls):
    rng = np.random.default_rng(5)
    t_a = np.linspace(2.0, 20.0, 5)
    t_b = np.array([1.0, 4.0, 9.0])
    a = exp_cls("a", (
        meas_cls(obs_index=0, times=t_a, values=rng.uniform(0, 1e-3, 5),
                 sigmas=np.full(5, 1e-4)),
        meas_cls(obs_index=2, times=t_a[1:], values=rng.uniform(1, 3, 4),
                 sigmas=np.full(4, 0.1), scale_group="blot")))
    b = exp_cls("b", (
        meas_cls(obs_index=2, times=t_b, values=rng.uniform(1, 3, 3),
                 sigmas=np.full(3, 0.1), scale_group="blot"),
        meas_cls(obs_index=1, times=t_b[:2], values=rng.uniform(0, .5, 2),
                 sigmas=np.full(2, 0.05))), t0=0.5)
    return [a, b]


@pytest.fixture(scope="module")
def two_exp():
    jmodel = jlibrary.mapk_huang_ferrell()
    p_true = np.asarray(jlibrary.mapk_true_params())
    names = jmodel.param_names
    free = [n for n in names if n.startswith("KPase+KP")]
    fixed = {n: float(p_true[names.index(n)]) for n in names
             if n not in free and n != "E1+KKK.bind"}
    kw = dict(shared=tuple(free), local=("E1+KKK.bind",), fixed=fixed)
    cfg = dict(rtol=1e-6, atol=1e-9, max_steps=512, linear_solver="pallas",
               sens_precision="f32", dense_f32=True)
    jbatch = jdata.ExperimentBatch.from_experiments(
        _two_experiments(jdata.Measurement, jdata.Experiment))
    jpmap = jproject.ParameterMap.create(names, 2, **kw)
    jproj = jproject.Project(model=jmodel, pmap=jpmap, batch=jbatch,
                             config=JSolverConfig(**cfg))
    batch = ExperimentBatch.from_experiments(
        _two_experiments(Measurement, Experiment), device="cpu")
    pmap = ParameterMap.create(names, 2, device="cpu", **kw)
    proj = Project(model=library.mapk_huang_ferrell(device="cpu"),
                   pmap=pmap, batch=batch, config=SolverConfig(**cfg))
    rng = np.random.default_rng(1)
    theta0 = np.asarray(jpmap.pack(
        {**{n: p_true[names.index(n)] for n in free},
         "E1+KKK.bind": [1000.0, 600.0]}))
    thetas = theta0[None] + rng.uniform(-0.3, 0.3, (2, jproj.n_theta))
    ref = jax.jit(jax.vmap(lambda th: jproj.evaluate(th, with_jac=True)))(
        jnp.asarray(thetas))
    return (jproj, proj, thetas, jax.tree.map(np.asarray, ref),
            proj.evaluate(torch.as_tensor(thetas), with_jac=True))


def test_from_experiments_and_create_match_reference_fields(two_exp):
    jproj, proj, _, _, _ = two_exp
    for got, ref in ((proj.batch, jproj.batch), (proj.pmap, jproj.pmap)):
        rf = _fields(ref)
        for f in dataclasses.fields(got):
            v = getattr(got, f.name)
            if isinstance(v, torch.Tensor):
                np.testing.assert_array_equal(v.numpy(), rf[f.name],
                                              err_msg=f.name)
                assert v.numpy().dtype == rf[f.name].dtype, f.name
            else:
                assert v == rf[f.name], f.name
    assert proj.batch.n_groups == 1 and proj.batch.n_times == 6
    assert proj.pmap.theta_names == jproj.pmap.theta_names


def test_two_experiment_batch_agrees(two_exp):
    """Different grids and t0 per experiment (per-member ``t_span`` and
    ``t_eval`` in the flattened N·E batch), padded rows, and the
    scale-factor branch with its dB/dθ."""
    _, proj, _, ref, ev = two_exp
    np.testing.assert_array_equal(ev.status.numpy(), ref.status)
    assert ev.status.tolist() == [[1, 1], [1, 1]]
    r, rr = ev.residuals.numpy(), ref.residuals
    assert r.shape == rr.shape == (2, 2 * proj.batch.n_meas)
    assert np.max(np.abs(r - rr)) / np.max(np.abs(rr)) <= 1e-7
    np.testing.assert_allclose(ev.scale.numpy(), ref.scale, rtol=1e-7)
    J, Jr = ev.jacobian.numpy(), ref.jacobian
    assert np.max(np.abs(J - Jr)) / np.max(np.abs(Jr)) <= 1e-4
    pad = ~proj.batch.mask.reshape(-1).numpy()
    assert pad.any() and not r[:, pad].any() and not J[:, pad].any()


# --------------------------------------------------------------------------
# ParameterMap and scale factors on random arrays
# --------------------------------------------------------------------------

def _maps():
    names = ["a", "b", "c", "d", "e"]
    kw = dict(shared=("a",), local=("b",), fixed={"c": [1.0, 2.0, 3.0],
                                                  "e": 0.5},
              grouped={"d": ["wt", "mut", "wt"]})
    return (jproject.ParameterMap.create(names, 3, **kw),
            ParameterMap.create(names, 3, device="cpu", **kw))


def test_parameter_map_expand_chain_pack_match_reference():
    jpm, pm = _maps()
    assert pm.n_global == jpm.n_global == 6
    assert pm.theta_names == jpm.theta_names
    assert (pm.n_experiments, pm.n_model_params) == (3, 5)
    theta = np.random.default_rng(2).normal(size=(4, 6))
    p = pm.expand(torch.as_tensor(theta))
    c = pm.chain(torch.as_tensor(theta))
    assert tuple(p.shape) == (4, 3, 5) and tuple(c.shape) == (4, 3, 5, 6)
    for i in range(4):
        np.testing.assert_allclose(p[i].numpy(),
                                   np.asarray(jpm.expand(jnp.asarray(
                                       theta[i]))), rtol=1e-15)
        np.testing.assert_allclose(c[i].numpy(),
                                   np.asarray(jpm.chain(jnp.asarray(
                                       theta[i]))), rtol=1e-15)
    vals = {"a": 2.0, "b": [1.0, 2.0, 3.0], "d[wt]": 4.0, "d[mut]": 5.0}
    np.testing.assert_allclose(pm.pack(vals).numpy(),
                               np.asarray(jpm.pack(vals)), rtol=1e-15)
    with pytest.raises(KeyError):
        pm.pack({"a": 1.0})
    with pytest.raises(ValueError):
        ParameterMap.create(["a", "z"], 1, shared=("a",), device="cpu")


def test_scale_factors_match_reference():
    # the package re-exports a function under the module's name
    jsf = importlib.import_module("tpusysbio.project.scale_factors")

    rng = np.random.default_rng(3)
    N, R, G, n_groups = 3, 40, 4, 3
    sim = rng.uniform(0.1, 2.0, (N, R))
    dsim = rng.normal(size=(N, R, G))
    data = rng.uniform(0.1, 2.0, R)
    inv_var = rng.uniform(0.5, 2.0, R)
    group = rng.integers(-1, n_groups - 1, R).astype(np.int32)  # one empty
    mask = rng.uniform(size=R) > 0.2
    t = torch.as_tensor
    B = scale_factors(t(sim), t(data), t(inv_var), t(group), t(mask),
                      n_groups)
    B2, dB = scale_factors_and_grad(t(sim), t(dsim), t(data), t(inv_var),
                                    t(group), t(mask), n_groups)
    assert tuple(B.shape) == (N, n_groups)
    assert tuple(dB.shape) == (N, n_groups, G)
    np.testing.assert_array_equal(B.numpy(), B2.numpy())
    for i in range(N):
        rB, rdB = jsf.scale_factors_and_grad(
            jnp.asarray(sim[i]), jnp.asarray(dsim[i]), jnp.asarray(data),
            jnp.asarray(inv_var), jnp.asarray(group), jnp.asarray(mask),
            n_groups)
        np.testing.assert_allclose(B[i].numpy(), np.asarray(rB),
                                   rtol=1e-13)
        np.testing.assert_allclose(dB[i].numpy(), np.asarray(rdB),
                                   rtol=1e-12, atol=1e-13)
    assert float(B[0, n_groups - 1]) == 0.0   # the empty group


# --------------------------------------------------------------------------
# What is not ported raises
# --------------------------------------------------------------------------

def _unported_cases():
    t = np.array([1.0, 2.0])
    m = Measurement(obs_index=0, times=t, values=t, sigmas=t)
    ss = Measurement.at_steady_state(0, 1.0, 0.1)
    return {
        "steady_state": dict(exps=[Experiment("x", (m, ss))]),
        "inputs": dict(exps=[Experiment(
            "x", (m,), inputs=((1.5, "E1+KKK.bind", 0.0),))]),
        "input_states": dict(exps=[Experiment(
            "x", (m,), input_states=((1.5, "KKK", 0.0),))]),
        "preequilibrate": dict(exps=[Experiment("x", (m,),
                                                preequilibrate=True)]),
        "y0_overrides": dict(exps=[Experiment("x", (m,),
                                              y0_overrides={"KKK": 1.0})]),
        "priors": dict(exps=[Experiment("x", (m,))], priors={}),
        "experiment_mesh": dict(exps=[Experiment("x", (m,))],
                                experiment_mesh=utils.make_mesh(
                                    axis_name="experiments", device="cpu")),
    }


@pytest.mark.parametrize("feature", sorted(_unported_cases()))
def test_unported_features_raise(feature):
    """The batch is constructed as the reference constructs it. The
    ``Project`` takes every one of these features (timed inputs, state
    assignments, pre-equilibration, initial-value overrides, steady-state
    rows, priors and, since ROADMAP item 14, an experiment mesh), and
    tests/test_torch_events.py, test_torch_priors.py and
    test_torch_mesh.py hold them against the reference."""
    case = _unported_cases()[feature]
    model = library.mapk_huang_ferrell(device="cpu")
    batch = ExperimentBatch.from_experiments(
        case.pop("exps"), param_names=model.param_names,
        state_names=model.state_names, device="cpu")
    p_true = library.mapk_true_params(device="cpu").numpy()
    pmap = ParameterMap.create(
        model.param_names, 1, shared=(model.param_names[0],),
        fixed={n: float(v) for n, v in zip(model.param_names[1:],
                                           p_true[1:])}, device="cpu")
    if "priors" in case:
        case["priors"] = Priors.create(pmap, batch, params={
            model.param_names[0]: (1.0, 0.5)}, device="cpu")
    proj = Project(model=model, pmap=pmap, batch=batch, **case)
    extra = proj.priors.n_rows if proj.priors is not None else 0
    assert proj.n_residuals == batch.n_residuals + extra


def test_model_without_closed_form_sensitivities_raises():
    """Construction no longer raises for a model without the closed-form
    sensitivity RHS: its columns come from ``sens/forward.py`` (one jvp of
    the RHS per column) and give the closed form's Jacobian in both
    ``sens_mode``s."""
    full = library.mapk_huang_ferrell(device="cpu")
    bare = dataclasses.replace(full, rhs_sens=None, rhs_sens_dir=None)
    t = np.array([1.0, 2.0])
    batch = ExperimentBatch.from_experiments(
        [Experiment("x", (Measurement(0, t, t, t),))], device="cpu")
    p_true = library.mapk_true_params(device="cpu").numpy()
    pmap = ParameterMap.create(
        full.param_names, 1, shared=(full.param_names[0],),
        fixed={n: float(v) for n, v in zip(full.param_names[1:],
                                           p_true[1:])}, device="cpu")
    theta = pmap.pack({full.param_names[0]: p_true[0]})
    for mode in ("theta", "params"):
        want = Project(model=full, pmap=pmap, batch=batch, sens_mode=mode)
        got = Project(model=bare, pmap=pmap, batch=batch, sens_mode=mode)
        r0, J0 = want.residuals_and_jacobian(theta)
        r1, J1 = got.residuals_and_jacobian(theta)
        assert torch.equal(r0, r1), mode
        assert float((J1 - J0).abs().max()) <= 1e-10 * float(
            J0.abs().max()), mode


def test_batch_with_segments_matches_reference_fields():
    """Timed inputs, state assignments, pre-equilibration and overrides
    are packed into the reference's shapes."""
    def exps(meas_cls, exp_cls):
        t = np.array([1.0, 3.0, 6.0])
        m = meas_cls(obs_index=1, times=t, values=t, sigmas=t)
        return [
            exp_cls("a", (m,), inputs=((2.0, "k1", 0.0), (4.0, "k1", 2.0)),
                    input_states=((4.0, "s2", 1.0),), preequilibrate=True,
                    preeq_params={"k2": 0.0}, y0_overrides={"s1": 3.0}),
            exp_cls("b", (m, meas_cls.at_steady_state(0, 1.0, 0.1, "g")),
                    inputs=((0.0, "k2", 5.0),))]

    kw = dict(param_names=["k1", "k2"], state_names=["s1", "s2"])
    ref = _fields(jdata.ExperimentBatch.from_experiments(
        exps(jdata.Measurement, jdata.Experiment), **kw))
    got = ExperimentBatch.from_experiments(exps(Measurement, Experiment),
                                           device="cpu", **kw)
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(), ref[f.name],
                                          err_msg=f.name)
        else:
            assert v == ref[f.name], f.name
    assert got.n_segments == 3 and got.has_preeq and got.has_steady
    back = convert.batch_from_reference(ref, device="cpu")
    assert back.n_segments == 3 and torch.equal(back.seg_mask, got.seg_mask)
