"""The port's priors (``project/priors.py``) against the JAX reference's.

``Priors.create`` validates as the reference does; ``rows`` gives the
reference's residual and Jacobian rows for a batch of θ (the reference's
spec carried across with ``convert.priors_from_reference``); and on the
Michaelis-Menten problem of ``tests/test_priors.py`` with relative data in
one scale group, a prior on the scale factor adds the row
``log(B)/σ`` and raises the cost, in both packages alike. Every input is
made with numpy (seed 0) and handed to both.

Tolerances: prior rows 1e-14 relative (the same closed forms); the
``Project`` with priors, residuals 1e-7 relative and Jacobian 1e-6 (the
tight solver, f64 columns).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import data as jdata
from tpusysbio import project as jproject
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio_torch import SolverConfig, convert
from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
from tpusysbio_torch.model import library
from tpusysbio_torch.project import ParameterMap, Priors, Project

torch.set_num_threads(1)

CFG = dict(rtol=1e-8, atol=1e-10)
N_T = 8


@functools.lru_cache(maxsize=None)
def _data():
    """MM-3 observed at 8 times from the reference's rtol=1e-10
    simulation, with seed-0 noise, in relative units (× 2.5)."""
    model = jlibrary.michaelis_menten()
    t = np.linspace(1.0, 10.0, N_T)
    res = model.simulate(jnp.asarray(jlibrary.MM_TRUE_PARAMS), (0.0, 10.0),
                         jnp.asarray(t),
                         config=JSolverConfig(rtol=1e-10, atol=1e-12))
    rng = np.random.default_rng(0)
    return t, (np.asarray(res.ys) + rng.normal(scale=0.02, size=(N_T, 3))) \
        * 2.5


def _problem(pkg, priors_kw=None):
    """(project, batch, pmap, θ_true) in one package; ``priors_kw`` =
    ``{"params": ..., "scales": ...}`` adds priors."""
    jax_side = pkg == "jax"
    t, data = _data()
    meas_cls, exp_cls = ((jdata.Measurement, jdata.Experiment) if jax_side
                         else (Measurement, Experiment))
    meas = tuple(meas_cls(obs_index=i, times=t, values=data[:, i],
                          sigmas=np.full(N_T, 0.02), scale_group="u")
                 for i in range(3))
    if jax_side:
        model = jlibrary.michaelis_menten()
        batch = jdata.ExperimentBatch.from_experiments(
            [exp_cls("e0", meas)])
        pmap = jproject.ParameterMap.create(model.param_names, 1,
                                            shared=model.param_names)
    else:
        model = library.michaelis_menten(device="cpu")
        batch = ExperimentBatch.from_experiments([exp_cls("e0", meas)],
                                                 device="cpu")
        pmap = ParameterMap.create(model.param_names, 1,
                                   shared=model.param_names, device="cpu")
    priors = None
    if priors_kw is not None:
        priors = (jproject.Priors.create(pmap, batch, **priors_kw)
                  if jax_side else
                  Priors.create(pmap, batch, device="cpu", **priors_kw))
    cls = jproject.Project if jax_side else Project
    cfg = (JSolverConfig if jax_side else SolverConfig)(**CFG)
    proj = cls(model=model, pmap=pmap, batch=batch, config=cfg,
               priors=priors)
    theta = np.asarray(pmap.pack(dict(zip(
        model.param_names, jlibrary.MM_TRUE_PARAMS.tolist()))))
    return proj, batch, pmap, theta


PRIORS = {"params": {"k1": (8.0, 0.5), "E0": (0.4, 0.2)},
          "scales": {"u": (2.0, 0.3)}}


def test_create_validation():
    _, batch, pmap, _ = _problem("port")
    with pytest.raises(KeyError):
        Priors.create(pmap, batch, params={"nope": (1.0, 0.1)},
                      device="cpu")
    with pytest.raises(ValueError):
        Priors.create(pmap, batch, params={"k1": (-1.0, 0.1)},
                      device="cpu")
    with pytest.raises(ValueError):
        Priors.create(pmap, batch, params={"k1": (1.0, 0.0)},
                      device="cpu")
    with pytest.raises(KeyError):
        Priors.create(pmap, batch, scales={"nope": (1.0, 0.1)},
                      device="cpu")
    with pytest.raises(ValueError):
        Priors.create(pmap, None, scales={"u": (1.0, 0.1)}, device="cpu")
    with pytest.raises(ValueError):
        Priors.create(pmap, batch, scales={"u": (0.0, 0.1)}, device="cpu")


@pytest.mark.parametrize("kw", [
    {"params": {"k1": (8.0, 0.5)}}, {"scales": {"u": (2.0, 0.3)}}, PRIORS,
    {}], ids=["params", "scales", "both", "none"])
def test_create_and_rows_match_reference(kw):
    _, jbatch, jpmap, _ = _problem("jax")
    _, batch, pmap, _ = _problem("port")
    ref = jproject.Priors.create(jpmap, jbatch, **kw)
    got = Priors.create(pmap, batch, device="cpu", **kw)
    carried = convert.priors_from_reference(
        {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
         for f in dataclasses.fields(ref) for v in [getattr(ref, f.name)]},
        device="cpu")
    assert got.n_rows == carried.n_rows == ref.n_rows
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(carried, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(ref, f.name)))
        else:
            assert a == b == getattr(ref, f.name), f.name

    rng = np.random.default_rng(0)
    theta = rng.normal(size=(3, pmap.n_global))
    B = np.exp(rng.normal(size=(3, 1)))
    B[2, 0] = 0.0          # a degenerate scale factor saturates, no NaN
    dB = rng.normal(size=(3, 1, pmap.n_global))
    r, J = got.rows(torch.as_tensor(theta), torch.as_tensor(B),
                    torch.as_tensor(dB))
    r_only, none = got.rows(torch.as_tensor(theta), torch.as_tensor(B))
    assert none is None and torch.equal(r, r_only)
    assert tuple(r.shape) == (3, ref.n_rows)
    assert tuple(J.shape) == (3, ref.n_rows, pmap.n_global)
    assert bool(torch.isfinite(r).all() and torch.isfinite(J).all())
    for i in range(3):
        rr, Jr = ref.rows(jnp.asarray(theta[i]), jnp.asarray(B[i]),
                          jnp.asarray(dB[i]))
        np.testing.assert_allclose(r[i].numpy(), np.asarray(rr),
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(J[i].numpy(), np.asarray(Jr),
                                   rtol=1e-14, atol=0)


@functools.lru_cache(maxsize=None)
def _evaluated():
    jproj, _, _, theta = _problem("jax", PRIORS)
    proj, _, _, _ = _problem("port", PRIORS)
    thetas = theta[None] + np.random.default_rng(0).uniform(
        -0.2, 0.2, (2, theta.shape[0]))
    thetas[0] = theta
    ref = jax.jit(jax.vmap(lambda th: jproj.evaluate(th, with_jac=True)))(
        jnp.asarray(thetas))
    return (proj, thetas, jax.tree.map(np.asarray, ref),
            proj.evaluate(torch.as_tensor(thetas), with_jac=True))


def test_project_with_priors_matches_reference():
    """The prior rows follow the measurement rows in ``r`` and ``J``; the
    scale prior's Jacobian row carries dB/dθ."""
    proj, _, ref, got = _evaluated()
    assert proj.n_residuals == 3 * N_T + 4 + 1
    r, rr = got.residuals.numpy(), ref.residuals
    assert r.shape == rr.shape == (2, proj.n_residuals)
    assert np.max(np.abs(r - rr)) / np.max(np.abs(rr)) <= 1e-7
    J, Jr = got.jacobian.numpy(), ref.jacobian
    assert np.max(np.abs(J - Jr)) / np.max(np.abs(Jr)) <= 1e-6
    np.testing.assert_allclose(got.cost.numpy(), ref.cost, rtol=1e-7)
    np.testing.assert_allclose(got.scale.numpy(), ref.scale, rtol=1e-7)


def test_scale_prior_shifts_fitted_scale():
    """The analytic B recovers the data's units (2.5); a prior on it at
    median 1 adds the row log(B)/0.05 and raises the cost at truth, as in
    the reference."""
    proj0, batch, pmap, theta = _problem("port")
    ev_free = proj0.evaluate(torch.as_tensor(theta))
    B_free = float(ev_free.scale[0])
    assert abs(B_free - 2.5) < 0.1
    priors = Priors.create(pmap, batch, scales={"u": (1.0, 0.05)},
                           device="cpu")
    proj = dataclasses.replace(proj0, priors=priors)
    r = proj.residuals(torch.as_tensor(theta))
    np.testing.assert_allclose(float(r[-1]), np.log(B_free) / 0.05,
                               rtol=1e-10)
    assert float(proj.cost(torch.as_tensor(theta))) > float(ev_free.cost)
    jproj, _, _, _ = _problem("jax", {"scales": {"u": (1.0, 0.05)}})
    np.testing.assert_allclose(float(proj.cost(torch.as_tensor(theta))),
                               float(jproj.cost(jnp.asarray(theta))),
                               rtol=1e-7)
