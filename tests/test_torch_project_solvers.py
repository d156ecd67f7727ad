"""``Project(solver='radau' | 'rosenbrock')`` against the JAX package's
``Project`` with the same solver.

JAK-STAT with two experiments in one batch: a stimulus pulse as two timed
parameter clamps (amp → 1.3 at t=2, → 0 at t=10; three segments, each one
stepper call over the batch with per-member ends) and an experiment
without inputs (its padded segments have zero length). θ mode, 5 of 6
constants free, evaluated with the Jacobian at two θ (numpy, seed 0);
residuals against zero data with σ = 1. Tolerances: statuses and step
counts equal member by member, residuals 1e-8 relative to their largest,
Jacobian 1e-6.
"""

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
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
from tpusysbio_torch.model import library
from tpusysbio_torch.project import ParameterMap, Project
from tpusysbio_torch.solvers import STATUS_DONE

torch.set_num_threads(1)

PULSE = ((2.0, "amp", 1.3), (10.0, "amp", 0.0))
JAK_T = np.linspace(1.0, 16.0, 9)
TRUTH = {"k1": 2.5, "k2": 4.0, "k3": 0.3, "k4": 0.6, "tau": 6.0}


def _problem(solver, jax_side):
    meas, exp = ((jdata.Measurement, jdata.Experiment) if jax_side
                 else (Measurement, Experiment))
    model = jlibrary.jak_stat() if jax_side else library.jak_stat(
        device="cpu")

    def zero(t):
        return tuple(meas(obs_index=i, times=t, values=np.zeros(len(t)),
                          sigmas=np.ones(len(t))) for i in (0, 1))

    exps = [exp("pulse", zero(JAK_T), inputs=PULSE),
            exp("basal", zero(JAK_T))]
    dev = {} if jax_side else dict(device="cpu")
    names = dict(param_names=model.param_names,
                 state_names=model.state_names)
    batch = (jdata.ExperimentBatch if jax_side else ExperimentBatch) \
        .from_experiments(exps, **names, **dev)
    pmap = (jproject.ParameterMap if jax_side else ParameterMap).create(
        model.param_names, len(exps), shared=tuple(TRUTH),
        fixed={"amp": [0.0, 0.0]}, **dev)
    cfg = dict(rtol=1e-6, atol=1e-9, max_steps=4096)
    if jax_side:
        proj = jproject.Project(model=model, pmap=pmap, batch=batch,
                                config=JSolverConfig(**cfg), solver=solver)
    else:
        proj = Project(model=model, pmap=pmap, batch=batch,
                       config=SolverConfig(**cfg), solver=solver)
    theta = np.asarray(pmap.pack(TRUTH))
    rng = np.random.default_rng(0)
    return proj, np.stack([theta,
                           theta + rng.uniform(-0.2, 0.2, theta.shape)])


@functools.lru_cache(maxsize=None)
def _evaluated(solver):
    jproj, thetas = _problem(solver, True)
    ref = jax.jit(jax.vmap(lambda th: jproj.evaluate(th, with_jac=True)))(
        jnp.asarray(thetas))
    proj, _ = _problem(solver, False)
    got = proj.evaluate(torch.as_tensor(thetas), with_jac=True)
    return proj, jax.tree.map(np.asarray, ref), got


@pytest.mark.parametrize("solver", ["radau", "rosenbrock"])
def test_status_and_steps_equal(solver):
    _, ref, got = _evaluated(solver)
    np.testing.assert_array_equal(got.status.numpy(), ref.status)
    assert (ref.status == STATUS_DONE).all()
    np.testing.assert_array_equal(got.nsteps.numpy(), ref.nsteps)


@pytest.mark.parametrize("solver", ["radau", "rosenbrock"])
def test_residuals_and_jacobian_agree(solver):
    proj, ref, got = _evaluated(solver)
    r, rr = got.residuals.numpy(), ref.residuals
    assert r.shape == rr.shape == (2, proj.n_residuals)
    assert np.max(np.abs(r - rr)) / np.max(np.abs(rr)) <= 1e-8
    J, Jr = got.jacobian.numpy(), ref.jacobian
    assert J.shape == Jr.shape == (2, proj.n_residuals, proj.n_theta)
    assert np.max(np.abs(J - Jr)) / np.max(np.abs(Jr)) <= 1e-6
