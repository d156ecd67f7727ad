"""The port's Rosenbrock stepper (ode23s) against the JAX package's.

Inputs are numpy arrays from a seed; the JAX side is
``jax.jit(jax.vmap(rosenbrock_solve))``, the port's side one batched call
on the CPU, where ``linear_solver='pallas'`` runs the kernels' plain
twins and the JAX package's Pallas kernels run in interpret mode.

Tolerances: in f64 the step counters are equal member by member, ``ys``
agrees to 1e-9 and ``sens`` to 1e-9 relative to their largest value; the
golden MM-3 bound is tests/test_solvers.py's (5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import solvers as jsolvers
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.sens import make_sens_rhs as jmake_sens_rhs
from tpusysbio_torch import SolverConfig, trace
from tpusysbio_torch.model import library
from tpusysbio_torch.sens import make_sens_rhs
from tpusysbio_torch.solvers import STATUS_DONE, rosenbrock_solve

torch.set_num_threads(1)

COUNTERS = ("status", "nsteps", "naccepted", "nrejected", "nfev", "njev",
            "nlu")


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _params(p_true, batch, scale, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(p_true)[None] * np.exp(
        rng.normal(scale=scale, size=(batch, len(p_true))))


def _assert_counters_equal(got, ref):
    for c in COUNTERS:
        np.testing.assert_array_equal(getattr(got, c).numpy(),
                                      np.asarray(getattr(ref, c)), err_msg=c)


@pytest.fixture(scope="module")
def mm3():
    """MM-3 at B=2 with its four jvp sensitivity columns, f64, 'inv'."""
    ps = _params(jlibrary.MM_TRUE_PARAMS, 2, 0.2)
    t_eval = np.linspace(0.0, 10.0, 11)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=2048)
    jm = jlibrary.michaelis_menten()

    def one(p):
        return jsolvers.rosenbrock_solve(
            lambda t, y: jm.rhs(t, y, p), (0.0, 10.0), jm.y0(p),
            jnp.asarray(t_eval), config=JSolverConfig(**kw),
            sens_rhs=jmake_sens_rhs(jm.rhs, p), s0=jnp.zeros((3, 4)))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ps)))
    tm = library.michaelis_menten(device="cpu")
    p = torch.as_tensor(ps)
    got = rosenbrock_solve(
        lambda t, y: tm.rhs(t, y, p), (0.0, 10.0), tm.y0(p),
        torch.as_tensor(t_eval), config=SolverConfig(**kw),
        sens_rhs=make_sens_rhs(tm.rhs, p),
        s0=torch.zeros((2, 3, 4), dtype=torch.float64))
    return got, ref


def test_mm3_counters_equal(mm3):
    got, ref = mm3
    _assert_counters_equal(got, ref)
    assert got.status.tolist() == [STATUS_DONE] * 2
    # fixed work per attempt: one Jacobian and one factorization
    np.testing.assert_array_equal(got.nlu.numpy(), got.nsteps.numpy())


def test_mm3_trajectories_and_sensitivities_agree(mm3):
    got, ref = mm3
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9
    assert _rel(got.sens.numpy(), ref.sens) <= 1e-9
    assert _rel(got.y_final.numpy(), ref.y_final) <= 1e-9
    np.testing.assert_allclose(got.t_final.numpy(), ref.t_final, rtol=0,
                               atol=0)


def test_mapk22_pallas_matches_reference():
    """MAPK-22 over [0, 5] at B=2 with all 30 sensitivity columns under
    ``'pallas'`` in f64: the factorization is the lazy f32 inverse plus
    the matrix, the state column the fused refined solve's plain twin."""
    ps = _params(jlibrary.mapk_true_params(), 2, 0.1)
    t_eval = np.linspace(0.0, 5.0, 6)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=1024, linear_solver="pallas")
    jm = jlibrary.mapk_huang_ferrell()

    def one(p):
        return jsolvers.rosenbrock_solve(
            lambda t, y: jm.rhs(t, y, p.astype(y.dtype)), (0.0, 5.0),
            jm.y0(p), jnp.asarray(t_eval), config=JSolverConfig(**kw),
            sens_rhs=lambda t, y, S: jm.rhs_sens(t, y, S, p),
            s0=jnp.zeros((22, 30)),
            jac=lambda t, y: jm.rhs_jac(t, y, p.astype(y.dtype)))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ps)))
    trace.reset()
    got = library.mapk_huang_ferrell(device="cpu").simulate_sensitivities(
        ps, (0.0, 5.0), t_eval, solver="rosenbrock",
        config=SolverConfig(**kw), device="cpu")
    assert sum(v for k, v in trace.counters().items()
               if k.startswith("gpu_lu.")) == 0
    _assert_counters_equal(got, ref)
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9
    assert _rel(got.sens.numpy(), ref.sens) <= 1e-9


def test_time_dependent_rhs_matches_reference():
    """y' = -k y + sin(t): the jvp in t gives the non-autonomous term."""
    ks = np.array([1.0, 30.0])
    t_eval = np.linspace(0.0, 6.0, 7)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=2048)

    def one(k):
        return jsolvers.rosenbrock_solve(
            lambda t, y: -k * y + jnp.sin(t), (0.0, 6.0), jnp.ones(1),
            jnp.asarray(t_eval), config=JSolverConfig(**kw))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ks)))
    k = torch.as_tensor(ks)[:, None]
    got = rosenbrock_solve(
        lambda t, y: -k * y + torch.sin(t)[:, None], (0.0, 6.0),
        torch.ones((2, 1), dtype=torch.float64), torch.as_tensor(t_eval),
        config=SolverConfig(**kw))
    _assert_counters_equal(got, ref)
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9


def test_golden_mm3(golden):
    """tests/test_solvers.py's MM-3 bound for Rosenbrock."""
    g = golden("mm3")
    res = library.michaelis_menten(device="cpu").simulate(
        g["p"][None], tuple(g["t_span"]), g["t_eval"], solver="rosenbrock",
        config=SolverConfig(rtol=1e-6, atol=1e-9), device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    ys = res.ys[0].numpy()
    assert np.max(np.abs(ys - g["ys"]) / (1e-7 + np.abs(g["ys"]))) < 5e-3
