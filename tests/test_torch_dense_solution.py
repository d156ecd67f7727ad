"""The port's post-hoc continuous solution (``OdeSolution``) against the
JAX package's and SciPy (tests/test_dense_solution.py's cases, batched).

``OdeModel.simulate(..., dense_output=True)`` on Lotka–Volterra at three
parameter vectors (numpy, the reference's ×1, ×1.1, ×0.9). Tolerances:
``sol(t_eval)`` equals ``ys`` to 1e-12 relative (the same polynomial),
the t0 point to 1e-5; each member's ``sol`` at 37 off-grid times against
the JAX package's ``OdeSolution`` of that member to 1e-10 relative; off
the grid against SciPy's BDF at rtol=1e-10 to 1e-6; the sensitivity
columns against ``sens`` at the grid to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.solvers import OdeSolution as JOdeSolution
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import OdeSolution

torch.set_num_threads(1)

P_LV = np.asarray(jlibrary.LV_TRUE_PARAMS)
PS = np.stack([P_LV, P_LV * 1.1, P_LV * 0.9])


def _model():
    return library.lotka_volterra(device="cpu")


def test_solution_matches_t_eval_grid():
    t_eval = np.linspace(0.0, 15.0, 31)
    res = _model().simulate(PS, (0.0, 15.0), t_eval,
                            config=SolverConfig(rtol=1e-6, atol=1e-9,
                                                max_steps=2048),
                            dense_output=True, device="cpu")
    assert res.status.tolist() == [1, 1, 1]
    sol = OdeSolution(res)
    got, ys = sol(t_eval).numpy(), res.ys.numpy()
    scale = np.abs(ys).max()
    np.testing.assert_allclose(got[:, 1:], ys[:, 1:], rtol=0,
                               atol=1e-12 * scale)
    assert np.abs(got[:, 0] - ys[:, 0]).max() < 1e-5 * scale
    np.testing.assert_allclose(sol.t_max.numpy(), [15.0] * 3)
    assert sol(7.5).shape == (3, 2)


def test_members_match_reference_solution():
    """Each member's continuous solution against the JAX package's
    ``OdeSolution`` of the same member of a vmapped run."""
    t_eval = np.linspace(0.0, 10.0, 11)
    cfg = dict(rtol=1e-6, atol=1e-9, max_steps=2048)
    jm = jlibrary.lotka_volterra()
    batched = jax.jit(jax.vmap(lambda pp: jm.simulate(
        pp, (0.0, 10.0), jnp.asarray(t_eval), config=JSolverConfig(**cfg),
        dense_output=True)))(jnp.asarray(PS))
    res = _model().simulate(PS, (0.0, 10.0), t_eval,
                            config=SolverConfig(**cfg), dense_output=True,
                            device="cpu")
    np.testing.assert_array_equal(res.naccepted.numpy(),
                                  np.asarray(batched.naccepted))
    ts = np.linspace(0.3, 9.7, 37)
    got = OdeSolution(res)(ts).numpy()
    for i in range(3):
        ref = JOdeSolution(jax.tree.map(lambda a: a[i], batched))(ts)
        assert np.abs(got[i] - ref).max() / np.abs(ref).max() <= 1e-10


def test_offgrid_vs_scipy():
    t_eval = np.linspace(0.0, 15.0, 8)
    res = _model().simulate(PS[:1], (0.0, 15.0), t_eval,
                            config=SolverConfig(rtol=1e-8, atol=1e-11,
                                                max_steps=4096),
                            dense_output=True, device="cpu")
    sol = OdeSolution(res)
    ts = np.sort(np.random.default_rng(0).uniform(0.01, 14.99, 100))
    jm = jlibrary.lotka_volterra()
    ref = solve_ivp(
        lambda t, y: np.asarray(jm.rhs(t, jnp.asarray(y),
                                       jnp.asarray(P_LV))),
        (0.0, 15.0), np.asarray(jm.y0(jnp.asarray(P_LV))), method="BDF",
        t_eval=ts, rtol=1e-10, atol=1e-13)
    err = np.abs(sol(ts)[0].numpy() - ref.y.T).max() / np.abs(ref.y).max()
    assert err < 1e-6, err


def test_solution_sensitivities():
    t_eval = np.linspace(0.0, 10.0, 21)
    res = _model().simulate_sensitivities(
        PS[:2], (0.0, 10.0), t_eval,
        config=SolverConfig(rtol=1e-8, atol=1e-11, max_steps=4096),
        dense_output=True, device="cpu")
    sol = OdeSolution(res)
    got, grid = sol.sens(t_eval).numpy(), res.sens.numpy()
    scale = np.abs(grid).max()
    np.testing.assert_allclose(got[:, 1:], grid[:, 1:], rtol=0,
                               atol=1e-10 * scale)


def test_dense_output_requires_bdf_and_export():
    model = _model()
    t_eval = np.linspace(0.0, 1.0, 3)
    with pytest.raises(ValueError, match="bdf"):
        model.simulate(PS[:1], (0.0, 1.0), t_eval, solver="dopri5",
                       dense_output=True, device="cpu")
    res = model.simulate(PS[:1], (0.0, 1.0), t_eval,
                         config=SolverConfig(max_steps=256), device="cpu")
    with pytest.raises(ValueError, match="dense-export"):
        OdeSolution(res)
