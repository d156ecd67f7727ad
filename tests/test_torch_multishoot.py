"""The port's multiple shooting against the JAX package's and the serial
integration (tests/test_multishoot.py's cases).

Lotka–Volterra at rtol=1e-8; the windows are the stepper's members.
Tolerances: window ends against the serial run 1e-6 relative (plus 1e-9
absolute); ``init_z`` and the defects against the JAX package's 1e-9
relative to the state scale; the defect Jacobians (parameters and window
states) against the JAX package's 1e-7 relative to their largest entry;
defects at the tight serial states below 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.solvers import multishoot as jmultishoot
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import STATUS_DONE, bdf_solve
from tpusysbio_torch.solvers.multishoot import (
    ShootingProblem,
    integrate_windows,
    window_grid,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-11)
P_LV = np.asarray(jlibrary.LV_TRUE_PARAMS)


def _port_problem(K, t_end):
    model = library.lotka_volterra(device="cpu")
    return model, ShootingProblem(model.rhs, (0.0, t_end), model.y0,
                                  n_windows=K, n_params=model.n_params,
                                  config=SolverConfig(**TOL))


@functools.lru_cache(maxsize=None)
def _reference(K, t_end):
    """The JAX problem's init_z and defects_and_jac at it (numpy)."""
    model = jlibrary.lotka_volterra()
    prob = jmultishoot.ShootingProblem(
        model.rhs, (0.0, t_end), model.y0, n_windows=K,
        n_params=model.n_params, config=JSolverConfig(**TOL))
    p = jnp.asarray(P_LV)
    z = jax.jit(prob.init_z)(p)
    out = jax.jit(prob.defects_and_jac)(p, z[1:])
    return np.asarray(z), tuple(np.asarray(a) for a in out)


def test_windows_match_serial_integration():
    model, _ = _port_problem(4, 8.0)
    p = torch.as_tensor(P_LV)
    y0 = model.y0(p[None])
    bounds = window_grid((0.0, 8.0), 4, device="cpu")
    f1 = lambda t, y: model.rhs(t, y, p[None])  # noqa: E731
    ref = bdf_solve(f1, (0.0, 8.0), y0, bounds[1:],
                    config=SolverConfig(**TOL)).ys[0]
    z = torch.cat([y0, ref[:-1]], dim=0)
    pk = p[None].expand(4, -1)
    y_end, S_end, status = integrate_windows(
        lambda t, y: model.rhs(t, y, pk), bounds, z,
        config=SolverConfig(**TOL))
    assert status.tolist() == [STATUS_DONE] * 4
    assert S_end.shape == (4, 2, 0)
    np.testing.assert_allclose(y_end.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_init_z_and_defects_match_reference():
    _, prob = _port_problem(4, 8.0)
    z_ref, (d_ref, _, _, status_ref) = _reference(4, 8.0)
    p = torch.as_tensor(P_LV)
    z = prob.init_z(p)
    scale = np.max(np.abs(z_ref))
    assert np.max(np.abs(z.numpy() - z_ref)) / scale <= 1e-9
    defects, _, _, status = prob.defects_and_jac(p, torch.as_tensor(z_ref[1:]))
    np.testing.assert_array_equal(status.numpy(), status_ref)
    assert np.max(np.abs(defects.numpy() - d_ref)) / scale <= 1e-9
    # init_z is a coarse pass: small but nonzero defects
    assert float(defects.abs().max()) < 0.05


def test_defects_vanish_at_serial_states():
    model, prob = _port_problem(4, 8.0)
    p = torch.as_tensor(P_LV)
    bounds = window_grid((0.0, 8.0), 4, device="cpu")
    ref = bdf_solve(lambda t, y: model.rhs(t, y, p[None]), (0.0, 8.0),
                    model.y0(p[None]), bounds[1:-1],
                    config=SolverConfig(**TOL))
    defects, _, _, status = prob.defects_and_jac(p, ref.ys[0])
    assert status.tolist() == [STATUS_DONE] * 4
    assert float(defects.abs().max()) < 1e-5


@pytest.mark.parametrize("block", ["dD_dp", "Jz"])
def test_defect_jacobians_match_reference(block):
    _, prob = _port_problem(3, 6.0)
    z_ref, (_, dp_ref, jz_ref, _) = _reference(3, 6.0)
    _, dD_dp, Jz, _ = prob.defects_and_jac(torch.as_tensor(P_LV),
                                           torch.as_tensor(z_ref[1:]))
    got, ref = {"dD_dp": (dD_dp, dp_ref), "Jz": (Jz, jz_ref)}[block]
    assert got.shape == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref)) <= 1e-7
