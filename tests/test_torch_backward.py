"""The port's backward integration (time reflection in ``OdeModel``)
against the JAX package's and SciPy (tests/test_backward.py's cases).

Tolerances: the backward run retraces the forward one to 1e-6 relative;
against SciPy's decreasing-``t_span`` BDF at rtol=1e-10 to 1e-6; the
backward trajectory and sensitivities against the JAX package's backward
run to 1e-9 relative, with the same step counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import EventSpec

torch.set_num_threads(1)

P_LV = np.asarray(jlibrary.LV_TRUE_PARAMS)[None]
Y_START = np.array([1.7, 0.4])


def _started(model, y):
    yt = torch.as_tensor(y)
    return dataclasses.replace(
        model, y0=lambda pp: yt.to(pp.dtype).expand(pp.shape[0], -1))


def test_backward_recovers_forward_trajectory():
    model = library.lotka_volterra(device="cpu")
    t_fwd = np.linspace(0.0, 15.0, 16)
    cfg = SolverConfig(rtol=1e-9, atol=1e-12, max_steps=4096)
    fwd = model.simulate(P_LV, (0.0, 15.0), t_fwd, config=cfg, device="cpu")
    back = _started(model, fwd.ys[0, -1].numpy()).simulate(
        P_LV, (15.0, 0.0), t_fwd[::-1].copy(), config=cfg, device="cpu")
    assert int(back.status[0]) == 1
    assert abs(float(back.t_final[0])) < 1e-9
    scale = fwd.ys.abs().max().item()
    err = (back.ys[0] - fwd.ys[0].flip(0)).abs().max().item()
    assert err / scale < 1e-6


def test_backward_vs_scipy():
    model = _started(library.lotka_volterra(device="cpu"), Y_START)
    t_back = np.linspace(10.0, 1.0, 10)
    res = model.simulate(P_LV, (10.0, 1.0), t_back,
                         config=SolverConfig(rtol=1e-8, atol=1e-11,
                                             max_steps=4096), device="cpu")
    assert int(res.status[0]) == 1
    jm = jlibrary.lotka_volterra()
    ref = solve_ivp(
        lambda t, y: np.asarray(jm.rhs(t, jnp.asarray(y),
                                       jnp.asarray(P_LV[0]))),
        (10.0, 1.0), Y_START, method="BDF", t_eval=t_back, rtol=1e-10,
        atol=1e-13)
    err = np.abs(res.ys[0].numpy() - ref.y.T).max() / np.abs(ref.y).max()
    assert err < 1e-6, err


@pytest.mark.parametrize("solver", ["bdf", "radau"])
def test_backward_sensitivities_match_reference(solver):
    t_back = np.linspace(10.0, 2.0, 5)
    cfg = dict(rtol=1e-9, atol=1e-12, max_steps=4096)
    jm = jlibrary.lotka_volterra()
    jmodel = dataclasses.replace(
        jm, y0=lambda pp: jnp.asarray(Y_START, pp.dtype))
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda pp: jmodel.simulate_sensitivities(
            pp, (10.0, 2.0), jnp.asarray(t_back), solver=solver,
            config=JSolverConfig(**cfg)))(jnp.asarray(P_LV[0])))
    model = _started(library.lotka_volterra(device="cpu"), Y_START)
    got = model.simulate_sensitivities(P_LV, (10.0, 2.0), t_back,
                                       solver=solver,
                                       config=SolverConfig(**cfg),
                                       device="cpu")
    assert int(got.status[0]) == 1
    assert int(got.nsteps[0]) == int(ref.nsteps)
    assert abs(float(got.t_final[0]) - float(ref.t_final)) < 1e-12
    for key in ("ys", "sens"):
        a, b = getattr(got, key)[0].numpy(), getattr(ref, key)
        assert np.abs(a - b).max() / np.abs(b).max() <= 1e-9, key


def test_backward_rejects_events_and_dense():
    model = library.lotka_volterra(device="cpu")
    t_back = np.linspace(5.0, 1.0, 4)
    with pytest.raises(ValueError, match="backward"):
        model.simulate(P_LV, (5.0, 1.0), t_back, dense_output=True,
                       device="cpu")
    with pytest.raises(ValueError, match="backward"):
        model.simulate(P_LV, (5.0, 1.0), t_back, device="cpu",
                       events=EventSpec(fn=lambda t, y: y[:, :1] - 1.0))
    with pytest.raises(ValueError, match="backward"):
        model.simulate_sensitivities(P_LV, (5.0, 1.0), t_back,
                                     dense_output=True, device="cpu")
