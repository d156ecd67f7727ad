"""The port's configuration and model layer against the JAX reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio_torch import SolverConfig, convert
from tpusysbio_torch.model import library

torch.set_num_threads(1)


def test_solver_config_fields_match_reference():
    ref = [(f.name, f.default) for f in dataclasses.fields(JSolverConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(SolverConfig)]
    assert got == ref


@pytest.mark.parametrize("kw", [dict(linear_solver="qr"),
                                dict(linear_solver="banded"),
                                dict(sens_precision="bf16"),
                                dict(dense_window=1)])
def test_solver_config_checks_match_reference(kw):
    with pytest.raises(ValueError):
        JSolverConfig(**kw)
    with pytest.raises(ValueError):
        SolverConfig(**kw)


@pytest.fixture(scope="module")
def states():
    """8 random (y, p) pairs around the MAPK-22 operating point."""
    rng = np.random.default_rng(0)
    y = rng.uniform(0.0, 1.2, size=(8, 22))
    y[0, :5] = 0.0   # exact zeros exercise 0^0 = 1 and the exclusive prod
    p = jlibrary.mapk_true_params()[None] * np.exp(
        rng.normal(scale=0.3, size=(8, 30)))
    S = rng.standard_normal((8, 22, 30))
    return y, p, S


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_mapk_rhs_jac_sens_match_reference(states):
    y, p, S = states
    jm = jlibrary.mapk_huang_ferrell()
    tm = library.mapk_huang_ferrell(device="cpu")
    t = jnp.zeros(())
    ref_f = jax.vmap(lambda yy, pp: jm.rhs(t, yy, pp))(y, p)
    ref_j = jax.vmap(lambda yy, pp: jm.rhs_jac(t, yy, pp))(y, p)
    ref_s = jax.vmap(lambda yy, ss, pp: jm.rhs_sens(t, yy, ss, pp))(y, S, p)
    tt = torch.zeros(8, dtype=torch.float64)
    yt, pt, St = map(torch.as_tensor, (y, p, S))
    assert _rel(tm.rhs(tt, yt, pt).numpy(), np.asarray(ref_f)) <= 1e-13
    assert _rel(tm.rhs_jac(tt, yt, pt).numpy(), np.asarray(ref_j)) <= 1e-13
    assert _rel(tm.rhs_sens(tt, yt, St, pt).numpy(),
                np.asarray(ref_s)) <= 1e-13


def test_mapk_jacobian_matches_forward_ad(states):
    """The closed-form Jacobian equals forward-mode AD of the RHS."""
    y, p, _ = states
    tm = library.mapk_huang_ferrell(device="cpu")
    yt, pt = torch.as_tensor(y), torch.as_tensor(p)
    tt = torch.zeros(8, dtype=torch.float64)
    ad = torch.func.vmap(torch.func.jacfwd(
        lambda yy, pp: tm.rhs(tt[:1], yy[None], pp[None])[0]))(yt, pt)
    assert _rel(tm.rhs_jac(tt, yt, pt).numpy(), ad.numpy()) <= 1e-13


def test_mapk_y0_and_true_params_match_reference():
    jm = jlibrary.mapk_huang_ferrell()
    tm = library.mapk_huang_ferrell(device="cpu")
    p = library.mapk_true_params(device="cpu")
    np.testing.assert_array_equal(p.numpy(), jlibrary.mapk_true_params())
    np.testing.assert_array_equal(tm.y0(p[None])[0].numpy(),
                                  np.asarray(jm.y0(jnp.asarray(p.numpy()))))
    assert tm.param_names == jm.param_names
    assert tm.state_names == jm.state_names
    s0 = tm.y0_sensitivity(p[None].repeat(2, 1))
    assert s0.shape == (2, 22, 30) and not bool(s0.any())


def test_network_from_numpy_matches_port_builder():
    jnet = jlibrary._mapk_network()
    net = convert.network_from_numpy(
        jnet.species, jnet.reaction_names, np.asarray(jnet.reactants),
        np.asarray(jnet.stoich), device="cpu")
    own = library._mapk_network(device="cpu")
    assert net.species == own.species
    assert net.reaction_names == own.reaction_names
    assert torch.equal(net.reactants, own.reactants)
    assert torch.equal(net.stoich, own.stoich)


def test_params_from_numpy():
    p = convert.params_from_numpy(jlibrary.mapk_true_params(), device="cpu")
    assert p.dtype == torch.float64 and p.shape == (30,)
    with pytest.raises(ValueError):
        convert.params_from_numpy(np.zeros((2, 3, 4)), device="cpu")


def test_backward_span_and_events_are_queued():
    """Both are ported since: a decreasing ``t_span`` integrates backward
    (``t_final`` at its end) and ``events`` fills the event buffers;
    together they raise ``ValueError``, as in the reference
    (tests/test_torch_backward.py and test_torch_events_rootfind.py hold
    them against the reference)."""
    from tpusysbio_torch.solvers import EventSpec

    lv = library.lotka_volterra(device="cpu")
    back = lv.simulate(np.asarray(library.LV_TRUE_PARAMS)[None], (1.0, 0.0),
                       [1.0, 0.0], device="cpu")
    assert int(back.status[0]) == 1 and float(back.t_final[0]) == 0.0
    tm = library.mapk_huang_ferrell(device="cpu")
    p = library.mapk_true_params(device="cpu")[None]
    ev = EventSpec(fn=lambda t, y: y[:, :1] - 1e9)
    res = tm.simulate(p, (0.0, 1.0), [1.0], events=ev, device="cpu")
    assert int(res.status[0]) == 1 and int(res.event_count[0, 0]) == 0
    with pytest.raises(ValueError, match="backward"):
        tm.simulate(p, (1.0, 0.0), [1.0, 0.0], events=ev, device="cpu")
