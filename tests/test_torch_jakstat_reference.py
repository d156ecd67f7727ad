"""The benchmark's plain JAK-STAT reference (``portbench/reference/
jakstat.py``: PyTorch float64 with hand-written derivatives, SciPy's BDF)
against the port: the library model's right-hand side, derivatives and
observables, a two-dose ``Project``'s residuals, Jacobian and pooled scale
factors, and the stored fit data."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.entries.fit_ensemble import ensemble_problem
from portbench.reference import jakstat as ref
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import library
from tpusysbio_torch.project.scale_factors import scale_factors_and_grad
from tpusysbio_torch.solvers.common import batched_jacobian

torch.set_num_threads(1)

CFG = harness.load_config("jakstat")
SPEC = CFG["ensemble"]
DATA = harness.load_json(harness.HERE / "data" / SPEC["data"])


def test_model_matches_the_library_model():
    """Seeded random states, parameters and times: the right-hand side,
    the state Jacobian and ``df/dp`` (the port's by forward-mode AD) and
    the observables."""
    model = library.jak_stat(device="cpu")
    g = torch.Generator().manual_seed(7)
    B = 5
    y = torch.rand((B, 4), generator=g, dtype=torch.float64)
    p = 0.2 + 5.0 * torch.rand((B, 6), generator=g, dtype=torch.float64)
    t = 60.0 * torch.rand((B,), generator=g, dtype=torch.float64)
    f = model.rhs(t, y, p)
    jy = batched_jacobian(lambda yy: model.rhs(t, yy, p), y)
    jp = batched_jacobian(lambda pp: model.rhs(t, y, pp), p)
    obs = model.observables(y, p)
    for b in range(B):
        args = (t[b], y[b], p[b])
        torch.testing.assert_close(f[b], ref.rhs(*args), rtol=1e-13,
                                   atol=1e-14)
        torch.testing.assert_close(jy[b], ref.jac(*args), rtol=1e-13,
                                   atol=1e-14)
        torch.testing.assert_close(jp[b], ref.dfdp(*args), rtol=1e-13,
                                   atol=1e-14)
    torch.testing.assert_close(obs, ref.observables(y), rtol=1e-15,
                               atol=0.0)
    sizes = (model.n_states, model.n_params, model.n_obs)
    assert (CFG["n_states"], CFG["n_params"], CFG["n_observables"]) == sizes
    pub = CFG["published"]
    assert (pub["n_states"], pub["n_observables"]) == sizes[::2]
    assert pub["states"] == list(model.state_names)
    assert pub["rate_constants"] == list(model.param_names[:4])


def test_coupling_is_the_derivative_of_the_sensitivity_rhs():
    """The hand-written coupling term of SciPy's Jacobian against central
    differences of ``(df/dy) S + (df/dp) C`` in the state."""
    g = torch.Generator().manual_seed(3)
    t = torch.tensor(4.0, dtype=torch.float64)
    y = torch.rand(4, generator=g, dtype=torch.float64)
    p = torch.tensor(library.JAKSTAT_TRUE_PARAMS)
    S = torch.rand((4, 6), generator=g, dtype=torch.float64)
    C = torch.rand((6, 6), generator=g, dtype=torch.float64)
    got = ref._coupling(t, y, p, S, C)
    h = 1e-6
    for l in range(4):
        e = torch.zeros(4, dtype=torch.float64)
        e[l] = h
        up = ref.jac(t, y + e, p) @ S + ref.dfdp(t, y + e, p) @ C
        dn = ref.jac(t, y - e, p) @ S + ref.dfdp(t, y - e, p) @ C
        torch.testing.assert_close(got[:, :, l], (up - dn) / (2 * h),
                                   rtol=1e-7, atol=1e-8)


@pytest.fixture(scope="module")
def three_starts():
    """The configuration's two-dose ``Project`` at rtol 1e-8, evaluated
    with its Jacobian at three starts around theta_true, beside the
    reference at each."""
    ctx = harness.Context(dict(name="jakstat-fit", traffic={}), CFG, 0,
                          "cpu")
    proj, theta_true = ensemble_problem(ctx, "tight")
    proj = dataclasses.replace(proj, config=SolverConfig(rtol=1e-8,
                                                         atol=1e-11))
    rng = np.random.default_rng(11)
    thetas = theta_true.numpy()[None] + rng.uniform(-0.4, 0.4, (3, 6))
    theta = torch.as_tensor(thetas)
    ev = proj.evaluate(theta, with_jac=True)
    sim, dsim, _, _ = proj._gathered(theta, True)
    b = proj.batch
    R = b.n_residuals
    _, dB = scale_factors_and_grad(
        sim.reshape(3, R), dsim.reshape(3, R, 6), b.values.reshape(R),
        1.0 / b.sigmas.reshape(R) ** 2, b.group.reshape(R),
        b.mask.reshape(R), b.n_groups)
    refs = [ref.evaluate(SPEC, DATA, th, True) for th in thetas]
    return ev, dB, refs


def test_residuals_and_jacobian_agree_with_the_port(three_starts):
    ev, _, refs = three_starts
    for i, out in enumerate(refs):
        np.testing.assert_allclose(ev.residuals[i].numpy(), out["r"],
                                   rtol=1e-5, atol=1e-6)
        J = ev.jacobian[i].numpy()
        assert np.abs(J - out["J"]).max() < 1e-5 * np.abs(out["J"]).max()


def test_scale_factors_and_their_gradient_agree_with_the_port(three_starts):
    ev, dB, refs = three_starts
    for i, out in enumerate(refs):
        np.testing.assert_allclose(ev.scale[i].numpy(), out["B"],
                                   rtol=1e-6)
        assert (np.abs(dB[i].numpy() - out["dB"]).max()
                < 1e-5 * np.abs(out["dB"]).max())


def test_stored_fit_data_match_the_reference():
    made = ref.make_fit_data(SPEC)
    assert made["times"] == DATA["times"]
    assert made["experiments"] == DATA["experiments"]
    assert made["scale_groups"] == DATA["scale_groups"]
    np.testing.assert_allclose(made["sigma"], DATA["sigma"], rtol=1e-15)
    np.testing.assert_allclose(made["values"], DATA["values"], rtol=1e-8)


def test_residual_job_gives_an_infinite_cost_where_integration_fails():
    """A trial point far out along k2 (e^300): SciPy cannot integrate
    it, and LM must reject it."""
    theta = ref.theta_true(SPEC)
    theta[1] = 300.0
    r, J = ref.residual_job(SPEC, DATA, theta, False)
    assert J is None and r.shape == (48,) and np.all(np.isinf(r))
    with pytest.raises(RuntimeError):
        ref.residual_job(SPEC, DATA, theta, True)
