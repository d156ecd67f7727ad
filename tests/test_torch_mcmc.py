"""The port's ensemble MCMC (emcee-style stretch move) against the
reference's.

A ``torch.Generator`` cannot reproduce JAX's threefry stream, so the chain
itself is compared through the explicit-draws sweep: fed the reference's
own draws (split from one key as ``tpusysbio/fit/mcmc.py`` splits it), it
gives the reference's chain. Everything else is held as the reference's
tests hold it (tests/test_mcmc.py): analytic moments of a linear-Gaussian
posterior, determinism, thinning, the bounded-support rejection and the
argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.fit import mcmc as jmcmc
from tpusysbio_torch.fit import MCMCResult, autocorr_time, ensemble_sample
from tpusysbio_torch.fit.mcmc import _sweep

torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
A = _RNG.normal(size=(12, 3))
THETA = np.array([1.0, -0.5, 2.0])
B = A @ THETA
COV = np.linalg.inv(A.T @ A)
AT, BT = torch.as_tensor(A), torch.as_tensor(B)


def logp(th):
    """(W/2, 3) -> (W/2,): the linear-Gaussian posterior N(θ*, (AᵀA)⁻¹)."""
    return -0.5 * torch.sum((th @ AT.T - BT) ** 2, dim=1)


def jlogp(th):
    return -0.5 * jnp.sum((jnp.asarray(A) @ th - jnp.asarray(B)) ** 2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _reference_draws(key, n_steps, half):
    """The draws of the reference's ``ensemble_sample``: one key per
    sweep, split in two halves, each split in three (partners, stretch,
    acceptance)."""
    out = []
    for k in jax.random.split(key, n_steps):
        sweep = []
        for kh in jax.random.split(k):
            k_pick, k_z, k_u = jax.random.split(kh, 3)
            sweep.append(tuple(torch.as_tensor(np.array(d)) for d in (
                jax.random.randint(k_pick, (half,), 0, half),
                jax.random.uniform(k_z, (half,), dtype=jnp.float64),
                jax.random.uniform(k_u, (half,), dtype=jnp.float64))))
        out.append(sweep)
    return out


def test_sweep_fed_the_reference_draws_gives_the_reference_chain():
    """20 sweeps of 16 walkers: chain, log-probs and acceptance equal the
    reference's to 1e-12."""
    W, n_steps = 16, 20
    x0 = THETA + 0.1 * np.random.default_rng(1).normal(size=(W, 3))
    key = jax.random.PRNGKey(5)
    ref = jmcmc.ensemble_sample(jlogp, jnp.asarray(x0), n_steps, key)
    x = torch.as_tensor(x0)
    lp = logp(x)
    xs, lps, accs = [], [], []
    for draws in _reference_draws(key, n_steps, W // 2):
        x, lp, acc = _sweep(x, lp, logp, 2.0, draws)
        xs.append(x)
        lps.append(lp)
        accs.append(acc)
    acc = torch.stack(accs).double().mean(dim=0)
    np.testing.assert_allclose(torch.stack(xs).numpy(),
                               np.asarray(ref.chain), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(torch.stack(lps).numpy(),
                               np.asarray(ref.log_prob), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref.acceptance),
                               rtol=1e-12, atol=1e-12)
    assert 0.0 < float(acc.mean()) < 1.0


def test_linear_gaussian_moments():
    """After tests/test_mcmc.py: 64 walkers, 2000 sweeps; sampled mean and
    covariance against the analytic posterior to Monte-Carlo error."""
    W, G = 64, 3
    x0 = torch.as_tensor(THETA + 0.1 * np.random.default_rng(1)
                         .normal(size=(W, G)))
    res = ensemble_sample(logp, x0, n_steps=2000, generator=_gen(2))
    assert isinstance(res, MCMCResult)
    assert tuple(res.chain.shape) == (2000, W, G)
    assert tuple(res.log_prob.shape) == (2000, W)
    samp = res.flat(burn=500).numpy()
    assert samp.shape == (1500 * W, G)
    np.testing.assert_allclose(samp.mean(axis=0), THETA, atol=0.05)
    np.testing.assert_allclose(np.cov(samp.T), COV, rtol=0.25, atol=0.02)
    acc = res.acceptance.numpy()
    assert np.all(acc > 0.1) and np.all(acc < 0.9)
    tau = autocorr_time(res.chain[500:])
    assert np.all(tau > 0.5) and np.all(tau < 200.0)


def test_determinism_and_thin():
    """After tests/test_mcmc.py: one seed, one chain; thin=3 keeps sweeps
    2, 5, 8, ... and the acceptance over every sweep."""
    x0 = torch.as_tensor(THETA + 0.05 * np.random.default_rng(3)
                         .normal(size=(16, 3)))
    a = ensemble_sample(logp, x0, 60, _gen(7))
    b = ensemble_sample(logp, x0, 60, _gen(7))
    c = ensemble_sample(logp, x0, 60, _gen(8))
    assert torch.equal(a.chain, b.chain) and torch.equal(a.log_prob,
                                                         b.log_prob)
    assert not torch.equal(a.chain, c.chain)
    t = ensemble_sample(logp, x0, 60, _gen(7), thin=3)
    assert t.chain.shape[0] == 20
    assert torch.equal(t.chain, a.chain[2::3])
    assert torch.equal(t.log_prob, a.log_prob[2::3])
    assert torch.equal(t.acceptance, a.acceptance)


def two_blocks(th):
    """``logp`` evaluated in two blocks of rows: the split a two-rank mesh
    makes (tests/test_torch_mesh.py)."""
    n = th.shape[0] // 2
    return torch.cat([logp(th[:n]), logp(th[n:])])


def test_log_prob_v_override_gives_the_default_chain():
    """tests/test_mcmc.py::test_mesh_sharded_walkers_bitwise_match in one
    process: an override that evaluates each half in two blocks scores
    ``x0`` and both halves of every sweep (``log_prob_fn`` is never
    called), and gives the chain, log-probs and acceptance of the default
    evaluator at the same block split, bit for bit (on the CPU, bits per
    member hold only at equal batch size)."""
    W, n_steps = 32, 40
    x0 = torch.as_tensor(THETA + 0.05 * np.random.default_rng(9)
                         .normal(size=(W, 3)))
    calls = []

    def lpv(th):
        calls.append(th.shape[0])
        return two_blocks(th)

    def never(th):
        raise AssertionError("log_prob_fn called beside log_prob_v")

    a = ensemble_sample(two_blocks, x0, n_steps, _gen(11))
    b = ensemble_sample(never, x0, n_steps, _gen(11), log_prob_v=lpv)
    assert calls == [W] + [W // 2] * (2 * n_steps)
    assert torch.equal(a.chain, b.chain)
    assert torch.equal(a.log_prob, b.log_prob)
    assert torch.equal(a.acceptance, b.acceptance)


def test_bounded_support_rejection():
    """After tests/test_mcmc.py: -inf outside a box and NaN in one corner
    of it. Every kept sample stays inside and off the NaN corner, and
    walkers starting just outside (at -inf) escape into the support."""
    lb, ub = -1.0, 1.0

    def bounded(th):
        inside = ((th > lb) & (th < ub)).all(dim=1)
        lp = torch.where(inside, -0.5 * torch.sum(th * th, dim=1),
                         float("-inf"))
        corner = (th[:, 0] > 0.9) & (th[:, 1] > 0.9)
        return torch.where(corner, float("nan"), lp)

    rng = np.random.default_rng(4)
    x0 = rng.uniform(-0.8, 0.8, size=(32, 2))
    x0[0] = [1.3, 0.0]
    x0[17] = [-1.2, 0.4]
    res = ensemble_sample(bounded, torch.as_tensor(x0), 300, _gen(5))
    tail = res.chain[100:].numpy()
    assert np.all(tail > -1.0) and np.all(tail < 1.0)
    assert not np.any((tail[..., 0] > 0.9) & (tail[..., 1] > 0.9))
    assert np.all(np.isfinite(res.log_prob[100:].numpy()))


@pytest.mark.parametrize("shape,kw", [((5, 2), {}), ((2, 2), {}),
                                      ((8, 2), {"thin": 3})])
def test_validation(shape, kw):
    with pytest.raises(ValueError):
        ensemble_sample(lambda th: -0.5 * torch.sum(th * th, dim=1),
                        torch.zeros(shape, dtype=torch.float64), 10,
                        _gen(0), **kw)


def test_autocorr_time_matches_reference():
    """One numpy chain (an AR(1) process per walker and parameter), the
    reference's estimator to 1e-12, from an array and from a tensor."""
    rng = np.random.default_rng(6)
    S, W, G = 400, 8, 3
    x = np.zeros((S, W, G))
    phi = np.array([0.2, 0.7, 0.95])
    for s in range(1, S):
        x[s] = phi * x[s - 1] + rng.normal(size=(W, G))
    ref = np.asarray(jmcmc.autocorr_time(jnp.asarray(x)))
    np.testing.assert_allclose(autocorr_time(x), ref, rtol=1e-12)
    np.testing.assert_allclose(autocorr_time(torch.as_tensor(x)), ref,
                               rtol=1e-12)
    assert ref[0] < ref[1] < ref[2]
