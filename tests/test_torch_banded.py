"""The port's banded LU (``tpusysbio_torch/linalg/banded.py``) against the
JAX reference's (``tpusysbio/linalg/banded.py``) on the same matrices.

Tolerances: packed storage equal bit for bit; the packed LU within 1e-13
and the solves within 1e-12 (absolute, on diagonally dominant matrices of
entries O(1)) of the reference's; a BDF run under ``'banded'`` with the
reference's ``'banded'`` step counters, within 2 steps of the port's
``'lu'`` run, and its trajectory within 1e-6 relative of both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.linalg import banded as jbanded
from tpusysbio.solvers import bdf_solve as jbdf_solve
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.linalg import banded, make_linear_solver
from tpusysbio_torch.solvers import STATUS_DONE, bdf_solve

torch.set_num_threads(1)


def _random_banded(n, kl, ku, seed=0, dom=4.0):
    """``tests/test_banded.py``'s diagonally dominant banded matrix."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for d in range(-ku, kl + 1):
        vals = rng.normal(size=n - abs(d))
        if d >= 0:
            A[np.arange(d, n), np.arange(0, n - d)] = vals
        else:
            A[np.arange(0, n + d), np.arange(-d, n)] = vals
    return A + dom * np.eye(n)


@pytest.mark.parametrize("n,kl,ku", [(12, 1, 1), (30, 2, 3), (97, 3, 3),
                                     (16, 0, 2), (16, 2, 0)])
def test_factor_and_solve_match_reference(n, kl, ku):
    A = _random_banded(n, kl, ku, seed=n + kl)
    b = np.random.default_rng(1).normal(size=(n,))
    Bj = jbanded.band_from_dense(jnp.asarray(A), kl, ku)
    LUj = jbanded.banded_factor(Bj, kl, ku)
    xj = jbanded.banded_solve(LUj, jnp.asarray(b), kl, ku)

    Bt = banded.band_from_dense(torch.as_tensor(A)[None], kl, ku)
    np.testing.assert_array_equal(Bt[0].numpy(), np.asarray(Bj))
    np.testing.assert_array_equal(
        banded.band_to_dense(Bt, kl, ku)[0].numpy(), A)
    LUt = banded.banded_factor(Bt, kl, ku)
    np.testing.assert_allclose(LUt[0].numpy(), np.asarray(LUj), rtol=0,
                               atol=1e-13)
    xt = banded.banded_solve(LUt, torch.as_tensor(b)[None], kl, ku)
    np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(xt[0].numpy(), np.linalg.solve(A, b),
                               rtol=1e-10, atol=1e-12)


def test_batched_multi_rhs_matches_reference():
    """A batch of 4 matrices with 3 right-hand sides each against the
    reference's vmapped solve."""
    n, kl, ku = 40, 2, 2
    As = np.stack([_random_banded(n, kl, ku, seed=s) for s in range(4)])
    rhs = np.random.default_rng(7).normal(size=(4, n, 3))

    def solve_one(A, b):
        Bb = jbanded.band_from_dense(A, kl, ku)
        return jbanded.banded_solve(jbanded.banded_factor(Bb, kl, ku), b,
                                    kl, ku)

    xj = np.asarray(jax.jit(jax.vmap(solve_one))(jnp.asarray(As),
                                                 jnp.asarray(rhs)))
    factor, solve = make_linear_solver("banded", (kl, ku))
    xt = solve(factor(torch.as_tensor(As)), torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)
    for i in range(4):
        np.testing.assert_allclose(xt[i], np.linalg.solve(As[i], rhs[i]),
                                   rtol=1e-9, atol=1e-11)


def test_chain_at_n200_matches_reference():
    """The point of banded over dense: n=200, kl=ku=1."""
    n = 200
    A = _random_banded(n, 1, 1, seed=3)
    b = np.random.default_rng(2).normal(size=(n,))
    xj = jbanded.banded_solve(jbanded.banded_factor(
        jbanded.band_from_dense(jnp.asarray(A), 1, 1), 1, 1),
        jnp.asarray(b), 1, 1)
    factor, solve = make_linear_solver("banded", (1, 1))
    xt = solve(factor(torch.as_tensor(A)[None]), torch.as_tensor(b)[None])
    np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(A @ xt[0].numpy(), b, rtol=1e-9, atol=1e-10)


def test_pivot_floor_and_kind_checks():
    """A zero pivot takes the reference's floor (1e-300 in f64, 1e-30 in
    f32); ``kind='banded'`` needs a bandwidth."""
    for dtype, tiny in ((torch.float64, 1e-300), (torch.float32, 1e-30)):
        A = torch.zeros((1, 3, 3), dtype=dtype)
        LU = banded.banded_factor(banded.band_from_dense(A, 1, 1), 1, 1)
        assert LU.dtype == dtype
        np.testing.assert_array_equal(LU[0, 1].numpy(),
                                      np.full(3, tiny, np.float32
                                              if dtype == torch.float32
                                              else np.float64))
    with pytest.raises(ValueError, match="bandwidth"):
        make_linear_solver("banded")


N_CHAIN = 24
K_CHAIN = 2.0


def _chain_reference(lin):
    def rhs(t, y):
        inflow = jnp.concatenate([jnp.asarray([0.0], y.dtype), y[:-1]])
        out = K_CHAIN * (inflow - y)
        return out.at[-1].add(-0.5 * y[-1] ** 2)

    kw = dict(jac_bandwidth=(1, 1)) if lin == "banded" else {}
    y0 = jnp.zeros((N_CHAIN,)).at[0].set(1.0)
    return jax.jit(lambda: jbdf_solve(
        rhs, (0.0, 5.0), y0, jnp.linspace(0.0, 5.0, 6),
        config=JSolverConfig(rtol=1e-6, atol=1e-9, linear_solver=lin,
                             **kw)))()


def _chain_port(lin, rates):
    """``tests/test_banded.py``'s relay chain, one member per rate."""
    k = torch.as_tensor(rates, dtype=torch.float64)[:, None]

    def rhs(t, y):
        inflow = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], dim=1)
        out = k * (inflow - y)
        return torch.cat([out[:, :-1], out[:, -1:] - 0.5 * y[:, -1:] ** 2],
                         dim=1)

    kw = dict(jac_bandwidth=(1, 1)) if lin == "banded" else {}
    y0 = torch.zeros((len(rates), N_CHAIN), dtype=torch.float64)
    y0[:, 0] = 1.0
    return bdf_solve(rhs, (0.0, 5.0), y0,
                     torch.linspace(0.0, 5.0, 6, dtype=torch.float64),
                     config=SolverConfig(rtol=1e-6, atol=1e-9,
                                         linear_solver=lin, **kw))


def test_bdf_banded_matches_reference_and_lu():
    ref = _chain_reference("banded")
    band = _chain_port("banded", [K_CHAIN, 1.5])
    lu = _chain_port("lu", [K_CHAIN, 1.5])
    assert band.status.tolist() == lu.status.tolist() == [STATUS_DONE] * 2
    for name in ("nsteps", "naccepted", "nrejected", "nlu"):
        assert int(getattr(band, name)[0]) == int(getattr(ref, name)), name
    assert (band.nsteps - lu.nsteps).abs().max() <= 2
    np.testing.assert_allclose(band.ys[0].numpy(), np.asarray(ref.ys),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(band.ys.numpy(), lu.ys.numpy(), rtol=1e-6,
                               atol=1e-9)
