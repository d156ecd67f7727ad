"""The port's batched Levenberg-Marquardt against the reference's, on cheap
analytic residuals (no ODE): a 3-parameter exponential fit and Rosenbrock
written as residuals, from 8 starts made with numpy.

The reference fits one θ per call under ``jax.vmap``; the port takes the
batch as a leading dimension. Both run f64 on the CPU with the same
arithmetic, so iterates agree to rounding (1e-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.config import FitConfig as JFitConfig
from tpusysbio.optim import lm as jlm
from tpusysbio_torch import FitConfig
from tpusysbio_torch.optim import (FitResult, LMState, lm_finish, lm_fit,
                                   lm_init, lm_run)

torch.set_num_threads(1)

N = 8
T_GRID = np.linspace(0.0, 4.0, 15)
_RNG = np.random.default_rng(3)
EXP_DATA = (2.0 * np.exp(-0.7 * T_GRID) + 0.5
            + 0.01 * _RNG.standard_normal(T_GRID.shape))


def _problems():
    """name -> (jax residual, jax residual+jac, torch residual, torch
    residual+jac, starts (N, G))."""
    tj = jnp.asarray(T_GRID)
    dj = jnp.asarray(EXP_DATA)
    tt = torch.as_tensor(T_GRID)
    dt = torch.as_tensor(EXP_DATA)

    def jexp_r(th):
        return th[0] * jnp.exp(-th[1] * tj) + th[2] - dj

    def texp_r(th):
        return (th[:, :1] * torch.exp(-th[:, 1:2] * tt) + th[:, 2:3] - dt)

    def texp_rj(th):
        e = torch.exp(-th[:, 1:2] * tt)
        J = torch.stack([e, -th[:, :1] * tt * e, torch.ones_like(e)], dim=2)
        return texp_r(th), J

    def jros_r(th):
        return jnp.stack([10.0 * (th[1] - th[0] ** 2), 1.0 - th[0]])

    def tros_r(th):
        return torch.stack([10.0 * (th[:, 1] - th[:, 0] ** 2),
                            1.0 - th[:, 0]], dim=1)

    def tros_rj(th):
        z = torch.zeros_like(th[:, 0])
        J = torch.stack([torch.stack([-20.0 * th[:, 0], z + 10.0], dim=1),
                         torch.stack([z - 1.0, z], dim=1)], dim=1)
        return tros_r(th), J

    def jrj(fn):
        return lambda th: (fn(th), jax.jacfwd(fn)(th))

    rng = np.random.default_rng(0)
    exp_starts = np.array([1.5, 0.5, 0.2]) + rng.uniform(-0.5, 0.5, (N, 3))
    ros_starts = rng.uniform(-1.5, 1.5, (N, 2))
    return {"exp": (jexp_r, jrj(jexp_r), texp_r, texp_rj, exp_starts),
            "rosenbrock": (jros_r, jrj(jros_r), tros_r, tros_rj,
                           ros_starts)}


PROBLEMS = _problems()
CASES = [(name, mode) for name in PROBLEMS
         for mode in ("economical", "lockstep")]


def _both(name, mode, starts=None, max_iter=40):
    jr, jrjac, tr, trjac, st = PROBLEMS[name]
    starts = st if starts is None else starts
    kw = dict(max_iter=max_iter, eval_mode=mode)
    ref = jax.jit(jax.vmap(lambda th: jlm.lm_fit(jr, jrjac, th,
                                                 JFitConfig(**kw))))(
        jnp.asarray(starts))
    got = lm_fit(tr, trjac, torch.as_tensor(starts), FitConfig(**kw))
    return got, jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("name,mode", CASES)
def test_lm_fit_matches_reference(name, mode):
    got, ref = _both(name, mode)
    assert isinstance(got, FitResult)
    for field in ("status", "n_iter", "njev", "nfev"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      getattr(ref, field), err_msg=field)
    for field in ("theta", "cost", "cost_trace", "grad_norm"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   getattr(ref, field), rtol=1e-10,
                                   atol=1e-10, err_msg=field)
    assert int((got.status > 0).sum()) >= N - 1
    np.testing.assert_allclose(got.cov.numpy(), ref.cov, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(got.param_sigma.numpy(), ref.param_sigma,
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("mode", ["economical", "lockstep"])
def test_nonfinite_start_is_masked_and_alone(mode):
    """A NaN start gets status -1 at once and never moves; the other
    members' results are those of the clean batch, bit for bit."""
    _, _, tr, trjac, starts = PROBLEMS["exp"]
    bad = starts.copy()
    bad[2] = np.nan
    cfg = FitConfig(max_iter=40, eval_mode=mode)
    clean = lm_fit(tr, trjac, torch.as_tensor(starts), cfg)
    res = lm_fit(tr, trjac, torch.as_tensor(bad), cfg)
    assert int(res.status[2]) == -1 and int(res.n_iter[2]) == 0
    assert bool(torch.isnan(res.theta[2]).all())
    keep = [i for i in range(N) if i != 2]
    for field in ("theta", "cost", "status", "n_iter", "cost_trace"):
        np.testing.assert_array_equal(getattr(res, field)[keep].numpy(),
                                      getattr(clean, field)[keep].numpy())
    ref = jax.tree.map(np.asarray, jax.vmap(
        lambda th: jlm.lm_fit(PROBLEMS["exp"][0], PROBLEMS["exp"][1], th,
                              JFitConfig(max_iter=40, eval_mode=mode)))(
        jnp.asarray(bad)))
    np.testing.assert_array_equal(res.status.numpy(), ref.status)


@pytest.mark.parametrize("name,mode", CASES)
def test_iter_cap_chunks_compose(name, mode):
    """Three capped ``lm_run`` calls give the unchunked state exactly."""
    _, _, tr, trjac, starts = PROBLEMS[name]
    cfg = FitConfig(max_iter=12, eval_mode=mode)
    th = torch.as_tensor(starts)
    whole = lm_run(tr, trjac, lm_init(trjac, th, cfg), cfg)
    st = lm_init(trjac, th, cfg)
    assert isinstance(st, LMState)
    for cap in (4, 8, 12):
        st = lm_run(tr, trjac, st, cfg, iter_cap=cap)
        assert int(st.n_iter.max()) <= cap
    for a, b in zip(st, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    fr = lm_finish(st)
    assert fr.cov.shape == (N, th.shape[1], th.shape[1])


def test_box_bounds_clip_the_steps():
    _, _, tr, trjac, starts = PROBLEMS["exp"]
    lower = torch.tensor([0.0, 0.0, 0.45], dtype=torch.float64)
    upper = torch.tensor([5.0, 5.0, 0.55], dtype=torch.float64)
    th = torch.as_tensor(np.clip(starts, lower.numpy(), upper.numpy()))
    res = lm_fit(tr, trjac, th, FitConfig(max_iter=30), lower, upper)
    assert bool((res.theta >= lower).all() and (res.theta <= upper).all())


def test_singular_normal_matrix_gives_nonfinite_cov_not_an_exception():
    """A residual that ignores one parameter: (JᵀJ) is singular."""
    def rj(th):
        r = th[:, :1] - 1.0
        J = torch.zeros((th.shape[0], 1, 2), dtype=th.dtype)
        J[:, 0, 0] = 1.0
        return r, J

    res = lm_fit(lambda th: rj(th)[0], rj,
                 torch.zeros((2, 2), dtype=torch.float64),
                 FitConfig(max_iter=5))
    assert res.cov.shape == (2, 2, 2)
    assert not bool(torch.isfinite(res.param_sigma).all()) or bool(
        (res.cov.abs() > 1e100).any())


def test_fit_config_field_parity():
    ref = {f.name: f.default for f in dataclasses.fields(JFitConfig)}
    got = {f.name: f.default for f in dataclasses.fields(FitConfig)}
    assert got == ref
    with pytest.raises(ValueError):
        FitConfig(eval_mode="fast")
