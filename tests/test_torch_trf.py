"""The port's robust losses and batched Coleman–Li TRF against the
reference's (and SciPy's), on cheap analytic residuals (no ODE).

The reference fits one θ per call under ``jax.vmap``; the port takes the
batch as a leading dimension. Both run f64 on the CPU with the same
arithmetic, so iterates agree to rounding (1e-10) and the counters
(status, n_iter, nfev, njev) are equal. The ``'svd'`` subproblem takes an
f32 SVD whose singular vectors differ between LAPACK builds; two f64
refinement rounds make the step independent of them (1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import least_squares

from tpusysbio.config import FitConfig as JFitConfig
from tpusysbio.optim import loss as jloss
from tpusysbio.optim import trf as jtrf
from tpusysbio_torch import FitConfig
from tpusysbio_torch.optim import (TRFState, lm_fit, trf_finish, trf_fit,
                                   trf_init, trf_run)
from tpusysbio_torch.optim.loss import LOSSES, make_loss

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# Objectives: Rosenbrock as residuals, exponential decay with outliers
# --------------------------------------------------------------------------

def jros_r(th):
    return jnp.stack([10.0 * (th[1] - th[0] ** 2), 1.0 - th[0]])


def jros_rj(th):
    return jros_r(th), jax.jacfwd(jros_r)(th)


def tros_r(th):
    return torch.stack([10.0 * (th[:, 1] - th[:, 0] ** 2), 1.0 - th[:, 0]],
                       dim=1)


def tros_rj(th):
    z = torch.zeros_like(th[:, 0])
    J = torch.stack([torch.stack([-20.0 * th[:, 0], z + 10.0], dim=1),
                     torch.stack([z - 1.0, z], dim=1)], dim=1)
    return tros_r(th), J


# the bounded optimum: (1, 1) lies outside, the upper bound of θ0 is active
ROS_LB = np.array([-2.0, -2.0])
ROS_UB = np.array([0.8, 2.0])
# the third start lies beyond the active bound and is nudged inside
ROS_STARTS = np.array([[-1.2, 1.0], [0.5, -1.0], [1.5, 1.0], [-0.3, 1.5]])

T = np.linspace(0.0, 5.0, 24)
_rng = np.random.default_rng(3)
Y = 3.0 * np.exp(-0.8 * T) + 0.3 + _rng.normal(scale=0.02, size=T.shape)
Y[5] += 2.5
Y[17] -= 1.8
TJ, YJ = jnp.asarray(T), jnp.asarray(Y)
TT, YT = torch.as_tensor(T), torch.as_tensor(Y)
EXP_LB, EXP_UB = np.full(3, -10.0), np.full(3, 10.0)


def jexp_r(th):
    return th[0] * jnp.exp(-th[1] * TJ) + th[2] - YJ


def jexp_rj(th):
    return jexp_r(th), jax.jacfwd(jexp_r)(th)


def texp_r(th):
    return th[:, :1] * torch.exp(-th[:, 1:2] * TT) + th[:, 2:3] - YT


def texp_rj(th):
    e = torch.exp(-th[:, 1:2] * TT)
    J = torch.stack([e, -th[:, :1] * TT * e, torch.ones_like(e)], dim=2)
    return texp_r(th), J


def _ref(jr, jrj, starts, lb, ub, max_iter, **kw):
    """The reference's trf_fit under ``jax.vmap``, as numpy."""
    cfg = JFitConfig(max_iter=max_iter)
    out = jax.jit(jax.vmap(lambda th: jtrf.trf_fit(
        jr, jrj, th, jnp.asarray(lb), jnp.asarray(ub), cfg, **kw)))(
        jnp.asarray(starts))
    return jax.tree.map(np.asarray, out)


def _assert_matches(got, ref, tol=1e-10,
                    counters=("status", "n_iter", "nfev", "njev")):
    for f in counters:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    for f in ("theta", "cost", "cost_trace"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f),
                                   rtol=tol, atol=tol, err_msg=f)


# --------------------------------------------------------------------------
# Robust losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("loss", LOSSES)
def test_make_loss_matches_reference(loss):
    """Cost and scaling at z = 0, z < 1, z = 1 and z >> 1 (f_scale 0.5:
    r = 0, ±0.3, ±0.5, ±40), as rows of a batch (1e-14)."""
    f_scale = 0.5
    r = np.array([[0.0, 0.3, -0.5, 40.0], [-0.3, 0.5, -40.0, 1e-3]])
    J = np.random.default_rng(0).normal(size=(2, 4, 3))
    cost_fn, scale_fn = make_loss(loss, f_scale)
    jcost, jscale = jloss.make_loss(loss, f_scale)
    if loss == "linear":
        assert cost_fn is None and scale_fn is None and jcost is None
        return
    cost = cost_fn(torch.as_tensor(r)).numpy()
    rs, Js = scale_fn(torch.as_tensor(r), torch.as_tensor(J))
    for i in range(2):
        np.testing.assert_allclose(cost[i], float(jcost(jnp.asarray(r[i]))),
                                   rtol=1e-14, atol=1e-14)
        jr, jJ = jscale(jnp.asarray(r[i]), jnp.asarray(J[i]))
        np.testing.assert_allclose(rs[i].numpy(), np.asarray(jr),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(Js[i].numpy(), np.asarray(jJ),
                                   rtol=1e-14, atol=1e-14)


def test_make_loss_validation():
    with pytest.raises(ValueError, match="unknown loss"):
        make_loss("l1", 1.0)
    with pytest.raises(ValueError, match="f_scale"):
        make_loss("huber", 0.0)
    with pytest.raises(ValueError, match="f_scale"):
        make_loss("cauchy", -1.0)
    assert make_loss("linear", -1.0) == (None, None)


# --------------------------------------------------------------------------
# Bounded TRF
# --------------------------------------------------------------------------

def test_bounded_rosenbrock_matches_reference_and_scipy():
    """4 starts, the upper bound of θ0 active at the optimum and one start
    beyond it: the reference's vmapped trf_fit to 1e-10 with equal
    counters, and SciPy's least_squares(method='trf') to 1e-6."""
    got = trf_fit(tros_r, tros_rj, torch.as_tensor(ROS_STARTS), ROS_LB,
                  ROS_UB, FitConfig(max_iter=300))
    ref = _ref(jros_r, jros_rj, ROS_STARTS, ROS_LB, ROS_UB, 300)
    _assert_matches(got, ref)
    assert bool((got.status > 0).all())
    th = got.theta.numpy()
    assert np.all(th > ROS_LB) and np.all(th < ROS_UB)
    for i, x0 in enumerate(np.clip(ROS_STARTS, ROS_LB + 1e-3,
                                   ROS_UB - 1e-3)):
        sp = least_squares(
            lambda x: tros_r(torch.as_tensor(x)[None])[0].numpy(), x0,
            jac=lambda x: tros_rj(torch.as_tensor(x)[None])[1][0].numpy(),
            bounds=(ROS_LB, ROS_UB), method="trf")
        np.testing.assert_allclose(th[i], sp.x, atol=1e-6)
        np.testing.assert_allclose(float(got.cost[i]), sp.cost, atol=1e-6)


@pytest.mark.parametrize("bound", [10.0, np.inf])
def test_inactive_bounds_give_the_lm_optimum(bound):
    """Wide or infinite bounds: TRF reaches LM's unconstrained optimum."""
    th0 = torch.as_tensor(ROS_STARTS[:2])
    lb, ub = np.full(2, -bound), np.full(2, bound)
    got = trf_fit(tros_r, tros_rj, th0, lb, ub, FitConfig(max_iter=300))
    lm = lm_fit(tros_r, tros_rj, th0, FitConfig(max_iter=300))
    assert bool((got.status > 0).all())
    np.testing.assert_allclose(got.theta.numpy(), lm.theta.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got.theta.numpy(), np.ones((2, 2)),
                               atol=1e-5)
    ref = _ref(jros_r, jros_rj, ROS_STARTS[:2], lb, ub, 300)
    _assert_matches(got, ref)


def test_svd_subproblem_matches_normal_and_reference():
    got = trf_fit(tros_r, tros_rj, torch.as_tensor(ROS_STARTS), ROS_LB,
                  ROS_UB, FitConfig(max_iter=300), subproblem="svd")
    normal = trf_fit(tros_r, tros_rj, torch.as_tensor(ROS_STARTS), ROS_LB,
                     ROS_UB, FitConfig(max_iter=300))
    ref = _ref(jros_r, jros_rj, ROS_STARTS, ROS_LB, ROS_UB, 300,
               subproblem="svd")
    assert bool((got.status > 0).all())
    np.testing.assert_allclose(got.theta.numpy(), normal.theta.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got.cost.numpy(), normal.cost.numpy(),
                               atol=1e-9)
    _assert_matches(got, ref, tol=1e-8)
    with pytest.raises(ValueError, match="subproblem"):
        trf_fit(tros_r, tros_rj, torch.as_tensor(ROS_STARTS), ROS_LB,
                ROS_UB, subproblem="SVD")


@pytest.mark.parametrize("loss,f_scale", [("soft_l1", 1.0), ("huber", 0.5),
                                          ("cauchy", 2.0), ("arctan", 1.0)])
def test_robust_loss_matches_scipy_and_reference(loss, f_scale):
    """After tests/test_fit.py's robust-loss test: exponential decay with
    two gross outliers, from two starts. SciPy's optimum (θ 1e-4/1e-5,
    robust cost 1e-6), the reference to 1e-10 with equal counters, and a
    decay rate closer to the truth than the plain fit's."""
    starts = np.array([[1.0, 1.0, 0.0], [2.0, 0.5, 0.5]])
    cfg = FitConfig(max_iter=200)
    got = trf_fit(texp_r, texp_rj, torch.as_tensor(starts), EXP_LB, EXP_UB,
                  cfg, loss=loss, f_scale=f_scale)
    ref = _ref(jexp_r, jexp_rj, starts, EXP_LB, EXP_UB, 200, loss=loss,
               f_scale=f_scale)
    _assert_matches(got, ref)
    plain = trf_fit(texp_r, texp_rj, torch.as_tensor(starts), EXP_LB,
                    EXP_UB, cfg)
    for i, x0 in enumerate(starts):
        sp = least_squares(
            lambda x: texp_r(torch.as_tensor(x)[None])[0].numpy(), x0,
            jac=lambda x: texp_rj(torch.as_tensor(x)[None])[1][0].numpy(),
            loss=loss, f_scale=f_scale, method="trf")
        assert int(got.status[i]) > 0 and sp.success
        np.testing.assert_allclose(got.theta[i].numpy(), sp.x, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(float(got.cost[i]), sp.cost, rtol=1e-6)
        assert (abs(float(got.theta[i, 1]) - 0.8)
                < abs(float(plain.theta[i, 1]) - 0.8))


def test_huber_all_outlier_start_stalls_where_the_reference_does():
    """Every residual starts in the Huber tail (f_scale 1e-3, |r| ~ 1):
    the robust curvature is the eps floor on every row and the damped
    subproblem stalls, rejecting steps until λ has grown (trf_fit's
    docstring). The port keeps that behaviour: the same statuses and
    iteration counts as the reference, the same stall (3-5 rejected
    iterations before the first accepted step), and the same iterates to
    1e-10 through iteration 12. Past that the iterates part: with
    curvature at the eps floor, rounding decides which steps are accepted
    (njev and costs differ by up to 1e-2 relative at 50 iterations)."""
    starts = np.array([[1.0, 1.0, 0.0], [5.0, 0.2, -1.0],
                       [30.0, 1.0, 10.0]])
    got = trf_fit(texp_r, texp_rj, torch.as_tensor(starts), EXP_LB, EXP_UB,
                  FitConfig(max_iter=50), loss="huber", f_scale=1e-3)
    ref = _ref(jexp_r, jexp_rj, starts, EXP_LB, EXP_UB, 50, loss="huber",
               f_scale=1e-3)
    for f in ("status", "n_iter", "nfev"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    trace = got.cost_trace.numpy()

    def stall(tr):
        return np.argmax(tr < tr[:, :1], axis=1)

    np.testing.assert_array_equal(stall(trace), stall(ref.cost_trace))
    assert np.all(stall(trace) >= 3)
    np.testing.assert_allclose(trace[:, :13], ref.cost_trace[:, :13],
                               rtol=1e-10)


def test_finish_covariance_matches_reference():
    got = trf_fit(texp_r, texp_rj, torch.as_tensor([[1.0, 1.0, 0.0]]),
                  EXP_LB, EXP_UB, FitConfig(max_iter=200), loss="soft_l1")
    ref = _ref(jexp_r, jexp_rj, np.array([[1.0, 1.0, 0.0]]), EXP_LB,
               EXP_UB, 200, loss="soft_l1")
    for f in ("cov", "param_sigma", "grad_norm"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f),
                                   rtol=1e-10, atol=1e-10, err_msg=f)


def test_init_then_run_in_chunks_equals_one_run():
    """trf_init, then trf_run capped at 3, 6, 9, ... iterations: the
    state of one uncapped run, bit for bit."""
    cfg = FitConfig(max_iter=30)
    th = torch.as_tensor(ROS_STARTS)
    whole = trf_run(tros_r, tros_rj,
                    trf_init(tros_rj, th, ROS_LB, ROS_UB, cfg),
                    ROS_LB, ROS_UB, cfg)
    st = trf_init(tros_rj, th, ROS_LB, ROS_UB, cfg)
    assert isinstance(st, TRFState)
    for cap in range(3, 31, 3):
        st = trf_run(tros_r, tros_rj, st, ROS_LB, ROS_UB, cfg, iter_cap=cap)
        assert int(st.n_iter.max()) <= cap
    for a, b in zip(st, whole):
        assert torch.equal(a, b)
    fr = trf_finish(st)
    assert tuple(fr.cov.shape) == (4, 2, 2)


@pytest.mark.parametrize("subproblem", ["normal", "svd"])
def test_nonfinite_start_is_masked_and_alone(subproblem):
    """A NaN start gets status -1 at once and never moves; the other
    members' results are those of the clean batch, bit for bit, and the
    statuses are the reference's."""
    bad = ROS_STARTS.copy()
    bad[1] = np.nan
    cfg = FitConfig(max_iter=100)
    clean = trf_fit(tros_r, tros_rj, torch.as_tensor(ROS_STARTS), ROS_LB,
                    ROS_UB, cfg, subproblem=subproblem)
    res = trf_fit(tros_r, tros_rj, torch.as_tensor(bad), ROS_LB, ROS_UB,
                  cfg, subproblem=subproblem)
    assert int(res.status[1]) == -1 and int(res.n_iter[1]) == 0
    assert bool(torch.isnan(res.theta[1]).all())
    keep = [0, 2, 3]
    for f in ("theta", "cost", "status", "n_iter", "nfev", "njev",
              "cost_trace"):
        assert torch.equal(getattr(res, f)[keep], getattr(clean, f)[keep]), f
    ref = _ref(jros_r, jros_rj, bad, ROS_LB, ROS_UB, 100,
               subproblem=subproblem)
    np.testing.assert_array_equal(res.status.numpy(), ref.status)
