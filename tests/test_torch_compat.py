"""The port's SciPy facades (``tpusysbio_torch/compat.py``) against SciPy
itself, case by case as ``tests/test_compat.py`` holds the JAX package's,
plus the three places where the port follows SciPy and the reference does
not (a terminal event's grid, ``odeint``'s monotonic ``t``,
``least_squares(method='lm')`` with a robust loss).

Tolerances are ``tests/test_compat.py``'s: trajectories within 1e-6
relative (the port at rtol 1e-8, SciPy at 1e-10), dense output within
1e-4, event times within 1e-6, fits within 1e-5 to 1e-8.
"""

import numpy as np
import pytest
import scipy.integrate as si
import scipy.optimize as so
import torch

from tpusysbio_torch import compat

torch.set_num_threads(1)

CPU = dict(device="cpu")
Y0 = [1.0, 0.0]


def _decay(t, y):
    # linear 2-state with a mild stiffness ratio
    return torch.stack([-0.5 * y[0] + 40.0 * (y[1] - y[0]),
                        -40.0 * (y[1] - y[0]) - 0.1 * y[1]])


def _decay_np(t, y):
    return np.asarray([-0.5 * y[0] + 40.0 * (y[1] - y[0]),
                       -40.0 * (y[1] - y[0]) - 0.1 * y[1]])


def _rot(t, y):
    return torch.stack([y[1], -y[0]])


def _rot_np(t, y):
    return np.asarray([y[1], -y[0]])


def _event(t, y):
    return y[0] - 0.5


_event.terminal = True
_event.direction = -1.0


def test_solve_ivp_bdf_parity():
    t_eval = np.linspace(0.0, 5.0, 17)
    ours = compat.solve_ivp(_decay, (0.0, 5.0), Y0, method="BDF",
                            t_eval=t_eval, rtol=1e-8, atol=1e-10, **CPU)
    ref = si.solve_ivp(_decay_np, (0.0, 5.0), Y0, method="BDF",
                       t_eval=t_eval, rtol=1e-10, atol=1e-12)
    assert ours.success and ours.status == 0
    assert ours.y.shape == ref.y.shape
    np.testing.assert_allclose(ours.y, ref.y, rtol=1e-6, atol=1e-9)
    assert ours.nfev > 0 and ours.nlu > 0


def test_solve_ivp_accepted_step_grid_and_dense_output():
    ours = compat.solve_ivp(_decay, (0.0, 5.0), Y0, method="BDF",
                            dense_output=True, rtol=1e-6, atol=1e-9, **CPU)
    assert ours.t[0] == 0.0 and ours.t[-1] == 5.0
    assert np.all(np.diff(ours.t) > 0)
    assert ours.y.shape == (2, ours.t.size)
    ref = si.solve_ivp(_decay_np, (0.0, 5.0), Y0, method="BDF",
                       dense_output=True, rtol=1e-10, atol=1e-12)
    probe = np.linspace(0.3, 4.7, 9)
    np.testing.assert_allclose(np.asarray(ours.sol(probe)).T[:2],
                               ref.sol(probe), rtol=1e-4, atol=1e-7)


def test_solve_ivp_backward():
    t_eval = np.linspace(5.0, 0.0, 11)
    ours = compat.solve_ivp(_rot, (5.0, 0.0), [0.4, 0.2], method="BDF",
                            t_eval=t_eval, rtol=1e-8, atol=1e-10, **CPU)
    ref = si.solve_ivp(_rot_np, (5.0, 0.0), [0.4, 0.2], method="BDF",
                       t_eval=t_eval, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours.y, ref.y, rtol=1e-5, atol=1e-7)


def test_solve_ivp_events_parity():
    t_eval = np.linspace(0.0, 5.0, 11)
    ours = compat.solve_ivp(_decay, (0.0, 5.0), Y0, method="BDF",
                            t_eval=t_eval, events=[_event], rtol=1e-8,
                            atol=1e-10, **CPU)
    ref = si.solve_ivp(_decay_np, (0.0, 5.0), Y0, method="BDF",
                       t_eval=t_eval, events=[_event], rtol=1e-10,
                       atol=1e-12)
    assert ours.status == 1 and ref.status == 1
    assert len(ours.t_events) == 1
    np.testing.assert_allclose(ours.t_events[0], ref.t_events[0],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ours.y_events[0], ref.y_events[0],
                               rtol=1e-5, atol=1e-7)
    # SciPy keeps only the t_eval points up to the event
    np.testing.assert_array_equal(ours.t, ref.t)
    np.testing.assert_allclose(ours.y, ref.y, rtol=1e-6, atol=1e-9)


def test_terminal_event_grid_ends_at_the_event():
    """t_eval=None with a terminal event: the grid's last point is
    t_event and its state the state there, as in SciPy (the reference
    returns the whole last accepted step, ROADMAP Queue 3)."""
    ours = compat.solve_ivp(_decay, (0.0, 5.0), Y0, method="BDF",
                            events=[_event], rtol=1e-8, atol=1e-10, **CPU)
    ref = si.solve_ivp(_decay_np, (0.0, 5.0), Y0, method="BDF",
                       events=[_event], rtol=1e-10, atol=1e-12)
    assert ours.status == ref.status == 1
    assert ours.t[-1] == ours.t_events[0][0]
    assert np.all(np.diff(ours.t) > 0)
    np.testing.assert_allclose(ours.t[-1], ref.t[-1], rtol=1e-6)
    np.testing.assert_allclose(ours.y[:, -1], ref.y[:, -1], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ours.y[0, -1], 0.5, rtol=1e-7)


def test_solve_ivp_explicit_and_unknown_method():
    t_eval = np.linspace(0.0, 2.0, 9)
    ours = compat.solve_ivp(_decay, (0.0, 2.0), Y0, method="RK45",
                            t_eval=t_eval, rtol=1e-8, atol=1e-10, **CPU)
    ref = si.solve_ivp(_decay_np, (0.0, 2.0), Y0, method="RK45",
                       t_eval=t_eval, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours.y, ref.y, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        compat.solve_ivp(_decay, (0.0, 2.0), Y0, method="nope",
                         t_eval=t_eval, **CPU)
    with pytest.raises(ValueError):  # dense output is BDF-only
        compat.solve_ivp(_decay, (0.0, 2.0), Y0, method="RK45", **CPU)


def test_odeint_parity_and_full_output():
    t = np.linspace(0.0, 5.0, 21)
    ours, info = compat.odeint(lambda y, tt: _decay(tt, y), Y0, t,
                               full_output=True, **CPU)
    ref = si.odeint(lambda y, tt: _decay_np(tt, y), Y0, t)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-9)
    assert info["nst"] > 0 and info["nfe"] > 0
    assert info["message"] == "Integration successful."
    one = compat.odeint(lambda y, tt: _decay(tt, y), Y0, np.asarray([0.0]),
                        **CPU)
    np.testing.assert_array_equal(one, np.asarray([Y0]))


def test_odeint_decreasing_t():
    t = np.linspace(3.0, 0.0, 13)
    ours = compat.odeint(lambda y, tt: _rot(tt, y), [0.3, 0.1], t, **CPU)
    ref = si.odeint(lambda y, tt: _rot_np(tt, y), [0.3, 0.1], t)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-8)


def test_odeint_non_monotonic_t_raises_as_scipy():
    """SciPy's odeint refuses a t that is not monotonic (the reference
    leaves the out-of-order rows at 0, ROADMAP Queue 3); repeated values
    are allowed in both."""
    t = [0.0, 1.0, 0.5]
    with pytest.raises(ValueError) as ref:
        si.odeint(lambda y, tt: _decay_np(tt, y), Y0, t)
    with pytest.raises(ValueError) as ours:
        compat.odeint(lambda y, tt: _decay(tt, y), Y0, t, **CPU)
    assert str(ours.value) == str(ref.value)
    t_rep = [0.0, 0.5, 0.5, 1.0]
    np.testing.assert_allclose(
        compat.odeint(lambda y, tt: _decay(tt, y), Y0, t_rep, **CPU),
        si.odeint(lambda y, tt: _decay_np(tt, y), Y0, t_rep), rtol=1e-6,
        atol=1e-9)


def _powell_r(th):
    return torch.stack([1e4 * th[0] * th[1] - 1.0,
                        torch.exp(-th[0]) + torch.exp(-th[1]) - 1.0001])


def _powell_np(th):
    return np.asarray([1e4 * th[0] * th[1] - 1.0,
                       np.exp(-th[0]) + np.exp(-th[1]) - 1.0001])


def test_leastsq_parity():
    x0 = [0.0, 1.0]
    ours_x, ours_ier = compat.leastsq(_powell_r, x0, **CPU)
    ref_x, ref_ier = so.leastsq(_powell_np, x0)
    assert ours_ier in (1, 2, 3, 4) and ref_ier in (1, 2, 3, 4)
    np.testing.assert_allclose(np.sort(ours_x), np.sort(ref_x), rtol=1e-5)
    x, cov, info, mesg, ier = compat.leastsq(_powell_r, x0,
                                             full_output=True, **CPU)
    _, rcov, _, _, _ = so.leastsq(_powell_np, x0, full_output=True)
    np.testing.assert_allclose(cov, rcov, rtol=5e-3)
    assert info["nfev"] > 0 and info["fvec"].shape == (2,)


def _rosen(th):
    return torch.stack([10.0 * (th[1] - th[0] ** 2), 1.0 - th[0]])


def _rosen_np(th):
    return np.asarray([10.0 * (th[1] - th[0] ** 2), 1.0 - th[0]])


def test_least_squares_bounds_and_loss_parity():
    lb, ub = [-2.0, -2.0], [0.8, 2.0]  # (1, 1) infeasible
    ours = compat.least_squares(_rosen, [-1.2, 1.0], bounds=(lb, ub), **CPU)
    ref = so.least_squares(_rosen_np, [-1.2, 1.0], bounds=(lb, ub))
    assert ours.success and ref.success
    np.testing.assert_allclose(ours.x, ref.x, atol=1e-6)
    np.testing.assert_allclose(ours.cost, ref.cost, rtol=1e-8)
    assert ours.fun.shape == ref.fun.shape
    assert ours.jac.shape == ref.jac.shape
    np.testing.assert_array_equal(ours.active_mask, ref.active_mask)

    t = np.linspace(0.0, 5.0, 24)
    y = 3.0 * np.exp(-0.8 * t) + 0.3
    y[5] += 2.5
    y[17] -= 1.8
    tt, yt = torch.as_tensor(t), torch.as_tensor(y)

    def decay_r(th):
        return th[0] * torch.exp(-th[1] * tt) + th[2] - yt

    def decay_np(th):
        return th[0] * np.exp(-th[1] * t) + th[2] - y

    oh = compat.least_squares(decay_r, [1.0, 1.0, 0.0], loss="huber",
                              f_scale=0.5, **CPU)
    rh = so.least_squares(decay_np, [1.0, 1.0, 0.0], loss="huber",
                          f_scale=0.5)
    assert oh.success and rh.success
    np.testing.assert_allclose(oh.x, rh.x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(oh.cost, rh.cost, rtol=1e-6)

    with pytest.raises(ValueError):
        compat.least_squares(_rosen, [0.0, 0.0], jac="2-point", **CPU)
    with pytest.raises(ValueError):
        compat.least_squares(_rosen, [0.0, 0.0], method="dogbox", **CPU)


def test_lm_with_robust_loss_raises_as_scipy():
    """SciPy refuses method='lm' with a robust loss (the reference drops
    the loss silently, ROADMAP Queue 3)."""
    with pytest.raises(ValueError) as ref:
        so.least_squares(_rosen_np, [0.0, 0.0], method="lm", loss="huber")
    with pytest.raises(ValueError) as ours:
        compat.least_squares(_rosen, [0.0, 0.0], method="lm", loss="huber",
                             **CPU)
    assert str(ours.value) == str(ref.value)
    # and with the linear loss it is LM, as in SciPy
    lm = compat.least_squares(_rosen, [-1.2, 1.0], method="lm", **CPU)
    np.testing.assert_allclose(lm.x, [1.0, 1.0], atol=1e-6)
