"""The port's state-dependent events (``EventSpec``) against the JAX
package's event buffers, SciPy and the exact roots: every case of
tests/test_events_rootfind.py, batched.

The JAX side runs each case through ``bdf_solve(events=...)`` (``vmap``
over the members where the case has several); the port runs the members
as one batch, with per-member thresholds closed over as (B, 1) tensors.
Tolerances: event times, states, counts, statuses, ``t_final`` and
``y_final`` against the JAX package's to 1e-10 (absolute; the same step
sequence in f64), event times against the exact roots and SciPy to 1e-6
(the reference's bar).

The port departs from the reference in one place, on purpose. When a
terminal event ends a step, the reference rewrites the anchor row of the
step's difference array to the state at the event time and then fills
the step's ``t_eval`` points from the rewritten array, whose polynomial
is shifted by the difference between the state at the step's end and at
the event: those points are off by up to one step's change of y. The
port fills them from the step's own polynomial first and rewrites the
anchor after. ``test_terminal_step_fill_matches_scipy`` holds that fill
against SciPy's dense output on y' = 1 (a terminal event at y = 0.75,
rtol=1e-8), where the reference's fill is off by ~2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.integrate import solve_ivp

from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.solvers import EventSpec as JEventSpec
from tpusysbio.solvers import bdf_solve as jbdf_solve
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import (
    STATUS_DONE,
    STATUS_EVENT,
    EventSpec,
    bdf_solve,
)

torch.set_num_threads(1)

CFG = dict(rtol=1e-8, atol=1e-10)
OSC = dict(rtol=1e-10, atol=1e-12)
F64 = torch.float64


def _decay(k):
    return lambda t, y: -k * y


def _osc_port(t, y):
    return torch.stack([y[:, 1], -y[:, 0]], dim=-1)


def _osc_jax(t, y):
    return jnp.array([y[1], -y[0]])


def _port(f, y0, t_span, t_eval, cfg, ev):
    return bdf_solve(f, t_span, torch.as_tensor(y0, dtype=F64),
                     torch.as_tensor(t_eval, dtype=F64),
                     config=SolverConfig(**cfg), events=ev)


def _jax(f, y0, t_span, t_eval, cfg, ev):
    out = jax.jit(lambda: jbdf_solve(f, t_span, jnp.asarray(y0),
                                     jnp.asarray(t_eval),
                                     config=JSolverConfig(**cfg),
                                     events=ev))()
    return jax.tree.map(np.asarray, out)


def _assert_events_equal(got, ref, member=0):
    """One port member against an unbatched JAX result."""
    np.testing.assert_array_equal(got.event_count[member].numpy(),
                                  ref.event_count)
    np.testing.assert_allclose(got.event_t[member].numpy(), ref.event_t,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.event_y[member].numpy(), ref.event_y,
                               rtol=0, atol=1e-10)
    assert int(got.status[member]) == int(ref.status)
    assert abs(float(got.t_final[member]) - float(ref.t_final)) <= 1e-10
    np.testing.assert_allclose(got.y_final[member].numpy(), ref.y_final,
                               rtol=0, atol=1e-10)
    assert int(got.nsteps[member]) == int(ref.nsteps)


def test_threshold_crossing_vs_scipy_and_analytic():
    k = 0.7
    t_eval = np.linspace(0.0, 5.0, 11)
    got = _port(_decay(k), [[1.0]], (0.0, 5.0), t_eval, CFG,
                EventSpec(fn=lambda t, y: y[:, :1] - 0.4))
    ref = _jax(_decay(k), [1.0], (0.0, 5.0), t_eval, CFG,
               JEventSpec(fn=lambda t, y: jnp.array([y[0] - 0.4])))
    _assert_events_equal(got, ref)
    t_exact = np.log(1.0 / 0.4) / k
    assert int(got.event_count[0, 0]) == 1
    assert abs(float(got.event_t[0, 0, 0]) - t_exact) < 1e-6
    assert abs(float(got.event_y[0, 0, 0, 0]) - 0.4) < 1e-6
    assert np.isinf(got.event_t[0, 0, 1:].numpy()).all()
    assert int(got.status[0]) == STATUS_DONE
    np.testing.assert_allclose(got.ys[0].numpy(), ref.ys, rtol=0,
                               atol=1e-12)
    sp = solve_ivp(lambda t, y: -k * y, (0.0, 5.0), [1.0], method="BDF",
                   rtol=1e-8, atol=1e-10, events=lambda t, y: y[0] - 0.4)
    assert abs(float(got.event_t[0, 0, 0]) - sp.t_events[0][0]) < 1e-6


def test_terminal_event_stops_at_root():
    k = 0.7
    t_eval = np.linspace(0.0, 5.0, 21)
    got = _port(_decay(k), [[1.0]], (0.0, 5.0), t_eval, CFG,
                EventSpec(fn=lambda t, y: y[:, :1] - 0.4, terminal=(True,)))
    ref = _jax(_decay(k), [1.0], (0.0, 5.0), t_eval, CFG,
               JEventSpec(fn=lambda t, y: jnp.array([y[0] - 0.4]),
                          terminal=(True,)))
    _assert_events_equal(got, ref)
    t_exact = np.log(1.0 / 0.4) / k
    assert int(got.status[0]) == STATUS_EVENT and bool(got.success[0])
    assert abs(float(got.t_final[0]) - t_exact) < 1e-6
    assert abs(float(got.y_final[0, 0, 0]) - 0.4) < 1e-6
    ys = got.ys[0, :, 0].numpy()
    filled = t_eval <= float(got.t_final[0])
    assert np.allclose(ys[filled][1:], np.exp(-k * t_eval[filled][1:]),
                       rtol=1e-6)
    assert np.all(ys[~filled] == 0.0)


def test_direction_semantics_oscillator():
    """y'' = -y, y = sin t: sin t = 0.5 rising at π/6 + 2πk, falling at
    5π/6 + 2πk."""
    t_eval = np.linspace(0.0, 7.0, 8)
    expect = {-1: [5 * np.pi / 6], 1: [np.pi / 6, 13 * np.pi / 6],
              0: [np.pi / 6, 5 * np.pi / 6, 13 * np.pi / 6]}
    for direction, roots in expect.items():
        got = _port(_osc_port, [[0.0, 1.0]], (0.0, 7.0), t_eval, OSC,
                    EventSpec(fn=lambda t, y: y[:, :1] - 0.5,
                              direction=(direction,)))
        ref = _jax(_osc_jax, [0.0, 1.0], (0.0, 7.0), t_eval, OSC,
                   JEventSpec(fn=lambda t, y: jnp.array([y[0] - 0.5]),
                              direction=(direction,)))
        _assert_events_equal(got, ref)
        assert int(got.event_count[0, 0]) == len(roots)
        np.testing.assert_allclose(got.event_t[0, 0, :len(roots)].numpy(),
                                   roots, rtol=0, atol=1e-6)


def test_multiple_occurrences_and_capacity():
    t_eval = np.linspace(0.0, 20.0, 5)
    got = _port(_osc_port, [[0.0, 1.0]], (0.0, 20.0), t_eval, OSC,
                EventSpec(fn=lambda t, y: y[:, :1] - 0.5, capacity=4))
    ref = _jax(_osc_jax, [0.0, 1.0], (0.0, 20.0), t_eval, OSC,
               JEventSpec(fn=lambda t, y: jnp.array([y[0] - 0.5]),
                          capacity=4))
    _assert_events_equal(got, ref)
    assert int(got.event_count[0, 0]) == 7   # counted past the capacity
    np.testing.assert_allclose(got.event_t[0, 0].numpy(),
                               np.pi / 6 * np.array([1, 5, 13, 17]),
                               rtol=0, atol=1e-5)


def test_two_events_terminal_discards_later():
    k = 0.7
    t_eval = np.linspace(0.0, 5.0, 11)
    got = _port(_decay(k), [[1.0]], (0.0, 5.0), t_eval, CFG,
                EventSpec(fn=lambda t, y: torch.cat(
                    [y[:, :1] - 0.6, y[:, :1] - 0.5, y[:, :1] - 0.4], 1),
                    terminal=(False, True, False)))
    ref = _jax(_decay(k), [1.0], (0.0, 5.0), t_eval, CFG,
               JEventSpec(fn=lambda t, y: jnp.array(
                   [y[0] - 0.6, y[0] - 0.5, y[0] - 0.4]),
                   terminal=(False, True, False)))
    _assert_events_equal(got, ref)
    assert int(got.status[0]) == STATUS_EVENT
    assert abs(float(got.t_final[0]) - np.log(2.0) / k) < 1e-6
    assert got.event_count[0].tolist() == [1, 1, 0]
    assert abs(float(got.event_t[0, 0, 0]) - np.log(1 / 0.6) / k) < 1e-6


def test_batched_heterogeneous_thresholds():
    """Each member its own terminal threshold, closed over as (B, 1): the
    port's batch against the JAX ``vmap`` and the exact roots."""
    k = 0.7
    t_eval = np.linspace(0.0, 5.0, 5)
    c = np.array([0.2, 0.35, 0.5, 0.65])
    ct = torch.as_tensor(c)[:, None]
    got = _port(_decay(k), np.ones((4, 1)), (0.0, 5.0), t_eval, CFG,
                EventSpec(fn=lambda t, y: y[:, :1] - ct, terminal=(True,)))

    def one(ci):
        return jbdf_solve(_decay(k), (0.0, 5.0), jnp.ones(1),
                          jnp.asarray(t_eval), config=JSolverConfig(**CFG),
                          events=JEventSpec(
                              fn=lambda t, y: jnp.array([y[0] - ci]),
                              terminal=(True,)))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(c)))
    for i in range(4):
        _assert_events_equal(got, jax.tree.map(lambda a: a[i], ref), i)
    assert got.status.tolist() == [STATUS_EVENT] * 4
    np.testing.assert_allclose(got.event_t[:, 0, 0].numpy(),
                               np.log(1.0 / c) / k, rtol=0, atol=1e-6)


def test_no_event_within_span():
    t_eval = np.linspace(0.0, 1.0, 3)
    got = _port(_decay(2.0), [[1.0]], (0.0, 1.0), t_eval, CFG,
                EventSpec(fn=lambda t, y: y[:, :1] - 2.0))
    assert int(got.status[0]) == STATUS_DONE
    assert int(got.event_count[0, 0]) == 0
    assert np.isinf(got.event_t.numpy()).all()


def test_model_simulate_events_kwarg():
    """``OdeModel.simulate(events=...)``: the product P of MM-3 rises
    through 0.1 once; the JAX model's run gives the same buffers."""
    p = np.array([2.0, 1.0, 1.5, 1.0])
    t_eval = np.linspace(0.0, 10.0, 5)
    got = library.michaelis_menten(device="cpu").simulate(
        p[None], (0.0, 10.0), t_eval, config=SolverConfig(**CFG),
        events=EventSpec(fn=lambda t, y: y[:, -1:] - 0.1), device="cpu")
    jm = jlibrary.michaelis_menten()
    ref = jax.tree.map(np.asarray, jax.jit(lambda pp: jm.simulate(
        pp, (0.0, 10.0), jnp.asarray(t_eval), config=JSolverConfig(**CFG),
        events=JEventSpec(fn=lambda t, y: jnp.array([y[-1] - 0.1]))))(
        jnp.asarray(p)))
    _assert_events_equal(got, ref)
    assert int(got.event_count[0, 0]) >= 1


def test_terminal_step_fill_matches_scipy():
    """y' = 1, y(0) = 0, terminal at y = 0.75 (rtol=1e-8): every filled
    ``t_eval`` point, those of the terminal step among them, equals SciPy's
    dense output to 1e-6; the reference's fill of the terminal step is
    off by the step's overshoot past the event."""
    t_eval = np.linspace(0.0, 1.0, 21)
    got = _port(lambda t, y: torch.ones_like(y), [[0.0]], (0.0, 1.0),
                t_eval, CFG, EventSpec(fn=lambda t, y: y[:, :1] - 0.75,
                                       terminal=(True,)))
    assert int(got.status[0]) == STATUS_EVENT
    t_end = float(got.t_final[0])
    assert abs(t_end - 0.75) < 1e-6
    ev = lambda t, y: y[0] - 0.75  # noqa: E731
    ev.terminal = True
    sp = solve_ivp(lambda t, y: np.ones_like(y), (0.0, 1.0), [0.0],
                   method="BDF", rtol=1e-8, atol=1e-10, events=ev,
                   dense_output=True)
    assert abs(t_end - sp.t_events[0][0]) < 1e-6
    filled = t_eval <= t_end
    ys = got.ys[0, :, 0].numpy()
    np.testing.assert_allclose(ys[filled], sp.sol(t_eval[filled])[0],
                               rtol=0, atol=1e-6)
    assert np.all(ys[~filled] == 0.0)
    ref = _jax(lambda t, y: jnp.ones_like(y), [0.0], (0.0, 1.0), t_eval,
               CFG, JEventSpec(fn=lambda t, y: jnp.array([y[0] - 0.75]),
                               terminal=(True,)))
    # the same event and stop as the reference; only the fill differs
    _assert_events_equal(got, ref)
    assert np.max(np.abs(ref.ys[filled, 0] - t_eval[filled])) > 1e-3
