"""The port's explicit steppers (dopri5, Adams) and ``auto`` against the
JAX package's.

Inputs are numpy arrays from a seed; the JAX side is ``jax.jit(jax.vmap(
...))``, the port's side one batched call on the CPU.

- dopri5 and Adams on Lotka–Volterra and the repressilator with full jvp
  sensitivities (the ensembles of bench/experiments/
  adams_ensemble_bench.py at B=2): step counters equal member by member,
  ``ys`` and ``sens`` to 1e-9 relative to their largest value;
- the ``STATUS_STIFF`` abort of each explicit stepper on the
  non-stiff→stiff transition problem of tests/test_auto.py: the same
  status, counters and handoff point (``t_final`` to 1e-9);
- ``auto`` (both explicit halves) on that problem: counters equal to the
  JAX package's and the trajectory within 1e-4 of SciPy's BDF at
  rtol=1e-9 (tests/test_auto.py's bound); a mixed batch of a mild and a
  stiff MM-3 member: statuses and counters equal to the JAX ``vmap``'s;
  a non-stiff batch never factors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from tpusysbio import solvers as jsolvers
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.sens import make_sens_rhs as jmake_sens_rhs
from tpusysbio_torch import SolverConfig
from tpusysbio_torch import solvers
from tpusysbio_torch.model import library
from tpusysbio_torch.sens import make_sens_rhs
from tpusysbio_torch.solvers import STATUS_DONE, STATUS_STIFF

torch.set_num_threads(1)

COUNTERS = ("status", "nsteps", "naccepted", "nrejected", "nfev", "njev",
            "nlu")


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _assert_counters_equal(got, ref, names=COUNTERS):
    for c in names:
        np.testing.assert_array_equal(getattr(got, c).numpy(),
                                      np.asarray(getattr(ref, c)), err_msg=c)


MODELS = {"lotka": ("lotka_volterra", "LV_TRUE_PARAMS", 15.0),
          "repressilator": ("repressilator", "REPRESSILATOR_TRUE_PARAMS",
                            40.0)}


@pytest.mark.parametrize("solver", ["dopri5", "adams"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_sensitivities_match_reference(solver, name):
    build, true_p, t_end = MODELS[name]
    jm = getattr(jlibrary, build)()
    tm = getattr(library, build)(device="cpu")
    rng = np.random.default_rng(0)
    p_true = np.asarray(getattr(jlibrary, true_p))
    ps = p_true[None] * np.exp(rng.normal(scale=0.1, size=(2, len(p_true))))
    t_eval = np.linspace(0.0, t_end, 21)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=16384)
    n, m = jm.n_states, jm.n_params

    def one(p):
        return jsolvers.SOLVERS[solver](
            lambda t, y: jm.rhs(t, y, p), (0.0, t_end), jm.y0(p),
            jnp.asarray(t_eval), config=JSolverConfig(**kw),
            sens_rhs=jmake_sens_rhs(jm.rhs, p), s0=jnp.zeros((n, m)))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ps)))
    p = torch.as_tensor(ps)
    got = solvers.SOLVERS[solver](
        lambda t, y: tm.rhs(t, y, p), (0.0, t_end), tm.y0(p),
        torch.as_tensor(t_eval), config=SolverConfig(**kw),
        sens_rhs=make_sens_rhs(tm.rhs, p),
        s0=torch.zeros((2, n, m), dtype=torch.float64))
    _assert_counters_equal(got, ref)
    np.testing.assert_array_equal(got.order_hist.numpy(), ref.order_hist)
    assert got.status.tolist() == [STATUS_DONE] * 2
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9
    assert _rel(got.sens.numpy(), ref.sens) <= 1e-9


def _transition_jax(t, y, lam_hi=1e4):
    lam = 1.0 + lam_hi * jax.nn.sigmoid((t - 5.0) * 4.0)
    return jnp.stack([-lam * (y[0] - jnp.cos(t)) - jnp.sin(t)])


def _transition_port(lam_hi):
    """The batched transition RHS with a per-member stiffness ``lam_hi``
    (B,)."""
    def rhs(t, y):
        lam = 1.0 + lam_hi * torch.sigmoid((t - 5.0) * 4.0)
        return (-lam * (y[:, 0] - torch.cos(t)) - torch.sin(t))[:, None]
    return rhs


T_EVAL = np.linspace(0.0, 10.0, 21)
TRANSITION_CFG = dict(rtol=1e-6, atol=1e-9, max_steps=2048)


@pytest.mark.parametrize("solver", ["dopri5", "adams"])
def test_stiff_exit_matches_reference(solver):
    """The abort at budget 256: one member stiff after t=5, one mild
    member (λ ramps to 1 only) that finishes."""
    lam = np.array([1e4, 1.0])
    cfg = dict(TRANSITION_CFG, max_steps=256)

    def one(lam_hi):
        return jsolvers.SOLVERS[solver](
            lambda t, y: _transition_jax(t, y, lam_hi), (0.0, 10.0),
            jnp.asarray([1.5]), jnp.asarray(T_EVAL),
            config=JSolverConfig(**cfg), stiff_exit=True)

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(lam)))
    got = solvers.SOLVERS[solver](
        _transition_port(torch.as_tensor(lam)), (0.0, 10.0),
        torch.full((2, 1), 1.5, dtype=torch.float64),
        torch.as_tensor(T_EVAL), config=SolverConfig(**cfg),
        stiff_exit=True)
    assert got.status.tolist() == [STATUS_STIFF, STATUS_DONE]
    _assert_counters_equal(got, ref, COUNTERS[:5])
    np.testing.assert_allclose(got.t_final.numpy(), ref.t_final, rtol=1e-9)
    assert 0.0 < float(got.t_final[0]) < 10.0
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9


def _scipy_transition():
    ref = solve_ivp(
        lambda t, y: np.asarray(_transition_jax(t, jnp.asarray(y))),
        (0.0, 10.0), [1.5], method="BDF", rtol=1e-9, atol=1e-12,
        t_eval=T_EVAL)
    assert ref.success
    return ref.y[0]


@pytest.mark.parametrize("explicit", ["rk45", "adams"])
def test_auto_transition_handoff(explicit):
    lam = np.array([1e4, 1e4])

    def one(lam_hi):
        return jsolvers.auto_solve(
            lambda t, y: _transition_jax(t, y, lam_hi), (0.0, 10.0),
            jnp.asarray([1.5]), jnp.asarray(T_EVAL),
            config=JSolverConfig(**TRANSITION_CFG), nonstiff_budget=256,
            explicit=explicit)

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(lam)))
    got = solvers.auto_solve(
        _transition_port(torch.as_tensor(lam)), (0.0, 10.0),
        torch.full((2, 1), 1.5, dtype=torch.float64),
        torch.as_tensor(T_EVAL), config=SolverConfig(**TRANSITION_CFG),
        nonstiff_budget=256, explicit=explicit)
    assert got.status.tolist() == [STATUS_DONE] * 2
    _assert_counters_equal(got, ref)
    assert int(got.njev[0]) > 0   # the BDF half ran
    assert np.max(np.abs(got.ys[0, :, 0].numpy() - _scipy_transition())) \
        < 1e-4
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9


def test_auto_mixed_stiffness_batch():
    """A mild and a stiff MM-3 member (k1 × 2e4) in one batch at a
    nonstiff budget of 128: statuses and counters equal the JAX
    ``vmap``'s member by member, and the stiff member takes the most
    factorizations."""
    p_mild = np.asarray(jlibrary.MM_TRUE_PARAMS)
    p_stiff = p_mild.copy()
    p_stiff[0] *= 2e4
    ps = np.stack([p_mild, p_stiff])
    t_eval = np.linspace(0.0, 10.0, 6)
    cfg = dict(rtol=1e-6, atol=1e-9, max_steps=2048)
    jm = jlibrary.michaelis_menten()

    def one(p):
        return jsolvers.auto_solve(
            lambda t, y: jm.rhs(t, y, p), (0.0, 10.0), jm.y0(p),
            jnp.asarray(t_eval), config=JSolverConfig(**cfg),
            nonstiff_budget=128)

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ps)))
    tm = library.michaelis_menten(device="cpu")
    p = torch.as_tensor(ps)
    got = solvers.auto_solve(
        lambda t, y: tm.rhs(t, y, p), (0.0, 10.0), tm.y0(p),
        torch.as_tensor(t_eval), config=SolverConfig(**cfg),
        nonstiff_budget=128)
    assert got.status.tolist() == [STATUS_DONE] * 2
    _assert_counters_equal(got, ref)
    np.testing.assert_array_equal(got.order_hist.numpy(), ref.order_hist)
    assert int(got.nlu[1]) > int(got.nlu[0])
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9


def test_auto_nonstiff_stays_explicit():
    tm = library.michaelis_menten(device="cpu")
    p = np.asarray(jlibrary.MM_TRUE_PARAMS)[None]
    res = tm.simulate(p, (0.0, 10.0), np.linspace(0.0, 10.0, 6),
                      solver="auto", config=SolverConfig(rtol=1e-6,
                                                         atol=1e-9),
                      device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    assert int(res.njev[0]) == 0 and int(res.nlu[0]) == 0


def test_golden_mm3_dopri5(golden):
    """tests/test_solvers.py's dopri5 MM-3 bound."""
    g = golden("mm3")
    res = library.michaelis_menten(device="cpu").simulate(
        g["p"][None], tuple(g["t_span"]), g["t_eval"], solver="dopri5",
        config=SolverConfig(rtol=1e-6, atol=1e-9), device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    ys = res.ys[0].numpy()
    assert np.max(np.abs(ys - g["ys"]) / (1e-7 + np.abs(g["ys"]))) < 3e-4
