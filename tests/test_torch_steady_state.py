"""The port's batched steady-state solve (damped Newton + implicit-function-
theorem sensitivities) against the JAX reference's.

The two problems of ``tests/test_steady_state.py`` — a linear two-state
decay chain and Michaelis-Menten with inflow — each as one batch of three
members with their own parameters (numpy, seed 0). The reference solves
member by member under ``jax.vmap``. The Michaelis-Menten batch holds one
member whose inflow exceeds the maximal rate (no equilibrium): it does not
converge, and the other members' results are those of the batch without
it, bit for bit.

Tolerances: y* 1e-10 relative, IFT sensitivities 1e-8; Newton trip counts
and the converged flags equal per member. The Newton residual is scaled by
``atol + rtol·|y|``; at the default rtol=1e-6 a linear problem lands, after
its one exact Newton step, at the f64 rounding floor (~1e-10), right on the
stop test ``r < 1e-10``, so whether a second trip is taken is decided by
rounding. At rtol=1e-4 the floor is ~100 times below it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.solvers.steady_state import steady_state as jsteady_state
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.solvers import SteadyStateResult, steady_state

torch.set_num_threads(1)

CFG = dict(rtol=1e-4, atol=1e-8)


def _decay_jax(t, y, p):
    return jnp.stack([p[0] - p[1] * y[0], p[2] * y[0] - p[3] * y[1]])


def _decay_port(t, y, p):
    return torch.stack([p[:, 0] - p[:, 1] * y[:, 0],
                        p[:, 2] * y[:, 0] - p[:, 3] * y[:, 1]], dim=-1)


def _mm_jax(t, y, p):
    return jnp.stack([p[0] - p[1] * y[0] / (p[2] + y[0])])


def _mm_port(t, y, p):
    return (p[:, 0] - p[:, 1] * y[:, 0] / (p[:, 2] + y[:, 0]))[:, None]


def _inputs(name):
    rng = np.random.default_rng(0)
    if name == "decay":
        p = np.array([2.0, 0.5, 1.0, 0.25]) * np.exp(
            rng.uniform(-0.3, 0.3, (3, 4)))
        return p, np.full((3, 2), 0.1), 5.0
    p = np.array([0.3, 1.0, 0.5]) * np.exp(rng.uniform(-0.3, 0.3, (3, 3)))
    p[2] = [1.5, 1.0, 0.5]    # inflow above the maximal rate: no y*
    return p, np.full((3, 1), 0.01), 20.0


PROBLEMS = {"decay": (_decay_jax, _decay_port),
            "mm_inflow": (_mm_jax, _mm_port)}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def solved(request):
    name = request.param
    rhs_j, rhs_p = PROBLEMS[name]
    p, y0, t_relax = _inputs(name)
    ref = jax.jit(jax.vmap(lambda pp, yy: jsteady_state(
        rhs_j, pp, yy, config=JSolverConfig(**CFG), t_relax=t_relax,
        with_sens=True)))(
            jnp.asarray(p), jnp.asarray(y0))
    got = steady_state(rhs_p, torch.as_tensor(p), torch.as_tensor(y0),
                       config=SolverConfig(**CFG), t_relax=t_relax,
                       with_sens=True)
    return name, p, y0, t_relax, jax.tree.map(np.asarray, ref), got


def test_result_fields_and_shapes(solved):
    name, p, y0, _, _, got = solved
    assert isinstance(got, SteadyStateResult)
    assert tuple(got.y.shape) == y0.shape
    assert tuple(got.sens.shape) == y0.shape + (p.shape[1],)
    assert tuple(got.converged.shape) == tuple(got.n_newton.shape) == (3,)
    assert got.n_newton.dtype == torch.int32


def test_converged_and_newton_trips_equal(solved):
    name, _, _, _, ref, got = solved
    np.testing.assert_array_equal(got.converged.numpy(), ref.converged)
    np.testing.assert_array_equal(got.n_newton.numpy(), ref.n_newton)
    want = [True, True, name == "decay"]
    assert got.converged.tolist() == want


def test_steady_states_agree(solved):
    _, _, _, _, ref, got = solved
    ok = ref.converged
    np.testing.assert_allclose(got.y.numpy()[ok], ref.y[ok], rtol=1e-10)
    assert (got.residual_norm.numpy()[ok] < 1e-9).all()


def test_ift_sensitivities_agree(solved):
    _, _, _, _, ref, got = solved
    ok = ref.converged
    s, sr = got.sens.numpy()[ok], ref.sens[ok]
    assert np.max(np.abs(s - sr)) / np.max(np.abs(sr)) <= 1e-8


def test_decay_analytic():
    """y* = (p0/p1, p2 p0/(p1 p3)) and its analytic dy*/dp, per member."""
    p, y0, t_relax = _inputs("decay")
    got = steady_state(_decay_port, torch.as_tensor(p), torch.as_tensor(y0),
                       config=SolverConfig(**CFG), t_relax=t_relax,
                       with_sens=True)
    p0, p1, p2, p3 = p.T
    np.testing.assert_allclose(got.y.numpy(), np.stack(
        [p0 / p1, p2 * p0 / (p3 * p1)], 1), rtol=1e-9)
    z = np.zeros_like(p0)
    expected = np.stack([
        np.stack([1 / p1, -p0 / p1**2, z, z], 1),
        np.stack([p2 / (p3 * p1), -p2 * p0 / (p3 * p1**2), p0 / (p1 * p3),
                  -p2 * p0 / (p1 * p3**2)], 1)], 1)
    np.testing.assert_allclose(got.sens.numpy(), expected, rtol=1e-8,
                               atol=1e-12)


def test_frozen_member_leaves_the_others_alone():
    """The member without an equilibrium freezes when no damped step
    improves its residual; the two others take their own trips and
    results, bit for bit those of a batch whose third member converges
    (the same batch size: PyTorch's CPU matmuls round per member alike
    only at equal batch sizes)."""
    p, y0, t_relax = _inputs("mm_inflow")
    got = steady_state(_mm_port, torch.as_tensor(p), torch.as_tensor(y0),
                       config=SolverConfig(**CFG), t_relax=t_relax,
                       with_sens=True)
    assert got.converged.tolist() == [True, True, False]
    good = p.copy()
    good[2] = p[1]
    alone = steady_state(_mm_port, torch.as_tensor(good),
                         torch.as_tensor(y0), config=SolverConfig(**CFG),
                         t_relax=t_relax, with_sens=True)
    assert bool(alone.converged.all())
    for field in ("y", "sens", "residual_norm", "converged", "n_newton"):
        np.testing.assert_array_equal(getattr(got, field)[:2].numpy(),
                                      getattr(alone, field)[:2].numpy(),
                                      field)


def test_skip_relaxation_and_closed_form_jacobian():
    """``t_relax=0`` starts Newton at y0; a closed-form ``jac_fn`` gives
    what forward-mode AD gives."""
    p, y0, _ = _inputs("decay")

    def jac(t, y, pp):
        z = torch.zeros_like(pp[:, 0])
        return torch.stack([torch.stack([-pp[:, 1], z], -1),
                            torch.stack([pp[:, 2], -pp[:, 3]], -1)], 1)

    pt, yt = torch.as_tensor(p), torch.as_tensor(y0)
    a = steady_state(_decay_port, pt, yt, config=SolverConfig(**CFG), t_relax=0.0,
                     with_sens=True)
    b = steady_state(_decay_port, pt, yt, config=SolverConfig(**CFG), t_relax=0.0,
                     with_sens=True,
                     jac_fn=jac)
    assert a.converged.all() and b.converged.all()
    np.testing.assert_allclose(a.y.numpy(), b.y.numpy(), rtol=1e-12)
    np.testing.assert_allclose(a.sens.numpy(), b.sens.numpy(), rtol=1e-12)
    no_sens = steady_state(_decay_port, pt, yt,
                           config=SolverConfig(**CFG), t_relax=0.0)
    assert not no_sens.sens.any()
