"""The f32 screening stepper (``mixed_precision=True``) and per-member
time grids against the JAX reference.

MAPK-22 at the screening configuration of the two-phase fit (rtol=1e-3,
atol=1e-6, max_steps=192, ``linear_solver='pallas'``), with the 12
θ-direction sensitivity columns of the headline problem, at B=4. The
reference runs ``jax.jit(jax.vmap(integrate))`` with its Pallas kernel in
interpret mode; the port runs its batched ``bdf_solve`` on the CPU, where
the kernel wrappers take their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import solvers as jsolvers
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import (STATUS_DONE, STATUS_MAX_STEPS,
                                     bdf_solve)

torch.set_num_threads(1)

B = 4
G = 12
T_SPAN = (0.0, 100.0)
T_EVAL = np.linspace(5.0, 100.0, 12)
SCREEN_KW = dict(rtol=1e-3, atol=1e-6, max_steps=192,
                 linear_solver="pallas", mixed_precision=True)


def _params_and_directions():
    """Four parameter sets around the true rates and their (30, 12) chain
    ``dp/dθ`` over the 12 free MAPK-layer rate constants."""
    jmodel = jlibrary.mapk_huang_ferrell()
    p_true = np.asarray(jlibrary.mapk_true_params())
    free = [i for i, n in enumerate(jmodel.param_names)
            if n.startswith(("KKPP+K", "KPase+KP"))]
    assert len(free) == G
    rng = np.random.default_rng(7)
    ps = p_true[None, :] * np.exp(rng.normal(scale=0.3, size=(B, 30)))
    C = np.zeros((B, 30, G))
    for g, i in enumerate(free):
        C[:, i, g] = ps[:, i]
    return ps, C


def _port_solve(ps, C, t_span, t_eval, cfg):
    model = library.mapk_huang_ferrell(device="cpu")
    p = torch.as_tensor(ps)
    Ct = torch.as_tensor(C)
    return bdf_solve(
        lambda t, y: model.rhs(t, y, p.to(y.dtype)), t_span, model.y0(p),
        t_eval, config=cfg,
        sens_rhs=lambda t, y, S: model.rhs_sens_dir(t, y, S, p, Ct),
        s0=torch.zeros((ps.shape[0], 22, G), dtype=torch.float64),
        jac=lambda t, y: model.rhs_jac(t, y, p.to(y.dtype)))


T_SHORT = 2.0


@pytest.fixture(scope="module")
def reference():
    """The reference's vmapped integrate, compiled once; the horizon is a
    traced argument and the output grid scales with it."""
    model = jlibrary.mapk_huang_ferrell()
    cfg = JSolverConfig(**SCREEN_KW)

    def integrate(p, C, t_end):
        res = jsolvers.bdf_solve(
            lambda t, y: model.rhs(t, y, p.astype(y.dtype)), (0.0, t_end),
            model.y0(p), jnp.asarray(T_EVAL / T_SPAN[1]) * t_end,
            config=cfg,
            sens_rhs=lambda t, y, S: model.rhs_sens_dir(t, y, S, p, C),
            s0=jnp.zeros((22, G), p.dtype),
            jac=lambda t, y: model.rhs_jac(t, y, p.astype(y.dtype)))
        return res._replace(order_hist=None, t_final=None, y_final=None)

    ps, C = _params_and_directions()
    fn = jax.jit(jax.vmap(integrate, in_axes=(0, 0, None)))
    return lambda t_end: jax.tree.map(
        np.asarray, fn(jnp.asarray(ps), jnp.asarray(C), jnp.asarray(t_end)))


@pytest.fixture(scope="module")
def reference_full(reference):
    return reference(T_SPAN[1])


@pytest.fixture(scope="module")
def port():
    ps, C = _params_and_directions()
    return _port_solve(ps, C, T_SPAN, T_EVAL, SolverConfig(**SCREEN_KW))


COUNTERS = ["status", "nsteps", "naccepted", "nrejected", "nlu", "nfev",
            "njev"]


@pytest.mark.parametrize("counter", COUNTERS)
def test_mixed_step_counters_identical(reference, counter):
    """Over the start-up phase (order 1 to 3, a dozen steps with their
    step-size and order changes) the f32 hot loop with f64 step control
    takes the reference's step sequence member by member: every cast sits
    where the reference has it. Beyond it f32 rounding decides (see
    ``test_mixed_full_horizon_counters_close``)."""
    ps, C = _params_and_directions()
    ref = reference(T_SHORT)
    res = _port_solve(ps, C, (0.0, T_SHORT), T_EVAL / T_SPAN[1] * T_SHORT,
                      SolverConfig(**SCREEN_KW))
    assert res.status.tolist() == [STATUS_DONE] * B
    assert int(res.nsteps.min()) >= 10
    np.testing.assert_array_equal(getattr(res, counter).numpy(),
                                  getattr(ref, counter))
    ys, yref = res.ys.numpy(), ref.ys
    assert np.max(np.abs(ys - yref)) / np.max(np.abs(yref)) <= 1e-6


@pytest.mark.parametrize("counter", ["nsteps", "naccepted", "nrejected",
                                     "nlu"])
def test_mixed_full_horizon_counters_close(reference_full, port, counter):
    """Over the whole horizon (~90 steps) the error estimate is a
    difference of f32 quantities, so its roundings (which XLA's fused
    loops and PyTorch's separate ops place differently) move the step size
    at the 1e-5 level and now and then flip an accept/reject or order
    decision. The reference's own eager and jitted runs differ by a step
    for that reason. The counters agree to a few steps, not exactly."""
    got = getattr(port, counter).numpy().astype(int)
    ref = getattr(reference_full, counter).astype(int)
    assert port.status.tolist() == [STATUS_DONE] * B
    np.testing.assert_array_equal(reference_full.status, [STATUS_DONE] * B)
    assert np.all(np.abs(got - ref) <= 5), (got, ref)


def test_mixed_outputs_are_f32_and_agree(reference_full, port):
    """Both sides store the whole column block in f32 and integrate to
    rtol=1e-3 along slightly different step sequences: the trajectories
    agree well inside that tolerance, not to rounding."""
    reference = reference_full
    assert port.ys.dtype == torch.float32 == port.sens.dtype
    assert reference.ys.dtype == np.float32
    ys, ref = port.ys.numpy(), reference.ys
    assert ys.shape == ref.shape == (B, 12, 22)
    assert np.max(np.abs(ys - ref)) / np.max(np.abs(ref)) <= 5e-4
    sens, sref = port.sens.numpy(), reference.sens
    assert sens.shape == sref.shape == (B, 12, 22, G)
    assert np.max(np.abs(sens - sref)) / np.max(np.abs(sref)) <= 5e-3


def test_mixed_absurd_member_fails_alone(port):
    """A member whose rates are e^40 too large exhausts its step budget (or
    breaks down) without touching the others: their results are those of
    the batch without it, bit for bit."""
    ps, C = _params_and_directions()
    bad = ps.copy()
    bad[1] = ps[1] * np.exp(40.0)
    res = _port_solve(bad, C, T_SPAN, T_EVAL, SolverConfig(**SCREEN_KW))
    assert int(res.status[1]) != STATUS_DONE
    keep = [0, 2, 3]
    assert res.status[keep].tolist() == [STATUS_DONE] * 3
    np.testing.assert_array_equal(res.nsteps[keep].numpy(),
                                  port.nsteps[keep].numpy())
    np.testing.assert_array_equal(res.ys[keep].numpy(),
                                  port.ys[keep].numpy())
    np.testing.assert_array_equal(res.sens[keep].numpy(),
                                  port.sens[keep].numpy())


def test_step_budget_flags_max_steps():
    ps, C = _params_and_directions()
    cfg = SolverConfig(**{**SCREEN_KW, "max_steps": 10})
    res = _port_solve(ps[:2], C[:2], T_SPAN, T_EVAL, cfg)
    assert res.status.tolist() == [STATUS_MAX_STEPS] * 2
    assert res.nsteps.tolist() == [10, 10]


@pytest.mark.parametrize("mixed", [True, False])
def test_per_member_horizons_match_separate_calls(mixed):
    """Two horizons and two grids in one batch (the shorter grid padded by
    repeating its last time, as ``ExperimentBatch`` pads) give, bit for
    bit, what two separate calls give, each with one shared horizon. The
    separate calls keep the batch at two members: PyTorch's CPU matmuls
    round differently at another batch size."""
    ps, C = _params_and_directions()
    kw = SCREEN_KW if mixed else dict(rtol=1e-6, atol=1e-9, max_steps=512,
                                      linear_solver="pallas",
                                      sens_precision="f32", dense_f32=True)
    cfg = SolverConfig(**kw)
    grid_a = np.linspace(0.0, 40.0, 6)          # starts AT t0: the prefill
    grid_b = np.concatenate([np.linspace(2.0, 9.0, 4), [9.0, 9.0]])
    t0 = torch.tensor([0.0, 1.0], dtype=torch.float64)
    t1 = torch.tensor([40.0, 9.0], dtype=torch.float64)
    both = _port_solve(ps[:2], C[:2], (t0, t1),
                       torch.as_tensor(np.stack([grid_a, grid_b])), cfg)
    run_a = _port_solve(ps[:2], C[:2], (0.0, 40.0), grid_a, cfg)
    run_b = _port_solve(ps[:2], C[:2], (1.0, 9.0), grid_b, cfg)
    assert both.status.tolist() == [STATUS_DONE] * 2
    for i, one in enumerate((run_a, run_b)):
        assert int(both.nsteps[i]) == int(one.nsteps[i])
        np.testing.assert_array_equal(both.ys[i].numpy(), one.ys[i].numpy())
        np.testing.assert_array_equal(both.sens[i].numpy(),
                                      one.sens[i].numpy())
    # the prefill at t0 is per member: member 0's grid starts at its t0
    # and reads y0 there, member 1's starts later and reads the solution
    model = library.mapk_huang_ferrell(device="cpu")
    y0 = model.y0(torch.as_tensor(ps[:2]))
    np.testing.assert_array_equal(both.ys[0, 0].numpy(),
                                  y0[0].to(both.ys.dtype).numpy())
    assert not np.array_equal(both.ys[1, 0].numpy(),
                              y0[1].to(both.ys.dtype).numpy())


def test_bad_time_shapes_raise():
    ps, C = _params_and_directions()
    cfg = SolverConfig(**SCREEN_KW)
    with pytest.raises(ValueError, match="t_span"):
        _port_solve(ps[:2], C[:2], (torch.zeros(3), 1.0), T_EVAL, cfg)
    with pytest.raises(ValueError, match="t_eval"):
        _port_solve(ps[:2], C[:2], T_SPAN, np.zeros((3, 4)), cfg)
