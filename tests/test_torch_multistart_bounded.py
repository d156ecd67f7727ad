"""The port's bounded multi-start (``multistart_trf``, the bounded polish
of ``TwoPhaseDriver``) and the single-device knobs ``compact=`` and
``presort_fn=``, against the port's own unchunked runs and the
reference's ``multistart_trf``.

Rosenbrock residuals are elementwise, so every member's arithmetic is
the same at any batch size and the comparisons are bitwise. A ``Project``
goes through batched matmuls, whose CPU rounding depends on the batch size
(ROADMAP Queue 3), so a compacted ``Project`` run is held to 1e-8.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import cli as jcli
from tpusysbio.config import FitConfig as JFitConfig
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.fit import multistart as jms
from tpusysbio.project import Project as JProject
from tpusysbio_torch import FitConfig, SolverConfig, cli
from tpusysbio_torch.fit import (TwoPhaseDriver, make_multistart_runner,
                                 multistart_trf, multistart_two_phase)
from tpusysbio_torch.project import Project

torch.set_num_threads(1)

LB = np.array([-2.0, -2.0])
UB = np.array([0.8, 2.0])      # the optimum (1, 1) lies outside


def ros_r(th):
    return torch.stack([10.0 * (th[:, 1] - th[:, 0] ** 2), 1.0 - th[:, 0]],
                       dim=1)


def ros_rj(th):
    z = torch.zeros_like(th[:, 0])
    J = torch.stack([torch.stack([-20.0 * th[:, 0], z + 10.0], dim=1),
                     torch.stack([z - 1.0, z], dim=1)], dim=1)
    return ros_r(th), J


def jros_r(th):
    return jnp.stack([10.0 * (th[1] - th[0] ** 2), 1.0 - th[0]])


def jros_rj(th):
    import jax

    return jros_r(th), jax.jacfwd(jros_r)(th)


def _starts(n, seed):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, size=(n, 2))


def _assert_same(a, b, fields=("theta", "cost", "grad_norm", "status",
                                "n_iter", "theta0", "cov", "param_sigma",
                                "cost_trace")):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), f


def test_multistart_trf_iter_chunk_equals_plain_and_reference():
    """After tests/test_fit.py's iter-chunk test: chunks of 7 give the
    one-call result bit for bit, every member inside the box, and the
    reference's multistart_trf on the same starts (1e-10, equal
    statuses and iteration counts)."""
    starts = _starts(6, 5)
    cfg = FitConfig(max_iter=60)
    a = multistart_trf(ros_r, ros_rj, torch.as_tensor(starts), LB, UB, cfg)
    b = multistart_trf(ros_r, ros_rj, torch.as_tensor(starts), LB, UB, cfg,
                       iter_chunk=7)
    _assert_same(a, b)
    th = a.theta.numpy()
    assert np.all(th > LB) and np.all(th < UB)
    ref = jms.multistart_trf(jros_r, jros_rj, jnp.asarray(starts),
                             jnp.asarray(LB), jnp.asarray(UB),
                             JFitConfig(max_iter=60))
    for f in ("status", "n_iter"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    for f in ("theta", "cost", "param_sigma"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-10,
                                   atol=1e-10, err_msg=f)


def test_two_phase_bounded_polish():
    """After tests/test_fit.py's bounded-polish test, without the mesh: LM
    screen, bounded TRF polish under iter_chunk; the bounds hold, every
    polished member converges, and the ranked polish costs equal
    multistart_trf's on the same screened top_k (1e-10)."""
    starts = torch.as_tensor(_starts(16, 9))
    screen_cfg = FitConfig(max_iter=6, ftol=1e-3, xtol=1e-3)
    polish_cfg = FitConfig(max_iter=60)
    fns = (ros_r, ros_rj)
    driver = TwoPhaseDriver(fns, fns, screen_cfg, polish_cfg, top_k=8,
                            iter_chunk=5, polish_bounds=(LB, UB))
    polish, screen, _ = driver.run(starts)
    th = polish.theta.numpy()
    assert np.all(th > LB) and np.all(th < UB)
    assert bool((polish.status > 0).all())
    order = np.argsort(np.where(screen.status.numpy() < 0, np.inf,
                                screen.cost.numpy()), kind="stable")
    top = screen.theta[torch.as_tensor(order[:8])]
    ref = multistart_trf(*fns, top, LB, UB, polish_cfg)
    np.testing.assert_allclose(np.sort(polish.cost.numpy()),
                               np.sort(ref.cost.numpy()), rtol=1e-10)
    # the robust, SVD-subproblem polish reaches the same bounded optimum
    robust, _ = multistart_two_phase(
        fns, fns, starts, screen_cfg, polish_cfg, top_k=8,
        polish_bounds=(LB, UB), polish_subproblem="svd",
        polish_loss="soft_l1", polish_f_scale=10.0)
    assert bool((robust.status > 0).all())
    np.testing.assert_allclose(robust.theta.numpy()[:, 0], 0.8, atol=1e-6)


@pytest.mark.parametrize("bounded", [False, True])
def test_compact_equals_the_unchunked_run(bounded):
    """16 starts whose fits end at different iterations, in chunks of 2
    iterations: the live members are repacked into a batch of 8 (counted
    at the objective) and every result field equals the unchunked run's
    bit for bit, in the caller's order."""
    starts = torch.as_tensor(_starts(16, 3))
    cfg = FitConfig(max_iter=40)
    bounds = (LB, UB) if bounded else None
    sizes = []

    def r(th):
        sizes.append(th.shape[0])
        return ros_r(th)

    whole = make_multistart_runner(ros_r, ros_rj, cfg, bounds=bounds)(starts)
    packed = make_multistart_runner(r, ros_rj, cfg, iter_chunk=2,
                                    compact=True, bounds=bounds)(starts)
    assert 8 in sizes and 16 in sizes
    n_iter = whole.n_iter.numpy()
    assert n_iter.min() < n_iter.max()
    _assert_same(whole, packed)
    # compact acts under iter_chunk only, as in the reference
    plain = make_multistart_runner(ros_r, ros_rj, cfg, compact=True,
                                   bounds=bounds)(starts)
    _assert_same(whole, plain)


@pytest.fixture(scope="module")
def mm3():
    """The CLI's synthetic MM-3 problem (t_end 5, 6 times) with k2 and E0
    free, k1 and km1 fixed at truth (they are identified only together),
    in both packages: (port Project, JAX Project, θ_true)."""
    from tpusysbio.project import ParameterMap as JParameterMap
    from tpusysbio_torch.model import library
    from tpusysbio_torch.project import ParameterMap

    args = argparse.Namespace(model="mm3", t_end=5.0, n_times=6,
                              noise=0.02, seed=0)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=512, linear_solver="inv32",
              sens_precision="f32")
    p = library.MM_TRUE_PARAMS
    model, batch, _, _, _ = cli._synth_problem(args, torch.device("cpu"))
    names = list(model.param_names)
    free = ("k2", "E0")
    fixed = {n: p[names.index(n)] for n in names if n not in free}
    pmap = ParameterMap.create(names, 1, shared=free, fixed=fixed,
                               device="cpu")
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(**kw))
    jmodel, jbatch, _, _, _ = jcli._synth_problem(args)
    jpmap = JParameterMap.create(names, 1, shared=free, fixed=fixed)
    jproj = JProject(model=jmodel, pmap=jpmap, batch=jbatch,
                     config=JSolverConfig(**kw))
    theta = pmap.pack({n: p[names.index(n)] for n in free}).numpy()
    return proj, jproj, theta


def test_compact_on_a_project(mm3):
    """16 starts in chunks of 2 lockstep LM iterations: most fits end at
    5-6 iterations, so the two live members are repacked into a batch of
    8 (the repack floor), and every field is within 1e-8 of the unchunked
    run's (batched CPU matmuls round by batch size)."""
    proj, _, theta_true = mm3
    starts = torch.as_tensor(theta_true[None] + np.random.default_rng(2)
                             .uniform(-1.0, 1.0, (16, 2)))
    cfg = FitConfig(max_iter=8, eval_mode="lockstep")
    sizes = []

    def rj(th):
        sizes.append(th.shape[0])
        return proj.residuals_and_jacobian(th)

    whole = make_multistart_runner(proj.residuals,
                                   proj.residuals_and_jacobian, cfg)(starts)
    packed = make_multistart_runner(proj.residuals, rj, cfg, iter_chunk=2,
                                    compact=True)(starts)
    assert 8 in sizes
    np.testing.assert_array_equal(packed.status.numpy(),
                                  whole.status.numpy())
    np.testing.assert_array_equal(packed.n_iter.numpy(),
                                  whole.n_iter.numpy())
    for f in ("theta", "cost", "param_sigma", "cost_trace"):
        np.testing.assert_allclose(getattr(packed, f).numpy(),
                                   getattr(whole, f).numpy(), rtol=1e-8,
                                   atol=1e-12, err_msg=f)


def test_presorted_screen_matches_unsorted():
    """After tests/test_fit.py's presort test: the starts screened in
    chunks sorted by their initial cost (N=10, chunks of 4: two pads,
    clones of the last sorted start) give the unsorted screen field for
    field, in the caller's order, and the same best polished fit."""
    starts = torch.as_tensor(_starts(10, 11))
    screen_cfg = FitConfig(max_iter=6, ftol=1e-3, xtol=1e-3)
    polish_cfg = FitConfig(max_iter=100)
    fns = (ros_r, ros_rj)
    calls = []

    def presort(th):
        calls.append(th.shape[0])
        return 0.5 * torch.sum(ros_r(th) ** 2, dim=1)

    keys = presort(starts).numpy()
    calls.clear()
    assert not np.all(np.argsort(keys, kind="stable") == np.arange(10))
    srt = multistart_two_phase(fns, fns, starts, screen_cfg, polish_cfg,
                               top_k=2, chunk_size=4, presort_fn=presort,
                               return_info=True)
    plain = multistart_two_phase(fns, fns, starts, screen_cfg, polish_cfg,
                                 top_k=2, chunk_size=4, return_info=True)
    assert calls == [4, 4, 4]
    for f in ("theta", "cost", "grad_norm", "status", "n_iter", "theta0"):
        np.testing.assert_array_equal(np.asarray(getattr(srt[1], f)),
                                      np.asarray(getattr(plain[1], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(srt[1].theta0),
                                  starts.numpy())
    _assert_same(srt[0].best(), plain[0].best(),
                 fields=("theta", "cost", "status"))
    assert srt[2]["presort_seconds"] > 0.0
    assert srt[2]["n_pad"] == 2
    # the key is probed once more at warm-up, on a chunk
    drv = TwoPhaseDriver(fns, fns, screen_cfg, polish_cfg, 2, chunk_size=4,
                         presort_fn=presort)
    calls.clear()
    drv.warmup(starts[0])
    assert calls == [4]


def test_bounded_polish_of_a_project_matches_reference(mm3):
    """MM-3 from 4 numpy starts, a box whose upper bound on k2 lies 0.3
    below the optimum: 8 TRF iterations against the reference's
    multistart_trf on the same inputs; costs to 1e-6, equal statuses, and
    k2 at its upper bound."""
    proj, jproj, theta_true = mm3
    starts = theta_true[None] + np.random.default_rng(4).uniform(
        -0.3, 0.3, (4, 2))
    lb = theta_true - 1.0
    ub = theta_true + 1.0
    ub[0] = theta_true[0] - 0.3
    starts[:, 0] = np.minimum(starts[:, 0], ub[0] - 0.05)
    kw = dict(max_iter=8)
    got = multistart_trf(proj.residuals, proj.residuals_and_jacobian,
                         torch.as_tensor(starts), lb, ub, FitConfig(**kw))
    ref = jms.multistart_trf(jproj.residuals, jproj.residuals_and_jacobian,
                             jnp.asarray(starts), jnp.asarray(lb),
                             jnp.asarray(ub), JFitConfig(**kw))
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-6)
    th = got.theta.numpy()
    assert np.all(th > lb) and np.all(th < ub)
    np.testing.assert_allclose(th[:, 0], ub[0], atol=1e-6)
