"""The port's multi-start fitting against the reference's.

Ranking, chunked execution with its atomic checkpoints, the samplers, and
one small end-to-end two-phase fit of the MAPK-22 headline problem (N=4
starts, top 2 polished, 2 screening and 3 polishing iterations) in which
both packages start from the same numpy starts. The reference's Pallas
kernels run in interpret mode, the port's kernels as their plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench.fits_bench import build_problem
from tpusysbio.config import FitConfig as JFitConfig
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.fit import multistart as jms
from tpusysbio_torch import FitConfig, SolverConfig, convert, utils
from tpusysbio_torch.fit import (MultistartResult, TwoPhaseDriver,
                                 latin_hypercube, make_multistart_runner,
                                 multistart_fit, multistart_two_phase,
                                 run_chunked, uniform_starts)
from tpusysbio_torch.linalg import gpu_lu
from tpusysbio_torch.model import library
from tpusysbio_torch.project import Project

torch.set_num_threads(1)

SCREEN_KW = dict(rtol=1e-3, atol=1e-6, max_steps=192,
                 linear_solver="pallas", mixed_precision=True)


# --------------------------------------------------------------------------
# An analytic objective: exponential decay, 3 parameters
# --------------------------------------------------------------------------

_T = torch.linspace(0.0, 4.0, 15, dtype=torch.float64)
_DATA = 2.0 * torch.exp(-0.7 * _T) + 0.5


def _r(th):
    return th[:, :1] * torch.exp(-th[:, 1:2] * _T) + th[:, 2:3] - _DATA


def _rj(th):
    e = torch.exp(-th[:, 1:2] * _T)
    return _r(th), torch.stack([e, -th[:, :1] * _T * e,
                                torch.ones_like(e)], dim=2)


def _starts(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.array([1.5, 0.5, 0.2])
                           + rng.uniform(-0.5, 0.5, (n, 3)))


def test_ranked_puts_invalid_members_last():
    cost = torch.tensor([3.0, float("nan"), 1.0, 2.0, 0.5])
    status = torch.tensor([2, 2, 0, 1, -1], dtype=torch.int32)
    res = MultistartResult(theta=torch.arange(5.0)[:, None], cost=cost,
                           grad_norm=cost, status=status,
                           n_iter=status, theta0=torch.zeros(5, 1))
    r = res.ranked()
    assert r.theta[:, 0].tolist()[:3] == [2.0, 3.0, 0.0]
    assert sorted(r.theta[3:, 0].tolist()) == [1.0, 4.0]
    assert r.cov is None
    assert float(res.best()[0][0]) == 2.0
    # the host-resident (numpy) form ranks the same way
    res_np = MultistartResult(*(None if x is None else x.numpy()
                                for x in res))
    np.testing.assert_array_equal(res_np.ranked().theta[:3, 0],
                                  [2.0, 3.0, 0.0])


@pytest.mark.parametrize("iter_chunk", [None, 3])
def test_runner_plain_and_iter_chunk_agree(iter_chunk):
    cfg = FitConfig(max_iter=20)
    th = _starts(6)
    whole = make_multistart_runner(_r, _rj, cfg)(th)
    res = make_multistart_runner(_r, _rj, cfg, iter_chunk=iter_chunk)(th)
    for a, b in zip(res, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int((res.status > 0).sum()) == 6
    nocov = make_multistart_runner(_r, _rj, cfg, with_cov=False)(th)
    assert nocov.cov is None and nocov.param_sigma is None


def test_run_chunked_checkpoint_resume_and_digest(tmp_path):
    cfg = FitConfig(max_iter=20)
    th = _starts(8)
    calls = []
    base = make_multistart_runner(_r, _rj, cfg)

    def runner(chunk):
        calls.append(chunk.shape[0])
        return base(chunk)

    runner.with_cov = True
    path = str(tmp_path / "ck.npz")
    whole = base(th)
    res, resumed = run_chunked(runner, th, 4, checkpoint_path=path,
                               trace_len=20, config=cfg, run_tag="exp")
    assert resumed == 0 and calls == [4, 4]
    for k in ("theta", "cost", "status", "n_iter", "cov", "cost_trace"):
        np.testing.assert_array_equal(getattr(res, k).numpy(),
                                      getattr(whole, k).numpy())
    assert not (tmp_path / "ck.npz.tmp").exists()
    ck = np.load(path)
    assert int(ck["chunks_done"]) == 2 and ck["theta"].shape == (8, 3)

    # a crash after the first chunk: truncate the checkpoint to one chunk
    one = {k: ck[k][:4] for k in ck.files
           if k not in ("chunks_done", "run_digest")}
    np.savez(path, chunks_done=1, run_digest=ck["run_digest"], **one)
    calls.clear()
    res2, resumed = run_chunked(runner, th, 4, checkpoint_path=path,
                                trace_len=20, config=cfg, run_tag="exp",
                                as_numpy=True)
    assert resumed == 1 and calls == [4]
    assert isinstance(res2.cost, np.ndarray)
    np.testing.assert_array_equal(res2.theta, whole.theta.numpy())

    # another run (tag, config, starts) never resumes this file
    for kw in (dict(run_tag="other", config=cfg),
               dict(run_tag="exp", config=FitConfig(max_iter=20,
                                                    ftol=1e-6))):
        calls.clear()
        _, resumed = run_chunked(runner, th, 4, checkpoint_path=path,
                                 trace_len=20, **kw)
        assert resumed == 0 and calls == [4, 4]
    calls.clear()
    _, resumed = run_chunked(runner, th, 4, checkpoint_path=path,
                             trace_len=20, config=cfg, run_tag="exp",
                             resume=False)
    assert resumed == 0 and calls == [4, 4]
    # a corrupt file restarts cleanly
    (tmp_path / "ck.npz").write_bytes(b"not an npz")
    _, resumed = run_chunked(runner, th, 4, checkpoint_path=path,
                             trace_len=20, config=cfg, run_tag="exp")
    assert resumed == 0


def test_run_chunked_argument_checks():
    cfg = FitConfig(max_iter=5)
    th = _starts(6)
    run = make_multistart_runner(_r, _rj, cfg, with_cov=False)
    with pytest.raises(ValueError, match="chunk_size"):
        run_chunked(run, th, 4, channels="rank")
    with pytest.raises(ValueError, match="with_cov"):
        run_chunked(run, th, 3, channels="all")
    with pytest.raises(ValueError, match="channels"):
        run_chunked(run, th, 3, channels="some")
    res, _ = run_chunked(run, th, 3, channels="rank")
    assert res.cov is None and res.cost_trace is None
    assert tuple(res.theta.shape) == (6, 3)
    fit = multistart_fit(_r, _rj, th, cfg, chunk_size=3)
    np.testing.assert_array_equal(fit.theta.numpy(), res.theta.numpy())


# mesh= is ported since (tests/test_torch_mesh.py runs it over two
# ranks). Alone and beside the other options: a one-rank mesh computes
# what no mesh computes, and a start count that the mesh size does not
# divide raises before any rank fits.
def _two_ranks():
    return utils.Mesh(("starts",), 2, 0, torch.device("cpu"))


@pytest.mark.parametrize("kw", [dict(), dict(compact=True, iter_chunk=3),
                                dict(bounds=(0.0, 3.0))])
def test_unported_runner_options_raise(kw):
    th = _starts(6)
    cfg = FitConfig(max_iter=20)
    one = make_multistart_runner(_r, _rj, cfg, mesh=utils.make_mesh(
        device="cpu"), **kw)(th)
    plain = make_multistart_runner(_r, _rj, cfg, **kw)(th)
    for f in ("theta", "cost", "status", "n_iter", "cov"):
        assert torch.equal(getattr(one, f), getattr(plain, f)), f
    with pytest.raises(ValueError, match="does not divide"):
        make_multistart_runner(_r, _rj, cfg, mesh=_two_ranks(), **kw)(
            th[:5])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(presort_fn=lambda th: th[:, 0], chunk_size=3),
    dict(polish_bounds=(0.0, 3.0))])
def test_unported_two_phase_options_raise(kw):
    th = _starts(8, seed=2)
    fns = (_r, _rj)
    one = TwoPhaseDriver(fns, fns, FitConfig(max_iter=4), FitConfig(), 2,
                         mesh=utils.make_mesh(device="cpu"), **kw).run(th)
    plain = TwoPhaseDriver(fns, fns, FitConfig(max_iter=4), FitConfig(), 2,
                           **kw).run(th)
    for got, ref in zip(one[:2], plain[:2]):
        for f in ("theta", "cost", "status"):
            assert torch.equal(torch.as_tensor(getattr(got, f)),
                               torch.as_tensor(getattr(ref, f))), f
    with pytest.raises(ValueError, match="does not divide"):
        TwoPhaseDriver(fns, fns, FitConfig(), FitConfig(), 2,
                       mesh=_two_ranks(), **kw).run(th[:5])


def test_two_phase_on_the_analytic_objective(tmp_path):
    """Chunked, padded and checkpointed screen; polish in sub-batches."""
    th = _starts(10, seed=4)
    scfg = FitConfig(max_iter=3, eval_mode="lockstep")
    pcfg = FitConfig(max_iter=25, eval_mode="lockstep")
    drv = TwoPhaseDriver((_r, _rj), (_r, _rj), scfg, pcfg, top_k=4,
                         chunk_size=4, polish_subbatch=2, iter_chunk=2,
                         run_tag="exp")
    assert drv.warmup(th[0]) > 0.0
    path = str(tmp_path / "screen.npz")
    polish, screen, info = drv.run(th, checkpoint_path=path)
    assert info["n_pad"] == 2 and info["chunks_resumed"] == 0
    assert isinstance(screen.cost, np.ndarray) and screen.cost.shape == (10,)
    assert tuple(polish.theta.shape) == (4, 3) and polish.cov is not None
    # the polish input is the ranked screen top 4
    order = np.argsort(screen.cost, kind="stable")[:4]
    np.testing.assert_array_equal(polish.theta0.numpy(),
                                  screen.theta[order])
    assert float(polish.cost.max()) < 1e-15
    _, _, info2 = drv.run(th, checkpoint_path=path)
    assert info2["chunks_resumed"] == 3
    whole, _ = multistart_two_phase((_r, _rj), (_r, _rj), th, scfg, pcfg, 4)
    np.testing.assert_allclose(whole.theta.numpy(), polish.theta.numpy(),
                               rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="polish_subbatch"):
        TwoPhaseDriver((_r, _rj), (_r, _rj), scfg, pcfg, 4,
                       polish_subbatch=3)


# --------------------------------------------------------------------------
# Samplers
# --------------------------------------------------------------------------

def test_latin_hypercube_is_stratified_and_seeded():
    lower = torch.tensor([-1.0, 0.0, 2.0], dtype=torch.float64)
    upper = torch.tensor([1.0, 10.0, 2.5], dtype=torch.float64)
    n = 16
    x = latin_hypercube(torch.Generator().manual_seed(0), n, lower, upper)
    assert tuple(x.shape) == (n, 3) and x.dtype == torch.float64
    strata = torch.floor((x - lower) / (upper - lower) * n).long()
    for g in range(3):     # one start per stratum per dimension
        assert sorted(strata[:, g].tolist()) == list(range(n))
    again = latin_hypercube(torch.Generator().manual_seed(0), n, lower,
                            upper)
    other = latin_hypercube(torch.Generator().manual_seed(1), n, lower,
                            upper)
    assert torch.equal(x, again) and not torch.equal(x, other)
    # the dimensions are permuted independently
    assert strata[:, 0].tolist() != strata[:, 1].tolist()


def test_uniform_starts_in_box_and_seeded():
    lower = torch.tensor([-1.0, 5.0], dtype=torch.float64)
    upper = torch.tensor([1.0, 6.0], dtype=torch.float64)
    x = uniform_starts(torch.Generator().manual_seed(3), 50, lower, upper)
    assert tuple(x.shape) == (50, 2)
    assert bool((x >= lower).all() and (x <= upper).all())
    assert torch.equal(x, uniform_starts(torch.Generator().manual_seed(3),
                                         50, lower, upper))


# --------------------------------------------------------------------------
# The slice end to end: two-phase fit of the MAPK-22 headline problem
# --------------------------------------------------------------------------

def _fields(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def two_phase():
    n, top_k = 4, 2
    jtight, theta_true = build_problem()
    jscreen = dataclasses.replace(jtight, config=JSolverConfig(**SCREEN_KW))
    rng = np.random.default_rng(11)
    starts = np.asarray(theta_true)[None] + rng.uniform(-1.0, 1.0, (n, 12))
    jkw = dict(eval_mode="lockstep")
    ref_polish, ref_screen = jms.multistart_two_phase(
        (jscreen.residuals, jscreen.residuals_and_jacobian),
        (jtight.residuals, jtight.residuals_and_jacobian),
        jnp.asarray(starts),
        JFitConfig(max_iter=2, ftol=1e-4, xtol=1e-4, **jkw),
        JFitConfig(max_iter=3, **jkw), top_k)

    model = library.mapk_huang_ferrell(device="cpu")
    pmap = convert.pmap_from_reference(_fields(jtight.pmap), device="cpu")
    batch = convert.batch_from_reference(_fields(jtight.batch),
                                         device="cpu")
    tight = Project(model=model, pmap=pmap, batch=batch,
                    config=SolverConfig(**dataclasses.asdict(jtight.config)))
    screen = dataclasses.replace(tight, config=SolverConfig(**SCREEN_KW))
    gpu_lu.reset_launches()
    polish, scr, info = multistart_two_phase(
        (screen.residuals, screen.residuals_and_jacobian),
        (tight.residuals, tight.residuals_and_jacobian),
        torch.as_tensor(starts),
        FitConfig(max_iter=2, ftol=1e-4, xtol=1e-4, **jkw),
        FitConfig(max_iter=3, **jkw), top_k, return_info=True)
    return (polish, scr, info, dict(gpu_lu.LAUNCHES), ref_polish,
            ref_screen)


def test_two_phase_screen_matches_reference(two_phase):
    """The f32 screening phase: two LM iterations on rtol=1e-3
    integrations whose f32 roundings differ between the packages, so the
    costs agree to a few percent (measured: 1.2% on one member, under 0.1%
    on the others), and the ranking that picks the polish set is the
    reference's."""
    _, scr, _, _, _, ref_screen = two_phase
    np.testing.assert_array_equal(scr.status.numpy(),
                                  np.asarray(ref_screen.status))
    np.testing.assert_allclose(scr.cost.numpy(),
                               np.asarray(ref_screen.cost), rtol=3e-2)
    np.testing.assert_array_equal(
        np.argsort(scr.cost.numpy(), kind="stable"),
        np.argsort(np.asarray(ref_screen.cost), kind="stable"))


def test_two_phase_polish_matches_reference(two_phase):
    """Polished costs to 1e-6 relative and the same ranking."""
    polish, _, info, _, ref_polish, _ = two_phase
    assert tuple(polish.theta.shape) == (2, 12)
    np.testing.assert_array_equal(polish.status.numpy(),
                                  np.asarray(ref_polish.status))
    np.testing.assert_array_equal(polish.n_iter.numpy(),
                                  np.asarray(ref_polish.n_iter))
    np.testing.assert_allclose(polish.cost.numpy(),
                               np.asarray(ref_polish.cost), rtol=1e-6)
    np.testing.assert_array_equal(
        np.argsort(polish.cost.numpy(), kind="stable"),
        np.argsort(np.asarray(ref_polish.cost), kind="stable"))
    assert bool(torch.isfinite(polish.param_sigma).all())
    assert info["screen_seconds"] > 0 and info["polish_seconds"] > 0


def test_two_phase_on_cpu_launches_no_kernel(two_phase):
    assert set(two_phase[3].values()) == {0}
