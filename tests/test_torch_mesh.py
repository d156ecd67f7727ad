"""The port's mesh (``tpusysbio_torch.utils``): two ranks in two processes
joined by a gloo process group, against the port's single-process runs
and the JAX package's runs on a 2-device mesh.

Run as a script, this file is one rank of such a group (it imports only
torch and the port then):

    python tests/test_torch_mesh.py <rank> <world> <init_file> <out> [case]

The fixture below starts two of them (``init_method=file://``, no port to
race for) and each writes its gathered results to ``<out>.<rank>.npz``;
the tests hold both ranks equal bit for bit and equal to the references.
The cases (``CASES``): (a) ``multistart_fit`` on Rosenbrock, plain and
checkpointed in chunks (``run_chunked``'s default ``overlap=True``: rank
0's writer thread beside the next chunk's fit); (b) ``compact=True`` under ``iter_chunk``; (c) a
two-phase MM-3 fit under ``linear_solver='pallas'`` (the plain twin here)
with a top_k that the mesh divides and one it does not; (d)
``profile_likelihood`` on a quadratic; (e) ``Project(experiment_mesh=)``
over 8 experiments and over 3 (timed inputs and an initial-value override
among them, and tests/test_torch_events.py's pre-equilibrated batch with
a steady-state row); (f) ``ensemble_sample(log_prob_v=)`` with each rank
scoring its block of the walkers and ``utils.all_gather`` collecting
them, against the one-process chain whose ``log_prob_fn`` splits the
rows into the same two blocks. Rosenbrock, the quadratic and the blocks
of (f) are elementwise or of equal size, so the sharded runs equal the
single-process ones bit for bit; a ``Project``
goes through batched CPU matmuls, which round by batch size (ROADMAP
Queue 3), so those are held to the reference's tolerances.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpusysbio_torch import FitConfig, SolverConfig, utils  # noqa: E402
from tpusysbio_torch.fit import (TwoPhaseDriver,  # noqa: E402
                                 ensemble_sample, make_multistart_runner,
                                 multistart_fit, profile_likelihood,
                                 run_chunked)

torch.set_num_threads(1)

WORKER_TIMEOUT = 420.0   # seconds for a rank process, start-up included
GROUP_TIMEOUT = 120.0    # the process group's own timeout

ROS_STARTS = np.random.default_rng(7).uniform(-1.5, 1.5, size=(16, 2))
COMPACT_STARTS = np.random.default_rng(9).normal(scale=1.0, size=(32, 2))
QUAD_TARGET = np.array([1.0, -2.0, 0.5, 3.0])
QUAD_SIGMA = np.array([0.5, 2.0, 1.0, 0.25])
MC_A = np.random.default_rng(0).normal(size=(12, 3))
MC_X0 = (np.array([1.0, -0.5, 2.0])
         + 0.05 * np.random.default_rng(9).normal(size=(16, 3)))
MC_STEPS = 20
MM_FREE = ("k2", "E0")
MM_TRUE = {"k1": 10.0, "km1": 1.0, "k2": 1.5, "E0": 0.5}


# --------------------------------------------------------------------------
# The problems, as functions of numpy inputs (shared by both packages)
# --------------------------------------------------------------------------

def ros_r(th):
    return torch.stack([10.0 * (th[:, 1] - th[:, 0] ** 2), 1.0 - th[:, 0]],
                       dim=1)


def ros_rj(th):
    z = torch.zeros_like(th[:, 0])
    J = torch.stack([torch.stack([-20.0 * th[:, 0], z + 10.0], dim=1),
                     torch.stack([z - 1.0, z], dim=1)], dim=1)
    return ros_r(th), J


def quad_r(th):
    return (th - torch.as_tensor(QUAD_TARGET)) / torch.as_tensor(QUAD_SIGMA)


def quad_rj(th):
    J = torch.diag(1.0 / torch.as_tensor(QUAD_SIGMA))
    return quad_r(th), J.expand(th.shape[0], 4, 4)


@functools.lru_cache(maxsize=None)
def mm3_data():
    """MM-3 at the true parameters on 4 times (tests/test_project.py's
    experiment-axis grid), computed once by the port on the CPU."""
    from tpusysbio_torch.model import library

    t = np.linspace(1.0, 10.0, 4)
    res = library.michaelis_menten(device="cpu").simulate(
        np.asarray(library.MM_TRUE_PARAMS)[None], (0.0, 10.0), t,
        config=SolverConfig(rtol=1e-10, atol=1e-12), device="cpu")
    return t, res.ys[0].numpy()


def mm3_experiments(ns, t, data, n_exp, features=False):
    """``n_exp`` experiments of MM-3 data scaled by 1 + 0.01·e, built with
    the ``Measurement``/``Experiment`` classes of ``ns`` (either package's
    ``data`` module). With ``features``, experiment 1 halves k2 at t=4 and
    experiment 2 starts with S = 0.8."""
    exps = []
    for e in range(n_exp):
        meas = tuple(ns.Measurement(obs_index=i, times=t,
                                    values=data[:, i] * (1 + 0.01 * e),
                                    sigmas=np.full(len(t), 0.05))
                     for i in range(3))
        kw = {}
        if features and e == 1:
            kw["inputs"] = ((4.0, "k2", 0.75),)
        if features and e == 2:
            kw["y0_overrides"] = {"S": 0.8}
        exps.append(ns.Experiment(f"e{e}", meas, **kw))
    return exps


def mm3_project(n_exp, features=False, mesh=None):
    """The port's MM-3 ``Project`` over ``n_exp`` experiments, its four
    parameters shared (tests/test_project.py's experiment-axis case)."""
    from tpusysbio_torch import data
    from tpusysbio_torch.model import library
    from tpusysbio_torch.project import ParameterMap, Project

    model = library.michaelis_menten(device="cpu")
    t, ys = mm3_data()
    batch = data.ExperimentBatch.from_experiments(
        mm3_experiments(data, t, ys, n_exp, features),
        param_names=model.param_names, state_names=model.state_names,
        device="cpu")
    pmap = ParameterMap.create(model.param_names, n_exp,
                               shared=tuple(MM_TRUE), device="cpu")
    return Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-6, atol=1e-9, max_steps=256),
                   experiment_mesh=mesh)


def mm3_fit_data(ns):
    """The two-phase MM-3 problem's one experiment (``mm3_data`` with
    noise of σ = 0.01), built with ``ns``'s classes."""
    t, ys = mm3_data()
    vals = ys + np.random.default_rng(0).normal(scale=0.01, size=ys.shape)
    meas = tuple(ns.Measurement(obs_index=i, times=t, values=vals[:, i],
                                sigmas=np.full(len(t), 0.01))
                 for i in range(3))
    return [ns.Experiment("e0", meas)]


def mm3_fit_project(screen: bool):
    """The two-phase MM-3 problem: k2 and E0 free (k1 and km1 are
    identified only together), under ``'pallas'``."""
    from tpusysbio_torch import data
    from tpusysbio_torch.model import library
    from tpusysbio_torch.project import ParameterMap, Project

    model = library.michaelis_menten(device="cpu")
    batch = data.ExperimentBatch.from_experiments(mm3_fit_data(data),
                                                  device="cpu")
    pmap = ParameterMap.create(
        model.param_names, 1, shared=MM_FREE,
        fixed={k: v for k, v in MM_TRUE.items() if k not in MM_FREE},
        device="cpu")
    cfg = (SolverConfig(**MM_SCREEN) if screen
           else SolverConfig(**MM_TIGHT))
    return Project(model=model, pmap=pmap, batch=batch, config=cfg)


INFLOW_NAMES = ("v", "d1", "k", "d2")
INFLOW_TRUE = (2.0, 0.5, 1.0, 0.25)


def inflow_project(mesh=None):
    """tests/test_torch_events.py's ``preeq`` batch: a two-state inflow
    chain pre-equilibrated under a basal inflow, once as it is and once
    with an initial-value override after that, beside an experiment with
    a steady-state row. Over 2 ranks the first block pre-equilibrates and
    has no steady-state row, the second the other way round."""
    from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
    from tpusysbio_torch.model.core import OdeModel
    from tpusysbio_torch.project import ParameterMap, Project

    def rhs(t, y, p):
        return torch.stack([p[:, 0] - p[:, 1] * y[:, 0],
                            p[:, 2] * y[:, 0] - p[:, 3] * y[:, 1]], dim=-1)

    states = ("y1", "y2")
    model = OdeModel(name="inflow2", n_states=2, n_params=4, n_obs=2,
                     rhs=rhs, y0=lambda p: 0.0 * p[:, :2] + 0.2,
                     observables=lambda y, p: y, param_names=INFLOW_NAMES,
                     state_names=states)
    t = np.linspace(0.5, 8.0, 7)

    def zero(obs):
        return tuple(Measurement(obs_index=i, times=t, values=np.zeros(7),
                                 sigmas=np.ones(7)) for i in obs)

    exps = [Experiment("dose", zero((0, 1)), preequilibrate=True,
                       preeq_params={"v": 0.5}),
            Experiment("reset", zero((0, 1)), preequilibrate=True,
                       preeq_params={"v": 0.5}, y0_overrides={"y2": 1.0}),
            Experiment("ss", zero((0,)) + (
                Measurement.at_steady_state(1, 0.0, 1.0),))]
    batch = ExperimentBatch.from_experiments(
        exps, param_names=INFLOW_NAMES, state_names=states, device="cpu")
    pmap = ParameterMap.create(INFLOW_NAMES, 3, shared=INFLOW_NAMES,
                               device="cpu")
    return Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-6, atol=1e-9),
                   ss_t_relax=20.0, experiment_mesh=mesh)


def inflow_thetas():
    theta = np.log(INFLOW_TRUE)
    return np.stack([theta, theta + np.random.default_rng(0).uniform(
        -0.2, 0.2, theta.shape)])


MM_TIGHT = dict(rtol=1e-7, atol=1e-10, linear_solver="pallas")
MM_SCREEN = dict(rtol=1e-3, atol=1e-6, max_steps=256, mixed_precision=True,
                 linear_solver="pallas")
MM_SCREEN_FIT = dict(max_iter=3, eval_mode="lockstep", ftol=1e-4, xtol=1e-4)
MM_POLISH_FIT = dict(max_iter=8, eval_mode="lockstep")
MM_TOP_K = (4, 3)     # split 2 + 2; whole on every rank


def mm3_starts():
    th = np.log([MM_TRUE[k] for k in MM_FREE])
    return th[None] + np.random.default_rng(3).uniform(-1.0, 1.0, (8, 2))


# --------------------------------------------------------------------------
# The cases: each a function of the mesh (None: one process), returning
# numpy arrays by name
# --------------------------------------------------------------------------

def _np(res, prefix, fields=("theta", "cost", "status", "n_iter")):
    return {f"{prefix}_{f}": getattr(res, f).cpu().numpy() for f in fields}


def case_rosenbrock(mesh, ck_dir):
    starts = torch.as_tensor(ROS_STARTS)
    cfg = FitConfig(max_iter=60)
    out = _np(multistart_fit(ros_r, ros_rj, starts, cfg, mesh=mesh), "a")
    # in chunks of 8 (4 + 4 under the mesh), checkpointed, then resumed
    run = make_multistart_runner(ros_r, ros_rj, cfg, mesh=mesh)
    path = os.path.join(ck_dir, "ck.npz")
    res, done = run_chunked(run, starts, 8, checkpoint_path=path,
                            trace_len=60, config=cfg)
    again, resumed = run_chunked(run, starts, 8, checkpoint_path=path,
                                 trace_len=60, config=cfg)
    out.update(_np(res, "a_chunked"))
    out.update(_np(again, "a_resumed"))
    out["a_chunks"] = np.array([done, resumed])
    return out


def case_compact(mesh, ck_dir):
    res = multistart_fit(ros_r, ros_rj, torch.as_tensor(COMPACT_STARTS),
                         FitConfig(max_iter=120), mesh=mesh, iter_chunk=5,
                         compact=True)
    return _np(res, "b")


def case_two_phase(mesh, ck_dir):
    tight, screen = mm3_fit_project(False), mm3_fit_project(True)
    out = {}
    for top_k in MM_TOP_K:
        driver = TwoPhaseDriver(
            (screen.residuals, screen.residuals_and_jacobian),
            (tight.residuals, tight.residuals_and_jacobian),
            FitConfig(**MM_SCREEN_FIT), FitConfig(**MM_POLISH_FIT), top_k,
            mesh=mesh, iter_chunk=3)
        polish, scr, _ = driver.run(torch.as_tensor(mm3_starts()))
        out.update(_np(polish.ranked(), f"c{top_k}"))
        out.update(_np(scr, f"c{top_k}_screen", ("cost", "status")))
    return out


def case_profile(mesh, ck_dir):
    res = profile_likelihood(quad_r, quad_rj, torch.as_tensor(QUAD_TARGET),
                             idx=[0, 1, 2, 3], n_points=3, span=1.0,
                             config=FitConfig(max_iter=30), mesh=mesh)
    return {"d_values": res.values.numpy(), "d_costs": res.costs.numpy(),
            "d_status": res.status.numpy()}


def case_project(mesh, ck_dir):
    out = {}
    theta = torch.log(torch.tensor([list(MM_TRUE.values()),
                                    [8.0, 1.2, 1.4, 0.55]],
                                   dtype=torch.float64))
    for name, n_exp, features in (("e8", 8, False), ("e3", 3, True)):
        ev = mm3_project(n_exp, features, mesh).evaluate(theta,
                                                         with_jac=True)
        out.update({f"{name}_r": ev.residuals.numpy(),
                    f"{name}_J": ev.jacobian.numpy(),
                    f"{name}_status": ev.status.numpy()})
    ev = inflow_project(mesh).evaluate(torch.as_tensor(inflow_thetas()),
                                       with_jac=True)
    out.update({"pre_r": ev.residuals.numpy(), "pre_J": ev.jacobian.numpy(),
                "pre_status": ev.status.numpy()})
    return out


def mc_logp(th):
    """The linear-Gaussian posterior of tests/test_torch_mcmc.py, rows of
    ``th`` (W', 3) -> (W',)."""
    A = torch.as_tensor(MC_A)
    b = A @ torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    return -0.5 * torch.sum((th @ A.T - b) ** 2, dim=1)


def case_mcmc(mesh, ck_dir):
    x0 = torch.as_tensor(MC_X0)
    gen = torch.Generator().manual_seed(11)
    if mesh is None:
        def two_blocks(th):
            n = th.shape[0] // 2
            return torch.cat([mc_logp(th[:n]), mc_logp(th[n:])])

        res = ensemble_sample(two_blocks, x0, MC_STEPS, gen)
    else:
        def lpv(th):
            mine = mc_logp(th[mesh.block(th.shape[0])])
            return torch.cat(utils.all_gather(mine, mesh))

        res = ensemble_sample(mc_logp, x0, MC_STEPS, gen, log_prob_v=lpv)
    return {"f_chain": res.chain.numpy(), "f_log_prob": res.log_prob.numpy(),
            "f_acceptance": res.acceptance.numpy()}


CASES = (case_rosenbrock, case_compact, case_two_phase, case_profile,
         case_project, case_mcmc)


def worker(rank, world, init_file, out, case):
    utils.distributed_initialize(num_processes=world, process_id=rank,
                                 init_method=f"file://{init_file}",
                                 timeout_s=GROUP_TIMEOUT)
    mesh = utils.make_mesh(device="cuda" if case == "cuda" else "cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    if case == "cuda":
        # the ranks share the card: tests/test_torch_cuda_kernels.py
        res = multistart_fit(ros_r, ros_rj, torch.as_tensor(
            ROS_STARTS, device=mesh.device), FitConfig(max_iter=60),
            mesh=mesh)
        np.savez(f"{out}.{rank}.npz", **_np(res, "a", (
            "theta", "cost", "status", "n_iter")))
        return
    if case == "raise":
        if rank == 1:
            raise RuntimeError("rank 1 fails before the gather")
        multistart_fit(ros_r, ros_rj, torch.as_tensor(ROS_STARTS),
                       FitConfig(max_iter=60), mesh=mesh)
        return
    ck_dir = os.path.dirname(out)
    arrays = {}
    for fn in CASES:
        arrays.update(fn(mesh, ck_dir))
    np.savez(f"{out}.{rank}.npz", **arrays)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           sys.argv[5] if len(sys.argv) > 5 else "all")
    sys.exit(0)


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

import pytest  # noqa: E402


def _start_ranks(tmp, case="all", world=2):
    init = os.path.join(tmp, "init")
    out = os.path.join(tmp, "out")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         init, out, case], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return procs, out


def _join(procs, timeout=WORKER_TIMEOUT):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return logs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' arrays, and this process's single-process port runs of
    the same cases (computed while the ranks run)."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    procs, out = _start_ranks(tmp)
    try:
        single = {}
        ck = str(tmp_path_factory.mktemp("single"))
        for fn in CASES:
            single.update(fn(None, ck))
    finally:
        logs = _join(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    got = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    return got, single


def _jax_mesh(axis):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), (axis,))


def test_ranks_return_equal_results(ranks):
    got, single = ranks
    assert set(got[0]) == set(got[1]) == set(single)
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def test_multistart_fit_matches_single_process_and_reference(ranks):
    """(a) 16 starts, 8 a rank: equal to the one-process run (elementwise
    residuals: bit for bit) and to the JAX package's ``multistart_fit`` on
    a 2-device mesh at tests/test_multihost.py's bounds; the checkpointed
    run in chunks of 8 gives the same and resumes both chunks."""
    import jax
    import jax.numpy as jnp

    from tpusysbio.config import FitConfig as JFitConfig
    from tpusysbio.fit import multistart_fit as jfit

    got, single = ranks
    g = got[0]
    for f in ("theta", "cost", "status", "n_iter"):
        np.testing.assert_array_equal(g[f"a_{f}"], single[f"a_{f}"])
        np.testing.assert_array_equal(g[f"a_chunked_{f}"], g[f"a_{f}"])
        np.testing.assert_array_equal(g[f"a_resumed_{f}"], g[f"a_{f}"])
    assert g["a_chunks"].tolist() == [0, 2]

    def jr(t):
        return jnp.stack([10.0 * (t[1] - t[0] ** 2), 1.0 - t[0]])

    ref = jfit(jr, lambda t: (jr(t), jax.jacfwd(jr)(t)),
               jnp.asarray(ROS_STARTS), JFitConfig(max_iter=60),
               mesh=_jax_mesh("starts"))
    np.testing.assert_allclose(g["a_cost"], np.asarray(ref.cost),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g["a_theta"], np.asarray(ref.theta),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(g["a_status"], np.asarray(ref.status))


def test_ensemble_sample_log_prob_v_over_the_mesh(ranks):
    """(f) 16 walkers, 20 sweeps: each rank scores its 4 walkers of a half
    (8 of ``x0``) and all-gathers; the chain, log-probs and acceptance
    equal the one-process chain at the same block split bit for bit."""
    got, single = ranks
    for k in ("f_chain", "f_log_prob", "f_acceptance"):
        np.testing.assert_array_equal(got[0][k], single[k], err_msg=k)
    assert got[0]["f_chain"].shape == (MC_STEPS, 16, 3)


def test_compaction_under_mesh_matches_reference(ranks):
    """(b) tests/test_fit.py's compaction-under-a-mesh case: 32 starts in
    chunks of 5 iterations, each rank repacking its own 16; θ within 1e-12
    of the one-process run and of the JAX package's compacted mesh run,
    statuses equal."""
    import jax
    import jax.numpy as jnp

    from tpusysbio.config import FitConfig as JFitConfig
    from tpusysbio.fit import multistart_fit as jfit

    got, single = ranks

    def jr(t):
        return jnp.stack([10.0 * (t[1] - t[0] ** 2), 1.0 - t[0]])

    ref = jfit(jr, lambda t: (jr(t), jax.jacfwd(jr)(t)),
               jnp.asarray(COMPACT_STARTS), JFitConfig(max_iter=120),
               mesh=_jax_mesh("starts"), iter_chunk=5, compact=True)
    for other in (single["b_theta"], np.asarray(ref.theta)):
        np.testing.assert_allclose(got[0]["b_theta"], other, atol=1e-12)
    for other in (single["b_status"], np.asarray(ref.status)):
        np.testing.assert_array_equal(got[0]["b_status"], other)


def test_two_phase_pallas_under_mesh(ranks):
    """(c) tests/test_fit.py's two-phase mesh case on MM-3 under
    ``'pallas'``: 8 starts, the screen split 4 + 4; top_k 4 polished 2 + 2
    and top_k 3 whole on every rank. Ranked polished costs within 1e-9 of
    the one-process port and of the JAX package's mesh run, statuses
    equal to the one-process run's."""
    import jax.numpy as jnp

    from tpusysbio import data as jdata
    from tpusysbio.config import FitConfig as JFitConfig
    from tpusysbio.config import SolverConfig as JSolverConfig
    from tpusysbio.fit.multistart import multistart_two_phase
    from tpusysbio.model import library as jlibrary
    from tpusysbio.project import ParameterMap as JParameterMap
    from tpusysbio.project import Project as JProject

    got, single = ranks
    g = got[0]
    port = mm3_fit_project(False)
    jmodel = jlibrary.michaelis_menten()
    jbatch = jdata.ExperimentBatch.from_experiments(mm3_fit_data(jdata))
    jpmap = JParameterMap.create(
        jmodel.param_names, 1, shared=MM_FREE,
        fixed={k: v for k, v in MM_TRUE.items() if k not in MM_FREE})
    jt = JProject(model=jmodel, pmap=jpmap, batch=jbatch,
                  config=JSolverConfig(**MM_TIGHT))
    js = JProject(model=jmodel, pmap=jpmap, batch=jbatch,
                  config=JSolverConfig(**MM_SCREEN))
    np.testing.assert_allclose(float(jt.cost(jnp.log(jnp.asarray(
        [MM_TRUE[k] for k in MM_FREE])))), float(port.cost(torch.log(
            torch.tensor([MM_TRUE[k] for k in MM_FREE],
                         dtype=torch.float64)))), rtol=1e-9)
    for top_k in MM_TOP_K:
        c = f"c{top_k}"
        np.testing.assert_array_equal(g[f"{c}_status"], single[f"{c}_status"])
        np.testing.assert_array_equal(g[f"{c}_screen_status"],
                                      single[f"{c}_screen_status"])
        assert (g[f"{c}_status"] > 0).all()
        np.testing.assert_allclose(g[f"{c}_cost"], single[f"{c}_cost"],
                                   rtol=1e-9)
        ref, _ = multistart_two_phase(
            (js.residuals, js.residuals_and_jacobian),
            (jt.residuals, jt.residuals_and_jacobian),
            jnp.asarray(mm3_starts()), JFitConfig(**MM_SCREEN_FIT),
            JFitConfig(**MM_POLISH_FIT), top_k=top_k,
            mesh=_jax_mesh("starts"), iter_chunk=3)
        np.testing.assert_allclose(g[f"{c}_cost"],
                                   np.asarray(ref.ranked().cost), rtol=1e-9)


def test_profile_under_mesh_matches_closed_form(ranks):
    """(d) tests/test_profile.py's subset-and-mesh case: 8 chains, 4 a
    rank; costs within 1e-10 of the closed form, and the one-process run's
    bit for bit."""
    got, single = ranks
    g = got[0]
    assert g["d_costs"].shape == (4, 7)
    expect = 0.5 * (g["d_values"] - QUAD_TARGET[:, None]) ** 2 \
        / QUAD_SIGMA[:, None] ** 2
    np.testing.assert_allclose(g["d_costs"], expect, atol=1e-10)
    for k in ("d_values", "d_costs", "d_status"):
        np.testing.assert_array_equal(g[k], single[k])


@pytest.mark.parametrize("name,n_exp,features",
                         [("e8", 8, False), ("e3", 3, True)])
def test_experiment_mesh_matches_reference(ranks, name, n_exp, features):
    """(e) tests/test_project.py's experiment-axis case (8 experiments, 4
    a rank) and 3 experiments over 2 ranks (blocks of 2 and 1, the second
    padded for the gather; a timed input and an initial-value override
    among them): ``r`` and ``J`` at two θ within rtol 1e-6 / atol 1e-9 of
    the one-process port and of the JAX package's experiment-mesh
    ``Project``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tpusysbio import data as jdata
    from tpusysbio.config import SolverConfig as JSolverConfig
    from tpusysbio.model import library as jlibrary
    from tpusysbio.project import ParameterMap as JParameterMap
    from tpusysbio.project import Project as JProject

    got, single = ranks
    g = got[0]
    for k in ("r", "J", "status"):
        np.testing.assert_allclose(g[f"{name}_{k}"], single[f"{name}_{k}"],
                                   rtol=1e-6, atol=1e-9)
    jmodel = jlibrary.michaelis_menten()
    t, ys = mm3_data()
    jbatch = jdata.ExperimentBatch.from_experiments(
        mm3_experiments(jdata, t, ys, n_exp, features),
        param_names=jmodel.param_names, state_names=jmodel.state_names)
    jpmap = JParameterMap.create(jmodel.param_names, n_exp,
                                 shared=tuple(MM_TRUE))
    jproj = JProject(model=jmodel, pmap=jpmap, batch=jbatch,
                     config=JSolverConfig(rtol=1e-6, atol=1e-9,
                                          max_steps=256))
    jproj = dataclasses.replace(jproj,
                                experiment_mesh=_jax_mesh("experiments"))
    theta = np.log([list(MM_TRUE.values()), [8.0, 1.2, 1.4, 0.55]])
    rj = jax.jit(jproj.residuals_and_jacobian)
    for i, th in enumerate(theta):
        r, J = rj(jnp.asarray(th))
        np.testing.assert_allclose(g[f"{name}_r"][i], np.asarray(r),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(g[f"{name}_J"][i], np.asarray(J),
                                   rtol=1e-6, atol=1e-9)


def test_experiment_mesh_with_preequilibration_and_steady_states(ranks):
    """(e) tests/test_torch_events.py's ``preeq`` batch over 2 ranks: the
    steady-state solves run in the block that needs them (pre-equilibration
    in one, the steady-state row in the other); statuses equal, ``r`` and
    ``J`` within rtol 1e-6 / atol 1e-9 of the one-process port and of the
    JAX package's experiment-mesh ``Project``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import test_torch_events as events

    got, single = ranks
    g = got[0]
    np.testing.assert_array_equal(g["pre_status"], single["pre_status"])
    assert (g["pre_status"] == 1).all()
    jproj, thetas = events._problem("preeq", "jax")
    np.testing.assert_allclose(thetas, inflow_thetas(), rtol=1e-15)
    jproj = dataclasses.replace(jproj,
                                experiment_mesh=_jax_mesh("experiments"))
    rj = jax.jit(jproj.residuals_and_jacobian)
    for k in ("r", "J"):
        np.testing.assert_allclose(g[f"pre_{k}"], single[f"pre_{k}"],
                                   rtol=1e-6, atol=1e-9)
    for i, th in enumerate(thetas):
        r, J = rj(jnp.asarray(th))
        np.testing.assert_allclose(g["pre_r"][i], np.asarray(r), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(g["pre_J"][i], np.asarray(J), rtol=1e-6,
                                   atol=1e-9)


def test_a_failing_rank_fails_the_other(tmp_path):
    """(f) rank 1 raises before the gather: rank 0 fails too, within the
    group's timeout, instead of hanging."""
    t0 = time.perf_counter()
    procs, _ = _start_ranks(str(tmp_path), case="raise")
    logs = _join(procs, timeout=GROUP_TIMEOUT + 60.0)
    assert time.perf_counter() - t0 < GROUP_TIMEOUT + 60.0
    assert procs[1].returncode != 0 and "rank 1 fails" in logs[1]
    assert procs[0].returncode != 0, logs[0][-2000:]


def _mm3_mesh_config(tmp_path):
    path = tmp_path / "mesh.yaml"
    path.write_text(
        "model: mm3\n"
        "solver: {rtol: 1.0e-6, atol: 1.0e-9, max_steps: 512, "
        "linear_solver: pallas, sens_precision: f32}\n"
        "screen_solver: {rtol: 1.0e-3, atol: 1.0e-6, max_steps: 128, "
        "linear_solver: pallas, mixed_precision: true}\n"
        "fit: {max_iter: 3, eval_mode: lockstep}\n"
        "screen_fit: {max_iter: 2, eval_mode: lockstep, ftol: 1.0e-4, "
        "xtol: 1.0e-4}\n"
        "mesh: {axis_names: [starts], axis_sizes: [2]}\n"
        "run: {starts: 4, top_k: 2, iter_chunk: 2, spread: 0.3, "
        "t_end: 5.0, n_times: 6}\n")
    return path


def test_cli_joins_the_group_before_it_builds_the_problem(tmp_path,
                                                          monkeypatch):
    """``multistart --config`` with a mesh joins the group first (joining
    pins the rank's card) and builds the problem on the mesh's device, so
    that no rank's problem lands on the default card. The mesh's device
    is ``meta`` here, which no default could produce."""
    from tpusysbio_torch import cli

    calls = []
    mesh = utils.Mesh(("starts",), 2, 1, torch.device("meta"))

    def config_mesh(config, device):
        calls.append(("mesh", device))
        return mesh, False

    class Built(Exception):
        pass

    def synth_problem(args, device):
        calls.append(("synth", device))
        raise Built

    monkeypatch.setattr(cli, "_config_mesh", config_mesh)
    monkeypatch.setattr(cli, "_synth_problem", synth_problem)
    with pytest.raises(Built):
        cli.main(["--cpu", "multistart", "--config",
                  str(_mm3_mesh_config(tmp_path))])
    assert calls == [("mesh", torch.device("cpu")),
                     ("synth", torch.device("meta"))]


def test_inputs_off_the_mesh_device_raise():
    """Starts on another device than the host or the mesh's, and a
    ``Project`` whose batch is not on its experiment mesh's device, raise
    before any collective (a rank's problem built on the default card
    would otherwise mix cards with the rank's own)."""
    cpu = utils.Mesh(("starts",), 2, 0, torch.device("cpu"))
    off = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="mesh device is cpu"):
        utils.shard_starts(off, cpu)
    runner = make_multistart_runner(ros_r, ros_rj, FitConfig(max_iter=2),
                                    mesh=cpu)
    with pytest.raises(ValueError, match="call distributed_initialize"):
        runner(off)
    # starts on the host are sharded onto the mesh's device
    assert utils.shard_starts(torch.zeros(4, 2), cpu).shape == (2, 2)
    with pytest.raises(ValueError, match="the batch's tensors lie on cpu"):
        mm3_project(3, mesh=utils.Mesh(("experiments",), 2, 0,
                                       torch.device("meta")))


def test_cli_config_mesh_over_two_ranks(tmp_path):
    """(g) ``multistart --config`` on an MM-3 run file whose mesh asks for
    2 ranks, launched as ``torchrun`` would launch it (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): rank 0 prints the
    one-process run's record (its wall time aside; costs to 1e-9), rank 1
    prints nothing, and both exit 0."""
    import socket

    from tpusysbio_torch import cli

    path = _mm3_mesh_config(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpusysbio_torch.cli", "--cpu",
             "multistart", "--config", str(path)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        # the one-process run, while the ranks run
        one = cli.main(["--cpu", "multistart", "--config", str(path)])[
            "record"]
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[1][0] == ""
    rec = json.loads(outs[0][0].strip().splitlines()[0])
    assert set(rec) == set(one)
    for k in rec:
        if k in ("wall_seconds", "best_cost", "top_costs"):
            continue
        assert rec[k] == one[k], k
    np.testing.assert_allclose(rec["best_cost"], one["best_cost"], rtol=1e-9)
    np.testing.assert_allclose(rec["top_costs"], one["top_costs"],
                               rtol=1e-9, atol=1e-4)
