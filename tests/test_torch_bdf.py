"""The port's main path against the JAX reference and the golden fixtures.

The bench contract (``bench.py``: MAPK-22, BDF with all 30 forward
sensitivities, rtol=1e-6, atol=1e-9, ``sens_precision='f32'``,
``dense_f32``, ``linear_solver='pallas'``, a 41-point ``t_eval``) at B=4:
the first four members of the seed-0 log-normal spread go through
``jax.jit(jax.vmap(integrate))`` and through the port's batched
``bdf_solve`` on the CPU, where the port's kernels run their plain
PyTorch twins and the reference's Pallas kernels run in interpret mode.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import solvers as jsolvers
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio_torch import SolverConfig, trace
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import STATUS_DONE, bdf_solve

torch.set_num_threads(1)

B = 4
T_SPAN = (0.0, 100.0)
BENCH_KW = dict(rtol=1e-6, atol=1e-9, max_steps=1024, linear_solver="pallas",
                sens_precision="f32", dense_f32=True)


def _bench_params(batch):
    """bench.py's spread: seed 0, log-normal with scale 0.1."""
    p_true = jlibrary.mapk_true_params()
    rng = np.random.default_rng(0)
    ps = p_true[None, :] * np.exp(rng.normal(scale=0.1, size=(256, 30)))
    return ps[:batch]


@pytest.fixture(scope="module")
def reference():
    """The reference's bench integrate, vmapped, compiled once."""
    model = jlibrary.mapk_huang_ferrell()
    t_eval = jnp.linspace(*T_SPAN, 41)
    cfg = JSolverConfig(**BENCH_KW)

    def integrate(p):
        sens_rhs = lambda t, y, S: model.rhs_sens(t, y, S, p)  # noqa: E731
        jac = lambda t, y: model.rhs_jac(t, y, p.astype(y.dtype))  # noqa: E731
        s0 = jnp.zeros((model.n_states, model.n_params), p.dtype)
        res = jsolvers.bdf_solve(
            lambda t, y: model.rhs(t, y, p.astype(y.dtype)), T_SPAN,
            model.y0(p), t_eval, config=cfg, sens_rhs=sens_rhs, s0=s0,
            jac=jac)
        return res._replace(order_hist=None, t_final=None, y_final=None)

    out = jax.jit(jax.vmap(integrate))(jnp.asarray(_bench_params(B)))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def port():
    model = library.mapk_huang_ferrell(device="cpu")
    trace.reset()
    res = model.simulate_sensitivities(
        _bench_params(B), T_SPAN, np.linspace(*T_SPAN, 41),
        config=SolverConfig(**BENCH_KW), device="cpu")
    launches = {k: v for k, v in trace.counters().items()
                if k.startswith("gpu_lu.")}
    return res, launches


def test_bench_contract_all_members_done(port):
    res, _ = port
    assert res.status.tolist() == [STATUS_DONE] * B


@pytest.mark.parametrize("counter",
                         ["nsteps", "naccepted", "nrejected", "nlu"])
def test_bench_contract_step_counts_identical(reference, port, counter):
    """Same algorithm, CPU f64 on both sides: the same step sequence."""
    res, _ = port
    np.testing.assert_array_equal(getattr(res, counter).numpy(),
                                  getattr(reference, counter))


def test_bench_contract_trajectories_agree(reference, port):
    res, _ = port
    ys, ref = res.ys.numpy(), reference.ys
    assert ys.shape == ref.shape == (B, 41, 22)
    assert np.max(np.abs(ys - ref)) / np.max(np.abs(ref)) <= 1e-9


def test_bench_contract_sensitivities_agree(reference, port):
    """The sensitivity columns live in f32 on both sides."""
    res, _ = port
    sens, ref = res.sens.numpy(), reference.sens
    assert sens.shape == ref.shape == (B, 41, 22, 30)
    assert np.max(np.abs(sens - ref)) / np.max(np.abs(ref)) <= 1e-4


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL = {"batch", "best_batch_seconds", "compile_seconds",
                "compile_cache_hit", "ok_members", "backend", "mean_nsteps"}


def test_bench_main_on_the_cpu(reference, monkeypatch, capsys):
    """``tpusysbio_torch.bench.main(device="cpu")`` at B=4, one repeat:
    ``bench.py``'s members and keys, every member done, and the mean step
    count of the reference's bench integrate on the same 4 members."""
    from tpusysbio_torch import bench

    for knob in ("SOLVER", "SENS_PREC", "STEPPER", "NT", "DENSE_WINDOW"):
        monkeypatch.delenv(f"TPUSYSBIO_BENCH_{knob}", raising=False)
    monkeypatch.setenv("TPUSYSBIO_BENCH_BATCH", str(B))
    monkeypatch.setenv("TPUSYSBIO_BENCH_REPEATS", "1")
    p_true = library.mapk_true_params(device="cpu").numpy()
    np.testing.assert_array_equal(bench.members(p_true, B),
                                  _bench_params(B))
    rec = bench.main(device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    assert set(rec) == BENCH_KEYS and set(rec["detail"]) == BENCH_DETAIL
    d = rec["detail"]
    assert (d["batch"], d["ok_members"], d["backend"]) == (B, B, "cpu")
    assert d["compile_cache_hit"] is None
    assert d["mean_nsteps"] == float(reference.nsteps.mean())
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["unit"] == "integrations/sec/chip"


def test_cpu_run_launches_no_kernel(port):
    """On CPU tensors the wrappers take their plain twins."""
    _, launches = port
    assert launches == {}


@pytest.mark.parametrize("prec,dense,bound", [
    ("f32", True, 5e-5), ("full", False, 2e-5)])
def test_golden_mapk22_sens(golden, prec, dense, bound):
    """The reference's own bounds (tests/test_sens.py) against the
    rtol=1e-9 SciPy augmented-system fixture."""
    g = golden("mapk22_sens")
    model = library.mapk_huang_ferrell(device="cpu")
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=1024,
                       linear_solver="pallas", sens_precision=prec,
                       dense_f32=dense)
    res = model.simulate_sensitivities(g["p"][None], tuple(g["t_span"]),
                                       g["t_eval"], config=cfg, device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    sens, ref = res.sens[0].numpy(), g["sens"]
    norm_err = np.max(np.abs(sens - ref)) / np.max(np.abs(ref))
    traj_err = (np.max(np.abs(res.ys[0].numpy() - g["ys"]))
                / np.max(np.abs(g["ys"])))
    assert traj_err < 2e-6, (prec, traj_err)
    assert norm_err < bound, (prec, norm_err)


@pytest.mark.parametrize("linear_solver", ["inv", "pallas"])
def test_golden_mapk22_trajectory(golden, linear_solver):
    """``simulate`` with no sensitivities (m = 0) against the mapk22
    fixture, with the bounds of tests/test_solvers.py."""
    g = golden("mapk22")
    model = library.mapk_huang_ferrell(device="cpu")
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=2048,
                       linear_solver=linear_solver)
    res = model.simulate(g["p"][None], tuple(g["t_span"]), g["t_eval"],
                         config=cfg, device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    ys = res.ys[0].numpy()
    assert np.max(np.abs(ys - g["ys"]) / (1e-9 + np.abs(g["ys"]))) < 2e-4
    assert int(res.nsteps[0]) < 600
    assert res.sens.shape == (1, 41, 22, 0)


def test_jacfwd_fallback_matches_closed_form_jacobian():
    """``jac=None`` takes forward-mode AD of the batched RHS; it must give
    the closed-form Jacobian's step sequence on a short MAPK-22 run."""
    model = library.mapk_huang_ferrell(device="cpu")
    p = torch.as_tensor(_bench_params(2))
    y0 = model.y0(p)
    t_eval = torch.linspace(0.0, 5.0, 6, dtype=torch.float64)
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=512)
    f = lambda t, y: model.rhs(t, y, p)  # noqa: E731
    ad = bdf_solve(f, (0.0, 5.0), y0, t_eval, config=cfg)
    cf = bdf_solve(f, (0.0, 5.0), y0, t_eval, config=cfg,
                   jac=lambda t, y: model.rhs_jac(t, y, p))
    assert ad.status.tolist() == [STATUS_DONE] * 2
    np.testing.assert_array_equal(ad.nsteps.numpy(), cf.nsteps.numpy())
    np.testing.assert_allclose(ad.ys.numpy(), cf.ys.numpy(), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("kw", [dict(linear_solver="banded",
                                     jac_bandwidth=(14, 14)),
                                dict(dense_window=4)])
def test_unported_options_raise(kw):
    """Both options are ported since. ``dense_window``: where its step cap
    binds it stays within rtol 1e-5 of the full grid
    (tests/test_torch_dense_window.py holds it against the reference).
    ``linear_solver='banded'`` (ROADMAP item 13) at MAPK-22's bandwidth
    (14, 14) (its Jacobian's, in the library's species order): the
    unpivoted banded LU of the Newton matrix, within rtol 1e-5 of the
    default run (tests/test_torch_banded.py holds the solver against the
    reference)."""
    model = library.mapk_huang_ferrell(device="cpu")
    t_eval = np.linspace(*T_SPAN, 41)
    got = model.simulate(_bench_params(1), T_SPAN, t_eval,
                         config=SolverConfig(**kw), device="cpu")
    full = model.simulate(_bench_params(1), T_SPAN, t_eval,
                          config=SolverConfig(), device="cpu")
    assert got.status.tolist() == full.status.tolist() == [STATUS_DONE]
    np.testing.assert_allclose(got.ys.numpy(), full.ys.numpy(),
                               rtol=1e-5, atol=1e-9)
