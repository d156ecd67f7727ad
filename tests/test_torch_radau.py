"""The port's Radau IIA stepper against the JAX package's.

Inputs are numpy arrays from a seed; the JAX side is
``jax.jit(jax.vmap(radau_solve))`` (its Pallas kernels in interpret mode
on the CPU), the port's side one batched call on the CPU, where
``linear_solver='pallas'`` runs the kernels' plain twins. Under
``'pallas'`` MAPK-22 factors its Newton matrices at n=22 and their real
2n=44 embedding; the 19-state EGFR-like cascade at n=19 and 38.

Tolerances: in f64 the step counters are equal member by member and
``ys``/``sens`` agree to 1e-9 relative to their largest value; with
``sens_precision='f32'`` the counters are equal, ``ys`` agrees to 1e-9 and
``sens`` to 1e-5. The golden MM-3 bound (1e-4) and the sensitivities
against BDF (1e-5) are tests/test_solvers.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import solvers as jsolvers
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.sens import make_sens_rhs as jmake_sens_rhs
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.linalg import gpu_lu
from tpusysbio_torch.model import library
from tpusysbio_torch.sens import make_sens_rhs
from tpusysbio_torch.solvers import STATUS_DONE, bdf_solve, radau_solve

torch.set_num_threads(1)

COUNTERS = ("status", "nsteps", "naccepted", "nrejected", "nfev", "njev",
            "nlu")


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _params(p_true, batch, scale, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(p_true)[None] * np.exp(
        rng.normal(scale=scale, size=(batch, len(p_true))))


def _assert_counters_equal(got, ref):
    for c in COUNTERS:
        np.testing.assert_array_equal(getattr(got, c).numpy(),
                                      np.asarray(getattr(ref, c)), err_msg=c)


@pytest.fixture(scope="module")
def mm3():
    """MM-3 at B=2 with its four jvp sensitivity columns, f64, 'inv'."""
    ps = _params(jlibrary.MM_TRUE_PARAMS, 2, 0.2)
    t_eval = np.linspace(0.0, 10.0, 11)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=2048)
    jm = jlibrary.michaelis_menten()

    def one(p):
        return jsolvers.radau_solve(
            lambda t, y: jm.rhs(t, y, p), (0.0, 10.0), jm.y0(p),
            jnp.asarray(t_eval), config=JSolverConfig(**kw),
            sens_rhs=jmake_sens_rhs(jm.rhs, p), s0=jnp.zeros((3, 4)))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ps)))
    tm = library.michaelis_menten(device="cpu")
    p = torch.as_tensor(ps)
    got = radau_solve(
        lambda t, y: tm.rhs(t, y, p), (0.0, 10.0), tm.y0(p),
        torch.as_tensor(t_eval), config=SolverConfig(**kw),
        sens_rhs=make_sens_rhs(tm.rhs, p),
        s0=torch.zeros((2, 3, 4), dtype=torch.float64))
    return got, ref


def test_mm3_counters_equal(mm3):
    got, ref = mm3
    _assert_counters_equal(got, ref)
    assert got.status.tolist() == [STATUS_DONE] * 2


def test_mm3_trajectories_and_sensitivities_agree(mm3):
    got, ref = mm3
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9
    assert _rel(got.sens.numpy(), ref.sens) <= 1e-9
    assert _rel(got.y_final.numpy(), ref.y_final) <= 1e-9


@pytest.fixture(scope="module")
def mapk22_pallas():
    """MAPK-22 over [0, 5] at B=2, all 30 columns in f32, ``'pallas'``;
    the port's Gauss-Jordan and refined-solve wrappers record the sizes
    they are given."""
    ps = _params(jlibrary.mapk_true_params(), 2, 0.1)
    t_eval = np.linspace(0.0, 5.0, 6)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=1024, linear_solver="pallas",
              sens_precision="f32")
    jm = jlibrary.mapk_huang_ferrell()

    def one(p):
        return jsolvers.radau_solve(
            lambda t, y: jm.rhs(t, y, p.astype(y.dtype)), (0.0, 5.0),
            jm.y0(p), jnp.asarray(t_eval), config=JSolverConfig(**kw),
            sens_rhs=lambda t, y, S: jm.rhs_sens(t, y, S, p),
            s0=jnp.zeros((22, 30)),
            jac=lambda t, y: jm.rhs_jac(t, y, p.astype(y.dtype)))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ps)))
    sizes = {"gj": set(), "refine": set()}
    gj, refine = gpu_lu.gj_inverse_f32, gpu_lu.refine_solve

    def gj_rec(a):
        sizes["gj"].add(a.shape[-1])
        return gj(a)

    def refine_rec(x32, a, b):
        sizes["refine"].add(a.shape[-1])
        return refine(x32, a, b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpu_lu, "gj_inverse_f32", gj_rec)
        mp.setattr(gpu_lu, "refine_solve", refine_rec)
        got = library.mapk_huang_ferrell(device="cpu").simulate_sensitivities(
            ps, (0.0, 5.0), t_eval, solver="radau",
            config=SolverConfig(**kw), device="cpu")
    return got, ref, sizes


def test_mapk22_pallas_counters_equal(mapk22_pallas):
    got, ref, _ = mapk22_pallas
    _assert_counters_equal(got, ref)
    assert got.status.tolist() == [STATUS_DONE] * 2


def test_mapk22_pallas_trajectories_agree(mapk22_pallas):
    got, ref, _ = mapk22_pallas
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9
    assert _rel(got.sens.numpy(), ref.sens) <= 1e-5


def test_mapk22_pallas_factors_at_n_and_2n(mapk22_pallas):
    """The real matrix at n=22 and the complex one's embedding at n=44 go
    through the Gauss-Jordan wrapper, and the f64 state column through the
    refined solve at both sizes."""
    _, _, sizes = mapk22_pallas
    assert sizes == {"gj": {22, 44}, "refine": {22, 44}}


def test_egfr_small_pallas_matches_reference():
    """The EGFR-like cascade at ``n_layers=2`` (n=19, 2n=38) under
    ``'pallas'``: the CPU stand-in of the n=99 model, whose 2n=198
    embedding takes ``gpu_lu._large_n_inverse`` on the card."""
    ps = np.asarray(jlibrary.egfr_true_params(2, 0))[None] * np.exp(
        np.random.default_rng(0).normal(scale=0.1, size=(2, 26)))
    t_eval = np.linspace(0.0, 10.0, 6)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=1024, linear_solver="pallas")
    jm = jlibrary.egfr_like(2)

    def one(p):
        return jsolvers.radau_solve(
            lambda t, y: jm.rhs(t, y, p.astype(y.dtype)), (0.0, 10.0),
            jm.y0(p), jnp.asarray(t_eval), config=JSolverConfig(**kw),
            jac=lambda t, y: jm.rhs_jac(t, y, p.astype(y.dtype)))

    ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(ps)))
    got = library.egfr_like(2, device="cpu").simulate(
        ps, (0.0, 10.0), t_eval, solver="radau", config=SolverConfig(**kw),
        device="cpu")
    _assert_counters_equal(got, ref)
    assert got.status.tolist() == [STATUS_DONE] * 2
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-9


def test_golden_mm3(golden):
    """tests/test_solvers.py's Radau MM-3 bound."""
    g = golden("mm3")
    res = library.michaelis_menten(device="cpu").simulate(
        g["p"][None], tuple(g["t_span"]), g["t_eval"], solver="radau",
        config=SolverConfig(rtol=1e-6, atol=1e-9), device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    ys = res.ys[0].numpy()
    assert np.max(np.abs(ys - g["ys"]) / (1e-7 + np.abs(g["ys"]))) < 1e-4


def test_sensitivities_match_bdf():
    """tests/test_solvers.py's Radau-against-BDF sensitivity check."""
    tm = library.michaelis_menten(device="cpu")
    p = torch.as_tensor(np.asarray(jlibrary.MM_TRUE_PARAMS))[None]
    t_eval = torch.linspace(0.0, 10.0, 6, dtype=torch.float64)
    cfg = SolverConfig(rtol=1e-8, atol=1e-11)
    kw = dict(config=cfg, sens_rhs=make_sens_rhs(tm.rhs, p),
              s0=torch.zeros((1, 3, 4), dtype=torch.float64))
    f = lambda t, y: tm.rhs(t, y, p)  # noqa: E731
    r1 = radau_solve(f, (0.0, 10.0), tm.y0(p), t_eval, **kw)
    r2 = bdf_solve(f, (0.0, 10.0), tm.y0(p), t_eval, **kw)
    assert int(r1.status[0]) == STATUS_DONE
    s_a, s_b = r1.sens.numpy(), r2.sens.numpy()
    assert np.max(np.abs(s_a - s_b)) / (1e-6 + np.max(np.abs(s_b))) < 1e-5
