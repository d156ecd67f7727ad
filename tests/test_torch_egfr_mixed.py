"""The f32 screening stepper (``mixed_precision=True``) at n=99 against the
JAX reference.

The EGFR-scale model (``egfr_like(n_layers=12)``: 99 species, 146
constants) at the screening configuration of its two-phase fit (rtol=1e-3,
atol=1e-6, ``linear_solver='pallas'``, ``mixed_precision=True``), with the
11 θ-direction sensitivity columns of the fit problem, at B=2. Every
factorization of the f32 Newton matrix goes through the block-Schur
inverse (``gpu_lu._schur_inverse``: Gauss-Jordan at n=64, then at n=35);
on the CPU the port's wrapper takes its plain version, the reference runs
its Pallas kernel in interpret mode. One compile of the reference, whose
horizon is a traced argument.

As in tests/test_torch_bdf_mixed.py: over the start-up phase (a few dozen
steps) the counters are identical member by member and the trajectories
agree to the f32 level (1e-5 relative); over the fit's whole horizon the
counters agree within 5 steps, since XLA's fused loops and PyTorch's
separate ops round the f32 error estimate differently, and the
trajectories agree well inside rtol=1e-3 (1e-3 relative).
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
from tpusysbio_torch.linalg import gpu_lu
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import STATUS_DONE, bdf_solve

torch.set_num_threads(1)

B = 2
FREE_PREFIXES = ("L+Rec", "LR+A0_0", "LR+A0_1", "P0+A0_1")
SCREEN_KW = dict(rtol=1e-3, atol=1e-6, max_steps=256,
                 linear_solver="pallas", mixed_precision=True)
T_END, N_T = 10.0, 9
T_SHORT = 0.05


def _inputs():
    """Per member the rate constants (the true set spread log-normally,
    seed 0) and the chain C = dp/dθ over the 11 free constants."""
    jm = jlibrary.egfr_like(12)
    rng = np.random.default_rng(0)
    p = jlibrary.egfr_true_params(12)[None] * np.exp(
        rng.normal(scale=0.1, size=(B, jm.n_params)))
    free = [i for i, n in enumerate(jm.param_names)
            if n.startswith(FREE_PREFIXES)]
    C = np.zeros((B, jm.n_params, len(free)))
    for g, j in enumerate(free):
        C[:, j, g] = p[:, j]
    return p, C


def _grid(t_end):
    return np.linspace(t_end / N_T, t_end, N_T)


@pytest.fixture(scope="module")
def reference():
    jm = jlibrary.egfr_like(12)
    cfg = JSolverConfig(**SCREEN_KW)

    def integrate(pp, cc, t_end):
        res = jsolvers.bdf_solve(
            lambda t, y: jm.rhs(t, y, pp.astype(y.dtype)), (0.0, t_end),
            jm.y0(pp), jnp.asarray(_grid(1.0)) * t_end, config=cfg,
            sens_rhs=lambda t, y, S: jm.rhs_sens_dir(t, y, S, pp, cc),
            s0=jnp.zeros((jm.n_states, cc.shape[-1]), pp.dtype),
            jac=lambda t, y: jm.rhs_jac(t, y, pp.astype(y.dtype)))
        return res._replace(order_hist=None, t_final=None, y_final=None)

    p, C = _inputs()
    fn = jax.jit(jax.vmap(integrate, in_axes=(0, 0, None)))
    return lambda t_end: jax.tree.map(
        np.asarray, fn(jnp.asarray(p), jnp.asarray(C), jnp.asarray(t_end)))


def _port(t_end, monkeypatch=None):
    tm = library.egfr_like(12, device="cpu")
    p, C = _inputs()
    pt, Ct = torch.as_tensor(p), torch.as_tensor(C)
    return bdf_solve(
        lambda t, y: tm.rhs(t, y, pt.to(y.dtype)), (0.0, t_end), tm.y0(pt),
        torch.as_tensor(_grid(t_end)), config=SolverConfig(**SCREEN_KW),
        sens_rhs=lambda t, y, S: tm.rhs_sens_dir(t, y, S, pt, Ct),
        s0=torch.zeros((B, tm.n_states, C.shape[-1]), dtype=torch.float64),
        jac=lambda t, y: tm.rhs_jac(t, y, pt.to(y.dtype)))


@pytest.fixture(scope="module")
def short_run(reference):
    return _port(T_SHORT), reference(T_SHORT)


@pytest.fixture(scope="module")
def full_run(reference):
    return _port(T_END), reference(T_END)


COUNTERS = ("status", "nsteps", "naccepted", "nrejected", "nlu", "nfev",
            "njev")


@pytest.mark.parametrize("counter", COUNTERS)
def test_startup_counters_identical(short_run, counter):
    got, ref = short_run
    assert got.status.tolist() == [STATUS_DONE] * B
    assert int(got.nsteps.min()) >= 10
    np.testing.assert_array_equal(getattr(got, counter).numpy(),
                                  getattr(ref, counter))


def test_startup_outputs_are_f32_and_agree(short_run):
    got, ref = short_run
    assert got.ys.dtype == torch.float32 == got.sens.dtype
    assert got.ys.shape == ref.ys.shape == (B, N_T, 99)
    assert got.sens.shape == ref.sens.shape == (B, N_T, 99, 11)
    assert np.max(np.abs(got.ys.numpy() - ref.ys)) / np.max(
        np.abs(ref.ys)) <= 1e-5
    assert np.max(np.abs(got.sens.numpy() - ref.sens)) / np.max(
        np.abs(ref.sens)) <= 1e-4


@pytest.mark.parametrize("counter", ["nsteps", "naccepted", "nrejected",
                                     "nlu"])
def test_full_horizon_counters_close(full_run, counter):
    got, ref = full_run
    assert got.status.tolist() == [STATUS_DONE] * B
    np.testing.assert_array_equal(ref.status, [STATUS_DONE] * B)
    a = getattr(got, counter).numpy().astype(int)
    b = getattr(ref, counter).astype(int)
    assert np.all(np.abs(a - b) <= 5), (a, b)


def test_full_horizon_outputs_agree(full_run):
    got, ref = full_run
    assert np.max(np.abs(got.ys.numpy() - ref.ys)) / np.max(
        np.abs(ref.ys)) <= 1e-3
    assert np.max(np.abs(got.sens.numpy() - ref.sens)) / np.max(
        np.abs(ref.sens)) <= 1e-2


def test_f32_factorizations_go_through_block_schur(monkeypatch):
    """Every f32 factorization of the 99 x 99 Newton matrix hands the
    Gauss-Jordan wrapper a 64 block, then a 35 block, in f32."""
    seen = []
    real = gpu_lu.gj_inverse_f32
    monkeypatch.setattr(gpu_lu, "gj_inverse_f32", lambda a: seen.append(
        (a.shape[-1], a.dtype)) or real(a))
    res = _port(2e-3)
    assert res.status.tolist() == [STATUS_DONE] * B
    assert seen and len(seen) % 2 == 0
    assert seen == [(64, torch.float32), (35, torch.float32)] * (
        len(seen) // 2)
