"""The port's Newton linear algebra (``tpusysbio_torch/linalg``) against
the reference's ``pallas_lu`` (Pallas in interpret mode on the CPU).

On the CPU the K1 and K2 wrappers run their plain PyTorch twins; the
kernels themselves are compared with those twins on the card by
``tests/test_torch_cuda_kernels.py`` and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.linalg import pallas_lu
from tpusysbio_torch.linalg import gpu_lu, lu, make_linear_solver

torch.set_num_threads(1)


def _newton_like(rng, B, n, scale=0.08):
    return np.eye(n)[None] - scale * rng.standard_normal((B, n, n))


# --------------------------------------------------------------------------
# K1: Gauss-Jordan inverse
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 22])
def test_gj_plain_matches_reference_kernel(n):
    """Same algorithm as the Pallas kernel; only the order of f32 rounding
    differs (XLA contracts multiply-adds)."""
    rng = np.random.default_rng(n)
    a = _newton_like(rng, 6, n).astype(np.float32)
    ref = np.asarray(pallas_lu._gj_inverse_f32(jnp.asarray(a),
                                               interpret=True))
    got = gpu_lu.gj_inverse_f32(torch.as_tensor(a)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-5


@pytest.mark.parametrize("layout", ["minor", "major"])
def test_gj_plain_matches_both_reference_layouts(monkeypatch, layout):
    """K3 (the batch-major layout, ``TPUSYSBIO_GJ_LAYOUT=major``) computes
    K1's function: K1's plain twin agrees with both layouts. The layout is
    read while tracing, so the unjitted function is called."""
    monkeypatch.setattr(pallas_lu, "_LAYOUT", layout)
    rng = np.random.default_rng(11)
    a = _newton_like(rng, 5, 22).astype(np.float32)
    ref = np.asarray(pallas_lu._gj_inverse_f32.__wrapped__(
        jnp.asarray(a), interpret=True))
    got = gpu_lu.gj_inverse_f32(torch.as_tensor(a)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-5


@pytest.mark.parametrize("layout", ["minor", "major", None])
def test_layout_switch_on_the_cpu_takes_the_plain_version(monkeypatch,
                                                          layout):
    """On CPU tensors both values of the switch (the module's ``_LAYOUT``
    read from ``TPUSYSBIO_GJ_LAYOUT``), and the value the environment gave,
    give the one plain version that K1 and K3 share, and count no launch."""
    rng = np.random.default_rng(12)
    a = torch.as_tensor(_newton_like(rng, 5, 22), dtype=torch.float32)
    ref = gpu_lu.gj_inverse_f32_plain(a)
    assert gpu_lu.gj_inverse_major_f32_plain is gpu_lu.gj_inverse_f32_plain
    gpu_lu.reset_launches()
    if layout is not None:
        monkeypatch.setattr(gpu_lu, "_LAYOUT", layout)
    got = gpu_lu.gj_inverse_f32(a)
    assert torch.equal(got, ref)
    assert set(gpu_lu.LAUNCHES) == {"gj_inverse_f32", "refine_solve",
                                    "gj_inverse_major_f32"}
    assert set(gpu_lu.LAUNCHES.values()) == {0}


def test_layout_switch_is_read_from_the_environment():
    """``_LAYOUT`` is read once at import, as the reference reads it."""
    import importlib
    import os
    from unittest import mock

    try:
        with mock.patch.dict(os.environ, {"TPUSYSBIO_GJ_LAYOUT": "major"}):
            assert importlib.reload(gpu_lu)._LAYOUT == "major"
    finally:
        with mock.patch.dict(os.environ):
            os.environ.pop("TPUSYSBIO_GJ_LAYOUT", None)
            assert importlib.reload(gpu_lu)._LAYOUT == "minor"


@pytest.mark.parametrize("layout", ["minor", "major"])
def test_schur_inverse_under_both_layouts(monkeypatch, layout):
    """n = 97 goes through the wrapper twice whatever the layout."""
    monkeypatch.setattr(gpu_lu, "_LAYOUT", layout)
    calls = []
    real = gpu_lu.gj_inverse_f32
    monkeypatch.setattr(gpu_lu, "gj_inverse_f32",
                        lambda a: calls.append(a.shape[-1]) or real(a))
    rng = np.random.default_rng(13)
    a = torch.as_tensor(np.eye(97)[None] - 0.05 * rng.normal(size=(2, 97,
                                                                   97)))
    x = gpu_lu.inverse(a)
    assert calls == [64, 33]
    assert float(torch.max(torch.abs(x @ a - torch.eye(
        97, dtype=a.dtype)))) < 1e-11


@pytest.mark.parametrize("n", [4, 22, 97])
def test_inverse_accuracy(n):
    """Mirrors tests/test_pallas.py::test_inverse_accuracy (n=97 takes
    the block-Schur path with K1 on both sub-blocks)."""
    rng = np.random.default_rng(n)
    a = torch.as_tensor(rng.normal(size=(n, n)))
    x = gpu_lu.inverse(a)
    assert float(torch.max(torch.abs(x @ a - torch.eye(n,
                                                        dtype=a.dtype)))) < 1e-11


def test_schur_inverse_newton_matrix_batched():
    rng = np.random.default_rng(1)
    n, B = 97, 4
    a = torch.as_tensor(np.eye(n)[None] - 0.05 * rng.normal(size=(B, n, n)))
    x = gpu_lu.inverse(a)
    assert float(torch.max(torch.abs(x @ a - torch.eye(n,
                                                        dtype=a.dtype)))) < 1e-11


def test_large_n_lu_fallback():
    """n = 133 > 2*MAX_KERNEL_N: f32 LU + refinement."""
    rng = np.random.default_rng(2)
    n = 2 * gpu_lu.MAX_KERNEL_N + 5
    a = torch.as_tensor(np.eye(n) - 0.05 * rng.normal(size=(n, n)))
    x = gpu_lu.inverse(a)
    assert float(torch.max(torch.abs(x @ a - torch.eye(n,
                                                        dtype=a.dtype)))) < 1e-11


def test_inverse_needs_pivoting():
    a = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=torch.float64)
    np.testing.assert_allclose(gpu_lu.inverse(a).numpy(),
                               [[0.0, 1.0], [1.0, 0.0]], atol=1e-12)


def test_gj_singular_gives_finite_output():
    """Zero pivots become ±1e-30: finite wrong answer, never inf/NaN."""
    a = torch.tensor([[[1.0, 2.0], [2.0, 4.0]]], dtype=torch.float32)
    assert bool(torch.isfinite(gpu_lu.gj_inverse_f32(a)).all())
    ref = np.asarray(pallas_lu._gj_inverse_f32(jnp.asarray(a.numpy()),
                                               interpret=True))
    assert np.isfinite(ref).all()


def test_gj_nan_input_gives_nonfinite_output():
    a = torch.eye(3, dtype=torch.float32)[None].clone()
    a[0, 1, 2] = float("nan")
    assert not bool(torch.isfinite(gpu_lu.gj_inverse_f32(a)).all())


# --------------------------------------------------------------------------
# K2: refined f64 solve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 22, 30])
def test_solve_refined_accuracy_and_reference(n):
    rng = np.random.default_rng(n)
    a = _newton_like(rng, 48, n)
    b = rng.standard_normal((48, n, 1))
    y = gpu_lu.solve_refined(gpu_lu.factor_for_solve(torch.as_tensor(a)),
                             torch.as_tensor(b))
    assert y.dtype == torch.float64
    y = y.numpy()
    y_np = np.linalg.solve(a, b)
    assert np.max(np.abs(y - y_np) / (np.abs(y_np) + 1e-30)) < 1e-9
    jfact = pallas_lu.factor_for_solve(jnp.asarray(a))
    y_ref = np.asarray(pallas_lu.solve_refined(jfact, jnp.asarray(b)))
    assert np.max(np.abs(y - y_ref)) / np.max(np.abs(y_ref)) <= 1e-11


def test_solve_refined_steps_above_kernel_fall_through(monkeypatch):
    """``steps`` <= 3 goes to the K2 wrapper (its 3 rounds make ``steps`` a
    minimum); more rounds run exactly, in plain PyTorch."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(_newton_like(rng, 4, 9))
    b = torch.as_tensor(rng.standard_normal((4, 9, 1)))
    fact = gpu_lu.factor_for_solve(a)
    calls = []
    real = gpu_lu.refine_solve
    monkeypatch.setattr(gpu_lu, "refine_solve",
                        lambda *args: calls.append(1) or real(*args))
    y3 = gpu_lu.solve_refined(fact, b, steps=3)
    assert calls == [1]
    y5 = gpu_lu.solve_refined(fact, b, steps=5)
    assert calls == [1]
    np.testing.assert_allclose(y5.numpy(), y3.numpy(), rtol=0, atol=1e-13)


def test_solve_refined_f32_rhs_is_one_matmul():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(_newton_like(rng, 3, 7))
    b = torch.as_tensor(rng.standard_normal((3, 7, 5)), dtype=torch.float32)
    x32, _ = fact = gpu_lu.factor_for_solve(a)
    y = gpu_lu.solve_refined(fact, b)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x32 @ b, rtol=0, atol=0)


def test_cpu_tensors_leave_launch_counters_at_zero():
    gpu_lu.reset_launches()
    rng = np.random.default_rng(5)
    a = torch.as_tensor(_newton_like(rng, 2, 6))
    fact = gpu_lu.factor_for_solve(a)
    gpu_lu.solve_refined(fact, torch.as_tensor(rng.standard_normal((2, 6,
                                                                     1))))
    assert gpu_lu.LAUNCHES == {"gj_inverse_f32": 0, "refine_solve": 0,
                               "gj_inverse_major_f32": 0}


# --------------------------------------------------------------------------
# Newton solver kinds and the plain LU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lu", "inv", "inv32", "pallas"])
def test_linear_solver_kinds_solve(kind):
    rng = np.random.default_rng(6)
    a = _newton_like(rng, 5, 11)
    b = rng.standard_normal((5, 11, 3))
    factor, solve = make_linear_solver(kind)
    x = solve(factor(torch.as_tensor(a)), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=0,
                               atol=1e-11)


def test_lu_pivots_match_reference():
    from tpusysbio.linalg import lu as jlu

    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 8, 8))
    lu_t, piv_t = lu.lu_factor(torch.as_tensor(a))
    for i in range(3):
        lu_j, piv_j = jlu.lu_factor(jnp.asarray(a[i]))
        np.testing.assert_array_equal(piv_t[i].numpy(), np.asarray(piv_j))
        np.testing.assert_allclose(lu_t[i].numpy(), np.asarray(lu_j),
                                   rtol=1e-12, atol=1e-13)


def test_banded_kind_is_queued():
    with pytest.raises(NotImplementedError):
        make_linear_solver("banded", (1, 1))
