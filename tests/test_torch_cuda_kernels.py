"""The port's CUDA kernels against their plain PyTorch twins, on a card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. This file imports neither jax nor the JAX package, so on a
machine with a GPU and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from tpusysbio_torch.linalg import gpu_lu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _newton_like(rng, B, n, scale=0.08):
    return np.eye(n)[None] - scale * rng.standard_normal((B, n, n))


def _gj(monkeypatch, layout, a):
    """``gj_inverse_f32`` with the module's layout switch set to ``layout``:
    K1 under 'minor', K3 under 'major'."""
    monkeypatch.setattr(gpu_lu, "_LAYOUT", layout)
    return gpu_lu.gj_inverse_f32(a)


# every width the register kernel is instantiated for (8, 16, 24, 32 with
# one row per lane; 48, 64 with two), their edges, and the paths' batches
GJ_SHAPES = [(1, 1), (7, 1), (256, 4), (16, 8), (64, 9), (256, 16),
             (16, 22), (64, 22), (256, 22), (1024, 22), (1, 24), (64, 25),
             (256, 31), (1, 32), (5, 32), (1024, 32), (1, 33), (33, 33),
             (256, 33), (64, 48), (16, 49), (1, 64), (256, 64), (1024, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", GJ_SHAPES)
def test_gj_kernel_matches_plain(cuda_device, monkeypatch, B, n):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_newton_like(rng, B, n), dtype=torch.float32,
                        device=cuda_device)
    before = gpu_lu.LAUNCHES["gj_inverse_f32"]
    got = _gj(monkeypatch, "minor", a)
    torch.cuda.synchronize()
    assert gpu_lu.LAUNCHES["gj_inverse_f32"] == before + 1
    ref = gpu_lu.gj_inverse_f32_plain(a)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["minor", "major"])
def test_gj_kernel_singular_finite_and_nan_nonfinite(cuda_device,
                                                     monkeypatch, layout):
    a = torch.tensor([[[1.0, 2.0], [2.0, 4.0]]], device=cuda_device)
    assert bool(torch.isfinite(_gj(monkeypatch, layout, a)).all())
    b = torch.eye(3, device=cuda_device)[None].clone()
    b[0, 1, 2] = float("nan")
    assert not bool(torch.isfinite(_gj(monkeypatch, layout, b)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", GJ_SHAPES)
def test_gj_major_kernel_matches_plain_and_k1(cuda_device, monkeypatch, B,
                                              n):
    """K3 (a shared-memory tile per warp) against the plain version it
    shares with K1, and against K1 (the matrix in registers): same pivots,
    same roundings, so equal to the bit."""
    rng = np.random.default_rng(100 + n)
    a = torch.as_tensor(_newton_like(rng, B, n), dtype=torch.float32,
                        device=cuda_device)
    before = dict(gpu_lu.LAUNCHES)
    got = _gj(monkeypatch, "major", a)
    torch.cuda.synchronize()
    assert gpu_lu.LAUNCHES["gj_inverse_major_f32"] == (
        before["gj_inverse_major_f32"] + 1)
    assert gpu_lu.LAUNCHES["gj_inverse_f32"] == before["gj_inverse_f32"]
    ref = gpu_lu.gj_inverse_major_f32_plain(a)
    assert float((got - ref).abs().max()) <= 1e-5
    k1 = _gj(monkeypatch, "minor", a)
    assert torch.equal(got, k1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 22, 33, 64])
def test_gj_kernels_agree_bitwise_when_rows_are_exchanged(cuda_device,
                                                          monkeypatch, n):
    """General matrices (no dominant diagonal): most pivot steps exchange
    rows, which K1 does by renaming and K3 by moving them."""
    rng = np.random.default_rng(400 + n)
    a = torch.as_tensor(rng.standard_normal((64, n, n)), dtype=torch.float32,
                        device=cuda_device)
    k1 = _gj(monkeypatch, "minor", a)
    k3 = _gj(monkeypatch, "major", a)
    assert torch.equal(k1, k3)
    eye = torch.eye(n, device=cuda_device)
    resid = (k1.double() @ a.double() - eye).abs().amax(dim=(1, 2))
    assert float(resid.median()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["minor", "major"])
def test_gj_kernel_tied_pivots_take_the_lowest_row(cuda_device, monkeypatch,
                                                   layout):
    a = torch.tensor([[[2.0, 1.0, 0.0], [-2.0, 3.0, 1.0], [2.0, 0.0, 5.0]],
                      [[0.0, 1.0, 2.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 3.0]]],
                     device=cuda_device)
    got = _gj(monkeypatch, layout, a)
    ref = gpu_lu.gj_inverse_f32_plain(a)
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_gj_kernel_needs_pivoting(cuda_device, monkeypatch):
    """A permutation matrix: every pivot step exchanges rows, and the
    store's two permutations must undo them."""
    perm = torch.tensor([3, 0, 4, 1, 2])
    a = torch.eye(5, device=cuda_device)[perm][None].contiguous()
    got = _gj(monkeypatch, "minor", a)
    assert torch.equal(got, a.transpose(1, 2))


@pytest.mark.cuda
def test_gj_major_kernel_needs_pivoting(cuda_device, monkeypatch):
    """A permutation matrix: every pivot step swaps, and the column swaps
    at the end must undo them."""
    perm = torch.tensor([3, 0, 4, 1, 2])
    a = torch.eye(5, device=cuda_device)[perm][None].contiguous()
    got = _gj(monkeypatch, "major", a)
    assert torch.equal(got, a.transpose(1, 2))


@pytest.mark.cuda
def test_layout_switch_selects_the_kernel(cuda_device, monkeypatch):
    a = torch.eye(4, device=cuda_device).repeat(3, 1, 1)
    monkeypatch.setattr(gpu_lu, "_LAYOUT", "major")
    before = dict(gpu_lu.LAUNCHES)
    gpu_lu.inverse(a.double())
    assert gpu_lu.LAUNCHES["gj_inverse_major_f32"] == (
        before["gj_inverse_major_f32"] + 1)
    assert gpu_lu.LAUNCHES["gj_inverse_f32"] == before["gj_inverse_f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 256, 1024])
@pytest.mark.parametrize("n", [1, 5, 22, 32, 33, 64])
def test_refine_kernel_matches_plain(cuda_device, n, B):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_newton_like(rng, B, n), device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((B, n)), device=cuda_device)
    x32 = gpu_lu.inverse(a.to(torch.float32))
    before = gpu_lu.LAUNCHES["refine_solve"]
    got = gpu_lu.refine_solve(x32, a, b)
    torch.cuda.synchronize()
    assert gpu_lu.LAUNCHES["refine_solve"] == before + 1
    ref = gpu_lu.refine_solve_plain(x32, a, b)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12
    lib = torch.linalg.solve(a, b)
    assert float(((got - lib).abs() / lib.abs()).max()) < 1e-9


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device, monkeypatch):
    a = torch.eye(4, device=cuda_device).repeat(2, 1, 1)
    with pytest.raises(TypeError):
        gpu_lu.gj_inverse_f32(a.double())
    with pytest.raises(ValueError):
        gpu_lu.gj_inverse_f32(a.transpose(1, 2).contiguous()[:, :, :3])
    for layout in ("minor", "major"):
        with pytest.raises(ValueError):
            _gj(monkeypatch, layout, torch.eye(65, device=cuda_device)[None])
    with pytest.raises(ValueError):
        gpu_lu.gj_inverse_f32(a.transpose(1, 2))          # not contiguous
    b = torch.ones(2, 4, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        gpu_lu.refine_solve(a, a.double(), b[:, :, None])  # shape
    with pytest.raises(ValueError):
        gpu_lu.refine_solve(a.cpu(), a.double(), b)        # device
    with pytest.raises(TypeError):
        gpu_lu.refine_solve(a.double(), a.double(), b)     # dtype
    with pytest.raises(TypeError):
        gpu_lu.refine_solve(a, a.double(), b.float())
    with pytest.raises(ValueError):
        gpu_lu.refine_solve(a, a.double().transpose(1, 2), b)
    with pytest.raises(ValueError):
        gpu_lu.refine_solve(a, a.double(), b.as_strided((2, 4), (1, 2)))
    before = dict(gpu_lu.LAUNCHES)
    gpu_lu.refine_solve(a, a.double(), b)
    torch.cuda.synchronize()
    assert gpu_lu.LAUNCHES["refine_solve"] == before["refine_solve"] + 1
