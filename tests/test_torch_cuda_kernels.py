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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 22, 64])
def test_gj_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_newton_like(rng, 256, n), dtype=torch.float32,
                        device=cuda_device)
    before = gpu_lu.LAUNCHES["gj_inverse_f32"]
    got = gpu_lu.gj_inverse_f32(a)
    torch.cuda.synchronize()
    assert gpu_lu.LAUNCHES["gj_inverse_f32"] == before + 1
    ref = gpu_lu.gj_inverse_f32_plain(a)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_gj_kernel_singular_finite_and_nan_nonfinite(cuda_device):
    a = torch.tensor([[[1.0, 2.0], [2.0, 4.0]]], device=cuda_device)
    assert bool(torch.isfinite(gpu_lu.gj_inverse_f32(a)).all())
    b = torch.eye(3, device=cuda_device)[None].clone()
    b[0, 1, 2] = float("nan")
    assert not bool(torch.isfinite(gpu_lu.gj_inverse_f32(b)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 22, 64])
def test_refine_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_newton_like(rng, 256, n), device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((256, n)), device=cuda_device)
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
def test_wrappers_reject_bad_inputs(cuda_device):
    a = torch.eye(4, device=cuda_device).repeat(2, 1, 1)
    with pytest.raises(TypeError):
        gpu_lu.gj_inverse_f32(a.double())
    with pytest.raises(ValueError):
        gpu_lu.gj_inverse_f32(a.transpose(1, 2).contiguous()[:, :, :3])
    with pytest.raises(ValueError):
        gpu_lu.gj_inverse_f32(torch.eye(65, device=cuda_device)[None])
    with pytest.raises(ValueError):
        gpu_lu.refine_solve(a, a.double(), torch.ones(2, 4, 1,
                                                      device=cuda_device,
                                                      dtype=torch.float64))
