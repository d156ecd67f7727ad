"""The port's CUDA kernels against their plain PyTorch twins, on a card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. This file imports neither jax nor the JAX package, so on a
machine with a GPU and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from tpusysbio_torch import trace
from tpusysbio_torch.linalg import gpu_lu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _newton_like(rng, B, n, scale=0.08):
    return np.eye(n)[None] - scale * rng.standard_normal((B, n, n))


def _launches():
    """Launches counted by kernel, as ``trace.counters()`` holds them."""
    counts = trace.counters()
    return {k: counts.get("gpu_lu." + k, 0) for k in gpu_lu.KERNELS}


def _gj(monkeypatch, layout, a):
    """``gj_inverse_f32`` with the module's layout switch set to ``layout``:
    K1 under 'minor', K3 under 'major'."""
    monkeypatch.setattr(gpu_lu, "_LAYOUT", layout)
    return gpu_lu.gj_inverse_f32(a)


# every width the register kernels are instantiated for (K1: 8, 16, 24, 32
# with one row per lane, 40 to 64 with two; K3: groups of 8 lanes up to 24,
# of 16 up to 40, of 32 beyond), their edges, the paths' batches (the
# block-Schur shapes (64, 64) and (64, 35) of the 99-state model among
# them), batches that leave K3's last warp with groups that have no matrix
# (B not a multiple of 4 or 2), and batches on both sides of the warp count
# from which K3 stages its matrices through shared memory
GJ_SHAPES = [(1, 1), (7, 1), (256, 4), (16, 8), (64, 9), (256, 16),
             (16, 22), (64, 22), (67, 22), (256, 22), (401, 22), (1024, 22),
             (4096, 22), (1, 24), (64, 25), (256, 31), (1, 32), (5, 32),
             (1024, 32), (1, 33), (33, 33), (256, 33), (64, 35), (201, 35),
             (3, 40), (64, 41), (64, 48), (16, 49), (1, 64), (64, 64),
             (256, 64), (1024, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", GJ_SHAPES)
def test_gj_kernel_matches_plain(cuda_device, monkeypatch, B, n):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_newton_like(rng, B, n), dtype=torch.float32,
                        device=cuda_device)
    before = _launches()["gj_inverse_f32"]
    got = _gj(monkeypatch, "minor", a)
    torch.cuda.synchronize()
    assert _launches()["gj_inverse_f32"] == before + 1
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
    """K3 (a group of lanes per matrix, several matrices a warp) against
    the plain version it shares with K1, and against K1 (a warp per
    matrix): same pivots, same roundings, so equal to the bit."""
    rng = np.random.default_rng(100 + n)
    a = torch.as_tensor(_newton_like(rng, B, n), dtype=torch.float32,
                        device=cuda_device)
    before = _launches()
    got = _gj(monkeypatch, "major", a)
    torch.cuda.synchronize()
    assert _launches()["gj_inverse_major_f32"] == (
        before["gj_inverse_major_f32"] + 1)
    assert _launches()["gj_inverse_f32"] == before["gj_inverse_f32"]
    ref = gpu_lu.gj_inverse_major_f32_plain(a)
    assert float((got - ref).abs().max()) <= 1e-5
    k1 = _gj(monkeypatch, "minor", a)
    assert torch.equal(got, k1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 22, 33, 35, 64])
def test_gj_kernels_agree_bitwise_when_rows_are_exchanged(cuda_device,
                                                          monkeypatch, n):
    """General matrices (no dominant diagonal): most pivot steps exchange
    rows, and the matrices that share a K3 warp pivot on different rows."""
    rng = np.random.default_rng(400 + n)
    a = torch.as_tensor(rng.standard_normal((66, n, n)), dtype=torch.float32,
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
    """A permutation matrix: every pivot step exchanges rows, and the
    store's two permutations must undo them, in a group of 8 lanes."""
    perm = torch.tensor([3, 0, 4, 1, 2])
    a = torch.eye(5, device=cuda_device)[perm][None].contiguous()
    got = _gj(monkeypatch, "major", a)
    assert torch.equal(got, a.transpose(1, 2))


@pytest.mark.cuda
def test_gj_major_kernel_nan_member_leaves_its_warp_alone(cuda_device,
                                                          monkeypatch):
    """Four n=22 matrices share a K3 warp and its instruction stream: a
    NaN in one of them must not reach the others."""
    rng = np.random.default_rng(9)
    a = torch.as_tensor(_newton_like(rng, 6, 22), dtype=torch.float32,
                        device=cuda_device)
    clean = _gj(monkeypatch, "major", a)
    a[2, 3, 4] = float("nan")
    got = _gj(monkeypatch, "major", a)
    keep = [0, 1, 3, 4, 5]
    assert torch.equal(got[keep], clean[keep])
    assert not bool(torch.isfinite(got[2]).all())


@pytest.mark.cuda
def test_gj_major_division_rounds_as_fdiv_rn(cuda_device):
    """K3's branch-free division against ``__fdiv_rn`` bit for bit, over
    all exponents, both zeros, infinities and NaN."""
    from tpusysbio_torch.linalg import _build

    rng = np.random.default_rng(10)
    count = 1 << 20

    def wide():
        with np.errstate(over="ignore"):
            x = np.ldexp(rng.uniform(1.0, 2.0, count),
                         rng.integers(-150, 130, count)).astype(np.float32)
        x *= rng.choice([-1.0, 1.0], count).astype(np.float32)
        for value in (0.0, -0.0, np.inf, np.nan):
            x[rng.integers(0, count, count // 64)] = value
        return torch.as_tensor(x, device=cuda_device)

    x, b = wide(), wide()
    b[::2] = torch.as_tensor(np.ldexp(1.5, rng.integers(-30, 30, count // 2))
                             .astype(np.float32), device=cuda_device)
    got, ref = torch.empty_like(x), torch.empty_like(x)
    err = _build.load().tsb_gj_major_divide_check(
        x.data_ptr(), b.data_ptr(), got.data_ptr(), ref.data_ptr(), count,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    same = ((got.view(torch.int32) == ref.view(torch.int32))
            | (got.isnan() & ref.isnan()))
    assert bool(same.all())


@pytest.mark.cuda
def test_gj_launches_are_counted_by_size(cuda_device, monkeypatch):
    """Block-Schur elimination at n=99 launches the kernel of the layout
    once at n=64 and once at n=35, counted by size."""
    rng = np.random.default_rng(11)
    a = torch.as_tensor(np.eye(99)[None] - 0.05 * rng.standard_normal(
        (3, 99, 99)), device=cuda_device)
    for layout, name in (("minor", "gj_inverse_f32"),
                         ("major", "gj_inverse_major_f32")):
        monkeypatch.setattr(gpu_lu, "_LAYOUT", layout)
        trace.reset()
        x = gpu_lu.inverse(a)
        assert _launches()[name] == 2
        assert {k: v for k, v in trace.counters().items()
                if k.startswith(f"gpu_lu.{name}.n")} == {
            f"gpu_lu.{name}.n64": 1, f"gpu_lu.{name}.n35": 1}
        eye = torch.eye(99, dtype=a.dtype, device=cuda_device)
        assert float((x @ a - eye).abs().max()) < 1e-11


@pytest.mark.cuda
def test_layout_switch_selects_the_kernel(cuda_device, monkeypatch):
    a = torch.eye(4, device=cuda_device).repeat(3, 1, 1)
    monkeypatch.setattr(gpu_lu, "_LAYOUT", "major")
    before = _launches()
    gpu_lu.inverse(a.double())
    assert _launches()["gj_inverse_major_f32"] == (
        before["gj_inverse_major_f32"] + 1)
    assert _launches()["gj_inverse_f32"] == before["gj_inverse_f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 256, 1024])
@pytest.mark.parametrize("n", [1, 5, 22, 32, 33, 64])
def test_refine_kernel_matches_plain(cuda_device, n, B):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_newton_like(rng, B, n), device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((B, n)), device=cuda_device)
    x32 = gpu_lu.inverse(a.to(torch.float32))
    before = _launches()["refine_solve"]
    got = gpu_lu.refine_solve(x32, a, b)
    torch.cuda.synchronize()
    assert _launches()["refine_solve"] == before + 1
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
    before = _launches()
    gpu_lu.refine_solve(a, a.double(), b)
    torch.cuda.synchronize()
    assert _launches()["refine_solve"] == before["refine_solve"] + 1


# --------------------------------------------------------------------------
# Real Newton matrices of the small library models (n = 2, 3, 4, 6)
# --------------------------------------------------------------------------

# model -> (library constructor, fixture whose trajectory gives the states)
SMALL_MODELS = {"lotka_volterra": "lotka", "michaelis_menten": "mm3",
                "jak_stat": "jakstat", "repressilator": "repressilator"}


def _small_newton(constructor, fixture, B, device):
    """I - cJ at states along the model's golden trajectory, parameters
    log-normal around the fixture's and c log-uniform in [1e-3, 3]; J by
    forward-mode AD."""
    import os

    from tpusysbio_torch.model import library

    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             f"{fixture}.npz"))
    model = getattr(library, constructor)(device=device)
    rng = np.random.default_rng(len(constructor) + B)
    y = g["ys"][rng.integers(0, len(g["ys"]), B)]
    p = g["p"][None] * np.exp(rng.normal(scale=0.2,
                                         size=(B, model.n_params)))
    t = g["t_eval"][rng.integers(0, len(g["t_eval"]), B)]
    J = model.jacobian(*(torch.as_tensor(x, device=device)
                         for x in (t, y, p)))
    c = torch.as_tensor(10.0 ** rng.uniform(-3.0, np.log10(3.0), B),
                        device=device)
    eye = torch.eye(model.n_states, dtype=torch.float64, device=device)
    return eye - c[:, None, None] * J


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("constructor", sorted(SMALL_MODELS))
def test_small_model_newton_matrices(cuda_device, monkeypatch, constructor,
                                     B):
    """K1 and K2 against their plain versions on the Newton matrices the
    small models' paths factor: the f32 inverse within 1e-4, the refined
    f64 solve within 1e-12 of its plain version and 1e-9 of
    ``torch.linalg.solve``."""
    a = _small_newton(constructor, SMALL_MODELS[constructor], B,
                      cuda_device)
    a32 = a.to(torch.float32).contiguous()
    x32 = _gj(monkeypatch, "minor", a32)
    ref = gpu_lu.gj_inverse_f32_plain(a32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x32).all())
    assert float((x32 - ref).abs().max() / ref.abs().max()) <= 1e-4
    b = torch.as_tensor(np.random.default_rng(B).standard_normal(
        (B, a.shape[-1])), device=cuda_device)
    got = gpu_lu.refine_solve(x32, a, b)
    plain = gpu_lu.refine_solve_plain(x32, a, b)
    sol = torch.linalg.solve(a, b)
    torch.cuda.synchronize()
    assert float((got - plain).abs().max() / plain.abs().max()) <= 1e-12
    assert float(((got - sol).abs() / sol.abs().clamp_min(1e-30)).max()) \
        < 1e-9


@pytest.mark.cuda
def test_scale_factor_ensemble_is_deterministic(cuda_device):
    """The JAK-STAT two-dose ensemble (two scale groups) evaluated with its
    Jacobian at 64 θ twice in one process gives the same bits: the scale
    factors' segment sums add in a fixed order on the card."""
    from tpusysbio_torch import examples
    from tpusysbio_torch.fit import latin_hypercube

    proj, _, theta_true, _ = examples.jakstat_build_project(
        device=cuda_device)
    thetas = latin_hypercube(torch.Generator().manual_seed(0), 64,
                             theta_true - 1.5, theta_true + 1.5)
    a = proj.evaluate(thetas, with_jac=True)
    b = proj.evaluate(thetas, with_jac=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a.residuals).all())
    for field in ("residuals", "jacobian", "scale", "cost"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def radau_embeddings(B, device, seed=44):
    """The 2n = 44 real embeddings of the complex Radau Newton matrix of
    MAPK-22: Jacobians at random states and parameters (log-normal, scale
    0.1), step sizes log-uniform in [1e-3, 5] (the range of a MAPK-22 run
    at rtol=1e-6)."""
    from tpusysbio_torch.model import library
    from tpusysbio_torch.solvers.radau import newton_matrices

    rng = np.random.default_rng(seed)
    model = library.mapk_huang_ferrell(device=device)
    p = library.mapk_true_params(device=device)[None] * torch.as_tensor(
        np.exp(rng.normal(scale=0.1, size=(B, 30))), device=device)
    y = torch.as_tensor(rng.uniform(0.0, 1.2, size=(B, 22)), device=device)
    J = model.rhs_jac(torch.zeros(B, dtype=torch.float64, device=device),
                      y, p)
    h = torch.as_tensor(10.0 ** rng.uniform(-3.0, np.log10(5.0), B),
                        device=device)
    return newton_matrices(J, h)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 256])
def test_radau_embedding_n44(cuda_device, monkeypatch, B):
    """K1 and K2 against their plain versions on Radau's n=44 embeddings:
    per matrix the f32 inverse within max(1e-4, n·eps32·κ∞) of the plain
    one (the two round in another order, and the large steps give κ∞ of
    1e3 and more), the refined f64 solve within 1e-12 of its plain
    version and 1e-9 of ``torch.linalg.solve``."""
    a = radau_embeddings(B, cuda_device)
    assert a.shape == (B, 44, 44)
    a32 = a.to(torch.float32).contiguous()
    x32 = _gj(monkeypatch, "minor", a32)
    ref = gpu_lu.gj_inverse_f32_plain(a32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x32).all())
    inv = torch.linalg.inv(a)
    kappa = a.abs().sum(-1).amax(-1) * inv.abs().sum(-1).amax(-1)
    gap = (x32 - ref).abs().amax((-2, -1)) / ref.abs().amax((-2, -1))
    bound = torch.clamp(44 * torch.finfo(torch.float32).eps * kappa,
                        min=1e-4)
    assert bool((gap.double() <= bound).all())
    b = torch.as_tensor(np.random.default_rng(B).standard_normal((B, 44)),
                        device=cuda_device)
    got = gpu_lu.refine_solve(x32, a.contiguous(), b)
    plain = gpu_lu.refine_solve_plain(x32, a, b)
    sol = torch.linalg.solve(a, b)
    torch.cuda.synchronize()
    assert float((got - plain).abs().max() / plain.abs().max()) <= 1e-12
    assert float(((got - sol).abs() / sol.abs().clamp_min(1e-30)).max()) \
        < 1e-9


@pytest.mark.cuda
def test_two_ranks_on_one_card_equal_one(cuda_device, tmp_path):
    """``multistart_fit(mesh=)`` over two gloo ranks sharing the card (the
    rank processes of tests/test_torch_mesh.py, case ``cuda``: 16
    Rosenbrock starts, 8 a rank): both ranks return the one-process run
    on the card (tests/test_multihost.py's bounds: cost 1e-12, θ 1e-10,
    equal statuses)."""
    import os
    import subprocess
    import sys

    from tpusysbio_torch import FitConfig
    from tpusysbio_torch.fit import multistart_fit

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import test_torch_mesh as mesh_test

    out = str(tmp_path / "out")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "test_torch_mesh.py"), str(r),
         "2", str(tmp_path / "init"), out, "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    one = multistart_fit(mesh_test.ros_r, mesh_test.ros_rj, torch.as_tensor(
        mesh_test.ROS_STARTS, device=cuda_device), FitConfig(max_iter=60))
    for r in range(2):
        got = np.load(f"{out}.{r}.npz")
        np.testing.assert_allclose(got["a_cost"], one.cost.cpu().numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got["a_theta"], one.theta.cpu().numpy(),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(got["a_status"],
                                      one.status.cpu().numpy())
