"""The port's Newton linear algebra (``tpusysbio_torch/linalg``) against
the reference's ``pallas_lu`` (Pallas in interpret mode on the CPU).

On the CPU the K1, K2 and K3 wrappers run their plain PyTorch twins; the
kernels themselves are compared with those twins on the card by
``tests/test_torch_cuda_kernels.py`` and by ``chip_smoke.py``. The
register schemes of K1 and K3 (which lane holds which row, how the pivot is
found and the row handed out, where the store puts each element) are
emulated here in numpy, lane by lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio.linalg import pallas_lu
from tpusysbio_torch import trace
from tpusysbio_torch.linalg import gpu_lu, lu, make_linear_solver

torch.set_num_threads(1)


def _newton_like(rng, B, n, scale=0.08):
    return np.eye(n)[None] - scale * rng.standard_normal((B, n, n))


def _launched():
    """The kernel launches counted since the last ``trace.reset()``."""
    return {k: v for k, v in trace.counters().items()
            if k.startswith("gpu_lu.")}


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
    trace.reset()
    if layout is not None:
        monkeypatch.setattr(gpu_lu, "_LAYOUT", layout)
    got = gpu_lu.gj_inverse_f32(a)
    assert torch.equal(got, ref)
    assert set(gpu_lu.KERNELS) == {"gj_inverse_f32", "refine_solve",
                                   "gj_inverse_major_f32"}
    assert _launched() == {}


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
# K1's scheme on the card, emulated: a row per lane, in place, no row moves
# --------------------------------------------------------------------------

def _emulate_k1(a):
    """``csrc/gj_inverse.cu`` step by step in numpy f32 for one (n, n)
    matrix. ``row[l]`` is what physical row ``l`` (lane ``l % 32``, slot
    ``l // 32``) holds in its ``W`` registers (n padded to a multiple of 8)
    and never leaves it; ``pos[l]`` is that row's logical position. The row
    rotates by one register per step, so step k works on register 0. In
    place: column k takes the inverse's column. The pivot is the lowest
    logical row reaching the column maximum (a NaN never wins; if nothing
    wins, row k stays), ``!(|p| > 1e-30)`` becomes ±1e-30, the pivot row is
    divided by a true division, W - n last rotations bring every column
    back to its register, and the store undoes the row exchanges through
    its addresses."""
    f32 = np.float32
    n = a.shape[0]
    W = 8 * ((n + 7) // 8)
    row = np.zeros((n, W), f32)
    row[:, :n] = a
    pos = np.arange(n)
    with np.errstate(all="ignore"):
        for k in range(n):
            col = np.abs(row[:, 0])
            offers = (pos >= k) & ~np.isnan(col)
            p = k
            if offers.any():
                p = pos[offers & (col == col[offers].max())].min()
            src = int(np.flatnonzero(pos == p)[0])
            held_k = int(np.flatnonzero(pos == k)[0])
            pos[held_k], pos[src] = p, k
            u = row[src].copy()
            pivot = u[0]
            u[0] = f32(1.0)
            if not abs(pivot) > f32(1e-30):
                pivot = f32(1e-30) if pivot >= 0 else f32(-1e-30)
            q = u / pivot
            f = row[:, 0].copy()
            row[:, 0] = f32(0.0)
            row = row - f[:, None] * q[None, :]
            row[src] = q
            row = np.roll(row, -1, axis=1)
    # register j holds logical column (n + j) mod W: W - n more rotations
    # bring column c back to register c
    for _ in range(n, W):
        row = np.roll(row, -1, axis=1)
    holder = np.argsort(pos)          # holder[c]: physical row at logical c
    out = np.empty((n, n), f32)
    for c in range(n):
        out[pos, holder[c]] = row[:, c]
    return out


def _emulate_k1_batch(a):
    return np.stack([_emulate_k1(m) for m in a])


# --------------------------------------------------------------------------
# K3's scheme on the card, emulated: several matrices per warp, a matrix in
# the registers of a group of G lanes, R rows a lane
# --------------------------------------------------------------------------

# (W, G, R) by ceil(n / 8), as csrc/gj_inverse_major.cu dispatches
_K3_SHAPES = {1: (8, 8, 1), 2: (16, 8, 2), 3: (24, 8, 3), 4: (32, 16, 2),
              5: (40, 16, 3), 6: (48, 32, 2), 7: (56, 32, 2), 8: (64, 32, 2)}
_INF_BITS = 0x7F800000


def _emulate_k3_warp(a, out, warp, W, G, R):
    """One warp of ``csrc/gj_inverse_major.cu`` in numpy f32, every array
    indexed by the warp's 32 lanes as the kernel's registers are. A group of
    G lanes owns matrix ``warp * 32/G + lane // G``; lane ``sub`` of a group
    holds physical rows ``sub + G*i`` (i < R) in ``row[lane, i, :W]`` and
    their logical positions in ``pos[lane, i]``. Groups without a matrix run
    along on zeros. The search is the kernel's 64-bit butterfly, the pivot
    row is picked by predicated moves and handed out by shuffles of width
    G, lane ``c % G`` divides element c, and the store finds each output
    column by ballots cut to the group."""
    f32 = np.float32
    B, n = a.shape[0], a.shape[-1]
    lane = np.arange(32)
    sub = lane % G
    first = lane - sub
    m = warp * (32 // G) + lane // G
    valid = m < B
    Q = -(-W // G)
    row = np.zeros((32, R, W), f32)
    pos = np.zeros((32, R), np.int64)
    for i in range(R):
        r = sub + G * i
        pos[:, i] = r
        take = valid & (r < n)
        row[take, i, :n] = a[m[take], r[take], :]

    def shfl(x, src):            # __shfl_sync(full, x, src, G)
        return x[first + src % G]

    def find_pivot(k):
        bits = np.abs(row[:, :, 0]).view(np.uint32).astype(np.uint64)
        offers = (pos >= k) & (pos < n) & (bits <= _INF_BITS)
        key = np.where(offers, bits + 1, 0).astype(np.uint64)
        place = (pos << 7 | np.arange(R)[None, :] << 5
                 | sub[:, None]).astype(np.uint64)
        word = np.where(offers | (pos == k),
                        key << np.uint64(32)
                        | (~place & np.uint64(0xFFFFFFFF)),
                        np.uint64(0))
        best = word.max(axis=1)
        off = G // 2
        while off > 0:           # __shfl_xor_sync butterfly
            best = np.maximum(best, best[lane ^ off])
            off //= 2
        return (~best & np.uint64(0xFFFFFFFF)).astype(np.int64)

    with np.errstate(all="ignore"):
        won = find_pivot(0)
        for k in range(n):
            p, slot, src = won >> 7, (won >> 5) & 3, won & 31
            pos = np.where(pos == p[:, None], k,
                           np.where(pos == k, p[:, None], pos))
            own = row[:, 0, :].copy()
            for i in range(1, R):
                own = np.where((slot == i)[:, None], row[:, i, :], own)
            u = shfl(own, src)
            pivot = u[:, 0].copy()
            u[:, 0] = f32(1.0)
            mine = np.zeros((32, Q), f32)
            for c in range(W):
                keep = sub == c % G
                mine[keep, c // G] = u[keep, c]
            pivot = np.where(np.abs(pivot) > f32(1e-30), pivot,
                             np.where(pivot >= 0, f32(1e-30), f32(-1e-30)))
            mine = mine / pivot[:, None]
            scaled = np.stack([shfl(mine[:, c // G], np.full(32, c % G))
                               for c in range(W)], axis=1)
            is_pivot = pos == k
            f = row[:, :, 0].copy()
            cur = row.copy()
            cur[:, :, 0] = f32(0.0)
            val = np.where(is_pivot[:, :, None], scaled[:, None, :],
                           cur - f[:, :, None] * scaled[:, None, :])
            row = np.roll(val, -1, axis=2)
            won = find_pivot(k + 1)
    for _ in range(n, W):
        row = np.roll(row, -1, axis=2)
    group_bits = 0xFFFFFFFF >> (32 - G)
    for c in range(n):
        d = np.zeros(32, np.int64)
        for i in range(R):
            ballot = int(sum(1 << l for l in lane[pos[:, i] == c]))
            held = (ballot >> first) & group_bits
            ffs = np.array([(int(h) & -int(h)).bit_length() for h in held])
            d = np.where(held != 0, G * i + ffs - 1, d)
        for i in range(R):
            put = valid & (pos[:, i] < n)
            out[m[put], pos[put, i], d[put]] = row[put, i, c]


def _emulate_k3_batch(a):
    n = a.shape[-1]
    W, G, R = _K3_SHAPES[(n + 7) // 8]
    out = np.full_like(a, np.float32(7.0))   # every element must be stored
    for warp in range(-(-a.shape[0] // (32 // G))):
        _emulate_k3_warp(a, out, warp, W, G, R)
    return out


_SCHEMES = {"k1": _emulate_k1_batch, "k3": _emulate_k3_batch}


@pytest.fixture(params=sorted(_SCHEMES))
def emulate(request):
    """The register scheme of K1 (a matrix across a warp) or of K3 (a
    matrix across a group of lanes, several matrices a warp) on a batch."""
    return _SCHEMES[request.param]


def _assert_emulation_equals_plain(emulate, a):
    ref = gpu_lu.gj_inverse_f32_plain(torch.as_tensor(a)).numpy()
    got = emulate(a)
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("n", [1, 5, 22, 32, 33, 40, 64])
def test_gj_register_scheme_equals_plain_bitwise(emulate, n):
    """Both do one division per pivot-row element and one unfused
    multiply-subtract per eliminated element, so they agree to the bit. The
    general matrices (scale 1) make most steps exchange rows. 7 matrices:
    not a multiple of K3's 4 or 2 matrices a warp, so its last warp has
    groups without a matrix."""
    rng = np.random.default_rng(200 + n)
    newton = _newton_like(rng, 4, n).astype(np.float32)
    general = rng.standard_normal((3, n, n)).astype(np.float32)
    _assert_emulation_equals_plain(emulate,
                                   np.concatenate([newton, general]))


def test_gj_register_scheme_tied_pivots_take_the_lowest_row(emulate):
    a = np.array([[[2.0, 1.0, 0.0], [-2.0, 3.0, 1.0], [2.0, 0.0, 5.0]],
                  [[0.0, 1.0, 2.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 3.0]]],
                 dtype=np.float32)
    got = _assert_emulation_equals_plain(emulate, a)
    np.testing.assert_allclose(got @ a, np.broadcast_to(np.eye(3), a.shape),
                               atol=1e-5)


def test_gj_register_scheme_singular_gives_finite_output(emulate):
    a = np.array([[[1.0, 2.0], [2.0, 4.0]],
                  [[0.0, 0.0], [0.0, 0.0]]], dtype=np.float32)
    assert np.isfinite(_assert_emulation_equals_plain(emulate, a)).all()


def test_gj_register_scheme_nan_gives_nonfinite_output(emulate):
    a = np.eye(3, dtype=np.float32)
    a[1, 2] = np.nan
    assert not np.isfinite(emulate(a[None])).all()
    # all NaN: nothing wins the search, the NaN pivot becomes -1e-30
    a = np.full((2, 2), np.nan, dtype=np.float32)
    assert not np.isfinite(emulate(a[None])).all()


def test_gj_register_scheme_permutation_matrix(emulate):
    """Every step exchanges rows; the store's two permutations must undo
    them: the inverse of a permutation matrix is its transpose."""
    a = np.eye(5, dtype=np.float32)[[3, 0, 4, 1, 2]]
    np.testing.assert_array_equal(emulate(a[None])[0], a.T)


def test_gj_register_schemes_agree_on_a_nan_member(emulate):
    """A NaN member poisons only itself: its neighbours in the warp (K3
    inverts several matrices in one instruction stream) come out as the
    plain version gives them."""
    rng = np.random.default_rng(77)
    a = _newton_like(rng, 5, 22).astype(np.float32)
    a[2, 3, 4] = np.nan
    got = emulate(a)
    ref = gpu_lu.gj_inverse_f32_plain(torch.as_tensor(a)).numpy()
    keep = [0, 1, 3, 4]
    np.testing.assert_array_equal(got[keep], ref[keep])
    assert not np.isfinite(got[2]).all()


# --------------------------------------------------------------------------
# K2: refined f64 solve
# --------------------------------------------------------------------------

def _emulate_k2(x32, a, b, steps=3):
    """``csrc/refine_solve.cu`` for one member in numpy: every mat-vec is
    a sum over j in increasing order, f32 for X and f64 for A."""
    def matvec(m, v, dtype):
        acc = np.zeros(m.shape[0], dtype)
        for j in range(m.shape[1]):
            acc = acc + m[:, j] * v[j]
        return acc

    y = matvec(x32, b.astype(np.float32), np.float32).astype(np.float64)
    for _ in range(steps):
        r = b - matvec(a, y, np.float64)
        y = y + matvec(x32, r.astype(np.float32),
                       np.float32).astype(np.float64)
    return y


@pytest.mark.parametrize("n", [5, 22, 40])
def test_refine_summation_order_matches_plain(n):
    """The kernel sums in increasing j, the plain version lets a batched
    matmul choose: f32 accumulation order, so <= 1e-6 relative (the three
    refinement rounds leave far less)."""
    rng = np.random.default_rng(300 + n)
    a = _newton_like(rng, 6, n)
    b = rng.standard_normal((6, n))
    x32 = gpu_lu.inverse(torch.as_tensor(a, dtype=torch.float32))
    ref = gpu_lu.refine_solve_plain(x32, torch.as_tensor(a),
                                    torch.as_tensor(b)).numpy()
    got = np.stack([_emulate_k2(x32[i].numpy(), a[i], b[i])
                    for i in range(6)])
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-6
    y_np = np.linalg.solve(a, b[:, :, None])[:, :, 0]
    assert np.max(np.abs(got - y_np) / (np.abs(y_np) + 1e-30)) < 1e-9


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


def test_solve_refined_takes_noncontiguous_inputs():
    """The K2 branch hands its wrapper contiguous tensors whatever it was
    given; the answer does not depend on the layout."""
    rng = np.random.default_rng(8)
    a = torch.as_tensor(_newton_like(rng, 4, 9))
    b = torch.as_tensor(rng.standard_normal((4, 9, 1)))
    x32, _ = gpu_lu.factor_for_solve(a)
    ref = gpu_lu.solve_refined((x32, a), b)
    strided = (x32.transpose(1, 2).contiguous().transpose(1, 2),
               a.transpose(1, 2).contiguous().transpose(1, 2))
    assert not strided[0].is_contiguous()
    got = gpu_lu.solve_refined(strided, b.expand(4, 9, 2)[:, :, :1])
    assert torch.equal(got, ref)


def test_wrapper_checks_raise_off_the_card():
    """The one-pass input check: a device that is neither CPU nor CUDA,
    and tensors that do not all lie on the launch's device."""
    a = torch.eye(3).repeat(2, 1, 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gpu_lu.gj_inverse_f32(a.to("meta"))
    with pytest.raises(ValueError, match="tensors on"):
        gpu_lu._check_cuda("k", torch.device("cuda", 0),
                           (a, torch.float32, (2, 3, 3)))


def test_ptxas_report_is_parsed():
    from tpusysbio_torch.linalg import _build

    log = """== gj_inverse.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kILi24ELi1EEvPKfPfii' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi24ELi1EEvPKfPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 376 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kILi64ELi2EEvPKfPfii' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi64ELi2EEvPKfPfii
    264 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 376 bytes cmem[0]
"""
    rep = _build.resource_report(log)
    assert [r["registers"] for r in rep] == [56, 255]
    assert [r["source"] for r in rep] == ["gj_inverse.cu"] * 2
    assert (rep[0]["spill_stores"], rep[0]["spill_loads"]) == (0, 0)
    assert (rep[1]["stack"], rep[1]["spill_stores"],
            rep[1]["spill_loads"]) == (264, 8, 12)


def test_cpu_tensors_leave_launch_counters_at_zero():
    trace.count("gpu_lu.gj_inverse_f32.n22", 3)
    trace.reset()
    rng = np.random.default_rng(5)
    a = torch.as_tensor(_newton_like(rng, 2, 6))
    fact = gpu_lu.factor_for_solve(a)
    gpu_lu.solve_refined(fact, torch.as_tensor(rng.standard_normal((2, 6,
                                                                     1))))
    assert all(trace.counters().get("gpu_lu." + k, 0) == 0
               for k in gpu_lu.KERNELS)
    assert not [k for k in _launched() if ".n" in k]


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
    """``'banded'`` is ported (ROADMAP item 13): its factor/solve pair
    solves a tridiagonal system as ``torch.linalg.solve`` does
    (tests/test_torch_banded.py holds it against the reference)."""
    rng = np.random.default_rng(3)
    a = np.diag(4.0 + rng.random(8)) + np.diag(rng.random(7), 1) \
        + np.diag(rng.random(7), -1)
    b = rng.standard_normal((2, 8, 3))
    factor, solve = make_linear_solver("banded", (1, 1))
    A = torch.as_tensor(np.stack([a, a + np.eye(8)]))
    x = solve(factor(A), torch.as_tensor(b))
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(
        A, torch.as_tensor(b)).numpy(), rtol=1e-12, atol=1e-13)
