"""Batched Newton-matrix inverse and refined solve on the GPU.

Counterpart of ``tpusysbio/linalg/pallas_lu.py``. Three hand-written CUDA
kernels (``linalg/csrc/``) replace its three TPU kernels:

- K1 (``csrc/gj_inverse.cu``) replaces ``_gj_batched_kernel``: a batched
  f32 Gauss-Jordan inverse with partial pivoting, the factorization of
  every Newton matrix ``I - cJ``; one warp per matrix, the matrix in the
  warp's registers;
- K3 (``csrc/gj_inverse_major.cu``) replaces ``_gj_batch_major_kernel``:
  the same function with the batch in the warp: a group of 8, 16 or 32
  lanes holds a matrix in registers and a warp inverts 4, 2 or 1 matrices
  in one instruction stream; ``gj_inverse_f32`` launches it in K1's place
  when ``TPUSYSBIO_GJ_LAYOUT=major``, the reference's switch;
- K2, ``refine_solve`` (``csrc/refine_solve.cu``), replaces
  ``_make_refine_kernel``: the f64 solve of one column from the f32
  inverse with three rounds of iterative refinement; one warp per member.

Each wrapper has a plain PyTorch twin of the same function. The wrapper
takes the twin only when its input lies on the CPU; on a CUDA tensor it
launches the kernel or raises, and counts each launch in
``trace.counters()`` as ``gpu_lu.<name>`` (the Gauss-Jordan kernels also
as ``gpu_lu.<name>.n<n>``, by matrix size: block-Schur elimination gives
the kernel two sizes per factorization). Around the kernels sit the
reference's host-side pieces: ``inverse`` with its size dispatch (the
kernel for n <= 64, one level of block-Schur elimination with the
NaN-poison guard for 64 < n <= 128, the f32-LU fallback beyond), the
Newton-Schulz refinement, and the lazy factorization
``factor_for_solve`` / ``solve_refined`` of the f64 path.
The TPU's 64-wide VMEM limit does not bind on Hopper; the dispatch is kept
so that results stay comparable with the reference.
"""

from __future__ import annotations

import os

import torch

from tpusysbio_torch import trace
from tpusysbio_torch.linalg import kernels

MAX_KERNEL_N = 64
_REFINE_MAX_N = 64
_REFINE_STEPS = 3

# The wrappers' kernels, as their launches are counted: ``gpu_lu.<name>``.
KERNELS = ("gj_inverse_f32", "refine_solve", "gj_inverse_major_f32")

# Which Gauss-Jordan kernel ``gj_inverse_f32`` launches: 'minor' (K1) or
# 'major' (K3), read once at import as the reference reads it.
_LAYOUT = os.environ.get("TPUSYSBIO_GJ_LAYOUT", "minor")


def _check_cuda(name, device, *specs):
    """One pass over ``(tensor, dtype, shape)`` triples: each tensor must
    lie on ``device`` (a CUDA device), have that dtype and shape and be
    contiguous."""
    if device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{device}")
    for t, dtype, shape in specs:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


# --------------------------------------------------------------------------
# K1 and K3: batched f32 Gauss-Jordan inverse
# --------------------------------------------------------------------------

def gj_inverse_f32_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the K1 and K3 kernels: Gauss-Jordan with
    partial pivoting on (B, n, n) f32, pivot = first row reaching the
    column maximum (``argmax``), zero pivots replaced by ±1e-30."""
    B, n = a.shape[0], a.shape[-1]
    A = a.clone()
    X = torch.eye(n, dtype=a.dtype, device=a.device).repeat(B, 1, 1)
    bi = torch.arange(B, device=a.device)
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        p = k + torch.argmax(torch.abs(A[:, k:, k]), dim=1)
        for M in (A, X):
            rk = M[:, k].clone()
            M[:, k] = M[bi, p]
            M[bi, p] = rk
        pivot = A[:, k, k]
        pivot = torch.where(torch.abs(pivot) > 1e-30, pivot,
                            torch.where(pivot >= 0, 1e-30, -1e-30)
                            .to(a.dtype))
        normA = A[:, k] / pivot[:, None]
        normX = X[:, k] / pivot[:, None]
        factor = torch.where(rows[None, :] == k, 0.0, A[:, :, k])
        A = A - factor[:, :, None] * normA[:, None, :]
        X = X - factor[:, :, None] * normX[:, None, :]
        A[:, k] = normA
        X[:, k] = normX
    return X


# K1 and K3 are one function, so they share one plain version: one body,
# two names, and no second copy of the arithmetic that could drift.
gj_inverse_major_f32_plain = gj_inverse_f32_plain


def gj_inverse_f32(a: torch.Tensor) -> torch.Tensor:
    """Batched f32 inverse of ``a`` (B, n, n), n <= ``MAX_KERNEL_N``.

    CUDA tensors launch K3 (``csrc/gj_inverse_major.cu``, several matrices
    a warp) when the module's ``_LAYOUT`` is ``'major'`` and K1
    (``csrc/gj_inverse.cu``, one matrix a warp) otherwise. CPU tensors run :func:`gj_inverse_f32_plain`."""
    if a.device.type == "cpu":
        return gj_inverse_f32_plain(a)
    name = ("gj_inverse_major_f32" if _LAYOUT == "major"
            else "gj_inverse_f32")
    B, n = a.shape[0], a.shape[-1]
    if a.ndim != 3 or n > MAX_KERNEL_N:
        raise ValueError(f"{name}: expected (B, n, n) with n <= "
                         f"{MAX_KERNEL_N}, got {tuple(a.shape)}")
    device = a.device
    _check_cuda(name, device, (a, torch.float32, (B, n, n)))
    out = torch.empty_like(a)
    kernels.launch("tsb_" + name, a.data_ptr(), out.data_ptr(), B, n,
                   device=device, counter="gpu_lu." + name)
    trace.count(f"gpu_lu.{name}.n{n}")
    return out


# --------------------------------------------------------------------------
# inverse(): size dispatch + Newton-Schulz refinement (host side)
# --------------------------------------------------------------------------

def _eye_like(a):
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def _refine(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Newton-Schulz refinement in the caller's dtype: 2 right steps for
    f64, 1 for f32, then one LEFT step for f64 that balances ``AX - I``
    and ``XA - I``."""
    eye = _eye_like(a)
    steps = 2 if a.dtype == torch.float64 else 1
    for _ in range(steps):
        x = x + x @ (eye - a @ x)
    if a.dtype == torch.float64:
        x = x + (eye - x @ a) @ x
    return x


def _large_n_inverse(a: torch.Tensor) -> torch.Tensor:
    """n > 2*MAX_KERNEL_N: f32 LU inverse + refinement."""
    from tpusysbio_torch.linalg import lu as _lu

    x = _lu.lu_inverse(a.to(torch.float32)).to(a.dtype)
    return _refine(a, x)


def _schur_inverse(a: torch.Tensor) -> torch.Tensor:
    """(B, n, n) f32 inverse for MAX_KERNEL_N < n <= 2*MAX_KERNEL_N by one
    level of block-Schur elimination, with the Gauss-Jordan kernel of the
    current layout on both diagonal blocks.
    Members whose residual ``‖I - AX‖∞`` is not below 0.5 (a near-singular
    leading block) are poisoned with NaN, as in the reference."""
    n1 = MAX_KERNEL_N
    a11, a12 = a[:, :n1, :n1], a[:, :n1, n1:]
    a21, a22 = a[:, n1:, :n1], a[:, n1:, n1:]
    x11 = gj_inverse_f32(a11.contiguous())
    x11_a12 = x11 @ a12
    s = a22 - a21 @ x11_a12
    xs = gj_inverse_f32(s.contiguous())
    b12 = -(x11_a12 @ xs)
    a21_x11 = a21 @ x11
    b21 = -(xs @ a21_x11)
    b11 = x11 - b12 @ a21_x11
    x = torch.cat([torch.cat([b11, b12], dim=-1),
                   torch.cat([b21, xs], dim=-1)], dim=-2)
    resid = torch.amax(torch.sum(torch.abs(_eye_like(x) - a @ x), dim=-1),
                       dim=-1)
    return torch.where((resid < 0.5)[:, None, None], x,
                       torch.full_like(x, float("nan")))


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of ``a`` (..., n, n): the f32 kernel plus Newton-Schulz
    refinement in the input dtype (2 steps for f64, 1 for f32); block-Schur
    for 64 < n <= 128 and f32 LU beyond, each with ``_refine``."""
    n = a.shape[-1]
    ab = a.reshape(-1, n, n)
    if n > 2 * MAX_KERNEL_N:
        x = _large_n_inverse(ab)
    elif n > MAX_KERNEL_N:
        x = _refine(ab, _schur_inverse(ab.to(torch.float32)).to(a.dtype))
    else:
        x = gj_inverse_f32(ab.to(torch.float32).contiguous()).to(a.dtype)
        eye = _eye_like(ab)
        for _ in range(2 if a.dtype == torch.float64 else 1):
            x = x + x @ (eye - ab @ x)
    return x.reshape(a.shape)


# --------------------------------------------------------------------------
# K2: f64 solve from the f32 inverse with iterative refinement
# --------------------------------------------------------------------------

def refine_solve_plain(x32: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the K2 kernel: ``y = X fl32(b)``, then
    ``_REFINE_STEPS`` rounds of ``r = b - A y`` (f64), ``y += X fl32(r)``.
    ``x32`` (B, n, n) f32, ``a`` (B, n, n) f64, ``b`` (B, n) f64."""
    f32 = torch.float32
    y = (x32 @ b.to(f32)[:, :, None])[:, :, 0].to(a.dtype)
    for _ in range(_REFINE_STEPS):
        r = b - (a @ y[:, :, None])[:, :, 0]
        y = y + (x32 @ r.to(f32)[:, :, None])[:, :, 0].to(a.dtype)
    return y


def refine_solve(x32: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Solve ``a y = b`` per member, ``x32`` the f32 inverse of ``a``.

    CUDA tensors launch the K2 kernel (``csrc/refine_solve.cu``); CPU
    tensors run :func:`refine_solve_plain`."""
    if a.device.type == "cpu":
        return refine_solve_plain(x32, a, b)
    B, n = a.shape[0], a.shape[-1]
    if a.ndim != 3 or n > _REFINE_MAX_N:
        raise ValueError(f"refine_solve: expected (B, n, n) with n <= "
                         f"{_REFINE_MAX_N}, got {tuple(a.shape)}")
    device = a.device
    _check_cuda("refine_solve", device, (x32, torch.float32, (B, n, n)),
                (a, torch.float64, (B, n, n)), (b, torch.float64, (B, n)))
    y = torch.empty_like(b)
    kernels.launch("tsb_refine_solve", x32.data_ptr(), a.data_ptr(),
                   b.data_ptr(), y.data_ptr(), B, n, device=device,
                   counter="gpu_lu.refine_solve")
    return y


def factor_for_solve(a: torch.Tensor):
    """Lazy f64 factorization: the f32 inverse plus the matrix itself;
    precision is recovered per solve by :func:`solve_refined`."""
    return (inverse(a.to(torch.float32)), a)


def solve_refined(fact, b: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """Solve ``A x = b`` from ``factor_for_solve(A)``; ``b`` (B, n, k).

    f32 RHS (the sensitivity columns): one f32 matmul. A single f64 column
    with ``steps <= 3`` and n <= 64: the K2 kernel, whose three rounds make
    ``steps`` a minimum. Otherwise exactly ``steps`` rounds in plain
    PyTorch."""
    x32, a = fact
    f32 = torch.float32
    if b.dtype == f32 or a.dtype == f32:
        return (x32 @ b.to(f32)).to(b.dtype)
    n = a.shape[-1]
    if (steps <= _REFINE_STEPS and n <= _REFINE_MAX_N
            and b.ndim == a.ndim and b.shape[-1] == 1):
        y = refine_solve(x32.reshape(-1, n, n).contiguous(),
                         a.reshape(-1, n, n).contiguous(),
                         b.reshape(-1, n).contiguous())
        return y.reshape(b.shape)
    y = (x32 @ b.to(f32)).to(a.dtype)
    for _ in range(steps):
        r = b - a @ y
        y = y + (x32 @ r.to(f32)).to(a.dtype)
    return y
