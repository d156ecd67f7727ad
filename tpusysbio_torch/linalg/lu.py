"""Batched pivoted LU and triangular solves in plain PyTorch.

Port of ``tpusysbio/linalg/lu.py``: right-looking Gaussian elimination with
partial pivoting (the first row reaching the column maximum) over a
leading batch dimension. A zero pivot becomes ``±sqrt(tiny)`` so a
singular Newton matrix gives a finite wrong solve that the step controller
rejects. Backs the Newton kinds ``'lu'``, ``'inv'`` and ``'inv32'``, and the
n > 128 fallback of ``gpu_lu.inverse``.
"""

from __future__ import annotations

import torch


def lu_factor(a: torch.Tensor):
    """``a`` (B, n, n) -> ``(lu, piv)``: U on and above the diagonal, the
    unit-lower multipliers below it; ``piv[:, k]`` is the row swapped with
    row k at step k (LAPACK style)."""
    B, n = a.shape[0], a.shape[-1]
    tiny = torch.finfo(a.dtype).tiny ** 0.5
    lu = a.clone()
    piv = torch.zeros((B, n), dtype=torch.int64, device=a.device)
    bi = torch.arange(B, device=a.device)
    for k in range(n):
        p = k + torch.argmax(torch.abs(lu[:, k:, k]), dim=1)
        piv[:, k] = p
        row_k = lu[bi, k].clone()
        lu[:, k] = lu[bi, p]
        lu[bi, p] = row_k
        pivot = lu[:, k, k]
        pivot = torch.where(torch.abs(pivot) > tiny, pivot,
                            torch.where(pivot >= 0, tiny, -tiny)
                            .to(pivot.dtype))
        lu[:, k, k] = pivot
        factor = lu[:, k + 1:, k] / pivot[:, None]
        lu[:, k + 1:, k:] -= factor[:, :, None] * lu[:, k, None, k:]
        lu[:, k + 1:, k] = factor
    return lu, piv


def lu_solve(factors, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` from ``lu_factor(A)``; ``b`` is (B, n) or
    (B, n, k)."""
    lu, piv = factors
    B, n = lu.shape[0], lu.shape[-1]
    vec = b.ndim == 2
    x = (b[:, :, None] if vec else b).clone()
    bi = torch.arange(B, device=b.device)
    for k in range(n):
        p = piv[:, k]
        xk = x[:, k].clone()
        x[:, k] = x[bi, p]
        x[bi, p] = xk
    for k in range(n):
        x[:, k] -= (lu[:, k, None, :k] @ x[:, :k])[:, 0]
    for k in range(n - 1, -1, -1):
        x[:, k] = ((x[:, k] - (lu[:, k, None, k + 1:] @ x[:, k + 1:])[:, 0])
                   / lu[:, k, k, None])
    return x[:, :, 0] if vec else x


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A x = b`` in one call (factor + solve); ``b`` is (B, n) or
    (B, n, k)."""
    return lu_solve(lu_factor(a), b)


def lu_inverse(a: torch.Tensor) -> torch.Tensor:
    """Explicit inverse via pivoted LU (one factor + n-column solve)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    return lu_solve(lu_factor(a), eye.expand(a.shape[0], n, n))
