"""Banded LU factorization and solves over a batch, port of
``tpusysbio/linalg/banded.py`` (LAPACK's ``gbtrf``/``gbtrs`` role).

Chain-structured models (linear cascades, relays, discretized transport)
have Jacobians of bandwidth ``(kl, ku)`` much smaller than n, and so have
their Newton matrices ``I - c·J``: a banded factorization costs
O(n·kl·(kl+ku)) where a dense one costs O(n³).

- ``band_from_dense(A, kl, ku)``: diagonal-packed storage
  ``B[:, ku + i - j, j] = A[:, i, j]``, shape (B, kl+ku+1, n);
- ``banded_factor``: LU WITHOUT pivoting (the Newton matrices it serves
  are diagonally dominant at the step sizes BDF accepts), with the
  reference's pivot floor ``tiny``; U's diagonals keep the input's rows,
  L's multipliers take rows ku+1..ku+kl;
- ``banded_solve``: forward and back substitution.

Every function takes a leading member dimension B. The pivot columns run
in a Python loop over the n columns (the reference's ``lax.scan``); each
column's whole ``kl × ku`` window update, its multipliers and each
substitution step are a few tensor operations on index tensors built once
per call, so the launches per column do not grow with ``kl·ku``. The
storage is padded by ku columns (and the solves' right-hand sides by
kl/ku rows) of zeros, so updates that would fall past column n land in
the padding instead of being masked. The factorization is one tensor of
fixed shape (B, kl+ku+1, n), which the stepper merges per member with
``torch.where``.
"""

from __future__ import annotations

import torch


def _tiny(dtype) -> float:
    return 1e-300 if dtype == torch.float64 else 1e-30


def _band_index(n: int, kl: int, ku: int, device):
    """Row ``i = j + r - ku`` of the dense matrix for packed row r and
    column j, (kl+ku+1, n), with its validity mask."""
    r = torch.arange(kl + ku + 1, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    i = j + r - ku
    valid = (i >= 0) & (i < n)
    return i.clamp(0, n - 1), j.expand_as(i), valid


def band_from_dense(A: torch.Tensor, kl: int, ku: int) -> torch.Tensor:
    """Pack (B, n, n) into (B, kl+ku+1, n) diagonal storage; entries
    outside the matrix are zero."""
    n = A.shape[-1]
    i, j, valid = _band_index(n, kl, ku, A.device)
    return torch.where(valid, A[:, i, j], torch.zeros((), dtype=A.dtype,
                                                      device=A.device))


def band_to_dense(B: torch.Tensor, kl: int, ku: int) -> torch.Tensor:
    """Inverse of :func:`band_from_dense`, (B, n, n)."""
    n = B.shape[-1]
    i, j, valid = _band_index(n, kl, ku, B.device)
    A = B.new_zeros(B.shape[:-2] + (n, n))
    A[:, i[valid], j[valid]] = B[:, valid]
    return A


def banded_factor(B: torch.Tensor, kl: int, ku: int) -> torch.Tensor:
    """LU of the banded matrices ``B`` in packed storage (members,
    kl+ku+1, n), no pivoting. Returns the packed LU, same shape."""
    Bsz, w, n = B.shape
    npad = n + ku
    dev = B.device
    W = B.new_zeros((Bsz, w, npad))
    W[:, :, :n] = B
    Wf = W.view(Bsz, w * npad)
    tiny = torch.tensor(_tiny(B.dtype), dtype=B.dtype, device=dev)
    # the window update: for i in 1..kl, d in 1..ku, A[j+i, j+d] (packed
    # row ku+i-d) -= l_i * U[j, j+d] (packed row ku-d), all at column j+d;
    # flat indices into W's (w * npad) view, one row of each per column j
    ii, dd = torch.meshgrid(torch.arange(1, kl + 1, device=dev),
                            torch.arange(1, ku + 1, device=dev),
                            indexing="ij")
    ii, dd = ii.reshape(-1), dd.reshape(-1)
    cols = torch.arange(n, device=dev)[:, None] + dd[None, :]
    tgt_idx = (ku + ii - dd)[None, :] * npad + cols
    src_idx = (ku - dd)[None, :] * npad + cols
    mult_of = ii - 1
    for j in range(n):
        piv = W[:, ku, j]
        piv = torch.where(piv.abs() > tiny, piv,
                          torch.where(piv >= 0, tiny, -tiny))
        if kl:
            mult = W[:, ku + 1:, j] / piv[:, None]
            if ku:
                Wf[:, tgt_idx[j]] = (Wf[:, tgt_idx[j]]
                                     - mult[:, mult_of] * Wf[:, src_idx[j]])
            W[:, ku + 1:, j] = mult
        W[:, ku, j] = piv
    return W[:, :, :n].contiguous()


def banded_solve(LU: torch.Tensor, b: torch.Tensor, kl: int,
                 ku: int) -> torch.Tensor:
    """Solve ``A x = b`` from :func:`banded_factor`'s output (B, w, n);
    ``b`` is (B, n) or (B, n, k)."""
    Bsz, w, n = LU.shape
    vec = b.ndim == 2
    bb = b[..., None] if vec else b
    k = bb.shape[-1]
    dev = LU.device
    # forward: L y = b, unit diagonal; y[j+i] -= l_i y[j]
    y = bb.new_zeros((Bsz, n + kl, k))
    y[:, :n] = bb
    L = LU[:, ku + 1:, :]                                        # (B, kl, n)
    for j in range(n if kl else 0):
        y[:, j + 1:j + 1 + kl] -= L[:, :, j, None] * y[:, j:j + 1]
    # back: U x = y; U[j, j+d] sits at packed (ku-d, j+d)
    Upad = LU.new_zeros((Bsz, w, n + ku))
    Upad[:, :, :n] = LU
    Uf = Upad.view(Bsz, w * (n + ku))
    dd = torch.arange(1, ku + 1, device=dev)
    u_idx = ((ku - dd)[None, :] * (n + ku)
             + torch.arange(n, device=dev)[:, None] + dd[None, :])
    diag = LU[:, ku, :]
    x = bb.new_zeros((Bsz, n + ku, k))
    x[:, :n] = y[:, :n]
    for j in range(n - 1, -1, -1):
        acc = x[:, j]
        if ku:
            acc = acc - (Uf[:, u_idx[j], None]
                         * x[:, j + 1:j + 1 + ku]).sum(1)
        x[:, j] = acc / diag[:, j, None]
    x = x[:, :n]
    return x[..., 0] if vec else x
