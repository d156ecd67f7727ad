"""Newton linear-solver strategies, port of ``tpusysbio/linalg/newton.py``.

"Factor ``I - c*J`` once, solve many right-hand sides against it", batched
over members. ``factor(A)`` takes (B, n, n); ``solve(fact, B)`` takes
(B, n, k). A factorization is a tensor or a tuple of tensors with a fixed
structure for a given n, so the stepper can merge it per member with
``torch.where``.

- ``'lu'``     pivoted LU + triangular solves (plain PyTorch, ``lu.py``);
- ``'inv'``    explicit inverse; each solve is one batched matmul;
- ``'inv32'``  f32 LU inverse + two Newton-Schulz steps in the input dtype;
- ``'pallas'`` the hand-written CUDA kernels of ``gpu_lu.py`` (the name is
  the reference's): f32 Gauss-Jordan inverse, and for f64 the lazy
  factorization with the fused refined solve;
- ``'banded'`` LU without pivoting in diagonal-packed storage
  (``banded.py``) for Jacobians of bandwidth ``(kl, ku)``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from tpusysbio_torch.linalg import lu as _lu


def make_linear_solver(kind: str,
                       bandwidth=None) -> Tuple[Callable, Callable]:
    """Return ``(factor, solve)`` for the Newton kind ``kind``."""
    if kind == "lu":
        return _lu.lu_factor, _lu.lu_solve

    if kind == "inv":
        def solve(ainv, b):
            return ainv @ b

        return _lu.lu_inverse, solve

    if kind == "inv32":
        def factor(a):
            x = _lu.lu_inverse(a.to(torch.float32)).to(a.dtype)
            eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            x = x + x @ (eye - a @ x)
            x = x + x @ (eye - a @ x)
            return x

        def solve(ainv, b):
            return ainv @ b

        return factor, solve

    if kind == "pallas":
        from tpusysbio_torch.linalg import gpu_lu

        def factor(a):
            if a.dtype == torch.float32:
                return gpu_lu.inverse(a)
            return gpu_lu.factor_for_solve(a)

        def solve(fact, b):
            if isinstance(fact, tuple):
                return gpu_lu.solve_refined(fact, b)
            return fact @ b

        return factor, solve

    if kind == "banded":
        from tpusysbio_torch.linalg import banded as _banded

        if bandwidth is None:
            raise ValueError("kind='banded' requires bandwidth=(kl, ku)")
        kl, ku = bandwidth

        def factor(a):
            return _banded.banded_factor(
                _banded.band_from_dense(a, kl, ku), kl, ku)

        def solve(fact, b):
            return _banded.banded_solve(fact, b, kl, ku)

        return factor, solve

    raise ValueError(f"unknown linear solver kind {kind!r}")
