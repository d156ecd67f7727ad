"""One Levenberg-Marquardt step in NumPy: the damped normal equations
with Marquardt's diagonal scaling,

    (J^T J + lam * diag(J^T J)) delta = -J^T r,

the diagonal floored at 1e-12. A step is taken when it lowers the cost
``0.5 |r|^2``."""

from __future__ import annotations

import numpy as np


def cost(r) -> float:
    return 0.5 * float(r @ r)


def grad_norm(r, J) -> float:
    """``|J^T r|_inf``."""
    return float(np.abs(J.T @ r).max())


def damped(J, lam: float) -> np.ndarray:
    """The damped normal matrix ``J^T J + lam * diag(J^T J)``."""
    A = J.T @ J
    return A + lam * np.diag(np.maximum(np.diag(A), 1e-12))


def lm_step(r, J, lam: float) -> np.ndarray:
    return np.linalg.solve(damped(J, lam), -(J.T @ r))


def step_gap(got, step, M) -> float:
    """How far the step ``got`` falls short of the LM step ``step``, the
    minimiser of the model ``q(d) = g^T d + d^T M d / 2``: the square root
    of the share of the model's reduction ``q(0) - q(step)`` that ``got``
    gives away. It is ``|got - step|_M / |step|_M``: 1 for no step at all,
    2 for the step reversed."""
    d = np.asarray(got, dtype=np.float64) - step
    return float(np.sqrt((d @ M @ d) / (step @ M @ step)))


def kept_gap(c0, c_step, step, M) -> float:
    """Where no step was taken: the square root of the share of the
    model's reduction that ``step`` would have realised, the cost going
    from ``c0`` to ``c_step``; 0 where it would not have lowered the
    cost."""
    return float(np.sqrt(max(0.0, c0 - c_step) / (0.5 * step @ M @ step)))
