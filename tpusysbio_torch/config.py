"""Frozen solver and fit configurations, field for field with
``tpusysbio/config.py``.

Same names, defaults and ``__post_init__`` checks as the reference's
``SolverConfig`` and ``FitConfig``, so a configuration means the same thing
in both packages. ``linear_solver='pallas'`` keeps its name: in the port it
selects the hand-written CUDA kernels of ``linalg/gpu_lu.py``.
``MeshConfig`` comes with the sharded slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration for the integrators (see the reference's docstrings
    at ``tpusysbio/config.py`` for the meaning of each field).

    ``max_steps`` bounds the step loop so a batch with one pathological
    member always terminates; that member ends ``STATUS_MAX_STEPS``.
    """

    rtol: float = 1e-6
    atol: float = 1e-9
    max_steps: int = 4096
    max_order: int = 5            # BDF/NDF maximum order
    newton_maxiter: int = 4       # modified-Newton cap
    min_factor: float = 0.2       # step shrink floor
    max_factor: float = 10.0      # step growth cap
    safety: float = 0.9
    first_step: Optional[float] = None  # None -> Hairer heuristic
    max_step: float = float("inf")
    # Include sensitivity columns in the local error norm.
    sens_error_control: bool = False
    # f32 hot loop (RHS, Jacobian, solves, storage) with f64 time and step
    # control: the screening mode.
    mixed_precision: bool = False
    # 'full' or 'f32': precision of the sensitivity columns only.
    sens_precision: str = "full"
    # 'lu' | 'inv' | 'inv32' | 'pallas' (CUDA kernels) | 'banded' (not
    # ported yet: raises)
    linear_solver: str = "inv"
    # (kl, ku) bandwidth of the state Jacobian, for linear_solver='banded'
    jac_bandwidth: tuple = None
    # Dense-output interpolation correction in f32 on top of the exact
    # D[0] anchor.
    dense_f32: bool = False
    # Dense-output windowing (0 = off; not ported yet: raises otherwise).
    dense_window: int = 0
    # Raise on a non-finite RHS at the initial condition.
    debug_checks: bool = False

    def __post_init__(self):
        if self.linear_solver not in ("lu", "inv", "inv32", "pallas",
                                      "banded"):
            raise ValueError(f"unknown linear_solver {self.linear_solver!r}")
        if self.linear_solver == "banded" and self.jac_bandwidth is None:
            raise ValueError("linear_solver='banded' requires "
                             "jac_bandwidth=(kl, ku)")
        if self.sens_precision not in ("full", "f32"):
            raise ValueError(
                f"unknown sens_precision {self.sens_precision!r}")
        if self.dense_window != 0 and self.dense_window < 2:
            raise ValueError("dense_window must be 0 (off) or >= 2")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Levenberg-Marquardt fit configuration.

    Tolerances follow ``scipy.optimize.least_squares``: relative cost
    reduction (ftol), relative step size (xtol), gradient norm (gtol).
    """

    ftol: float = 1e-8
    xtol: float = 1e-8
    gtol: float = 1e-8
    max_iter: int = 100
    # initial LM damping and its adaptation bounds
    lam0: float = 1e-3
    lam_min: float = 1e-12
    lam_max: float = 1e12
    # 'economical': residual-only trial integration, Jacobian recomputed
    #   only on acceptance. A batch integrates every member either way, so
    #   this pays trial + sensitivity integrations per iteration.
    # 'lockstep': residual and Jacobian together at every trial: one
    #   sensitivity integration per iteration, the mode for ensembles.
    eval_mode: str = "economical"

    def __post_init__(self):
        if self.eval_mode not in ("economical", "lockstep"):
            raise ValueError(f"unknown eval_mode {self.eval_mode!r}")
