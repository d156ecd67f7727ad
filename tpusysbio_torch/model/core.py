"""The ``OdeModel`` container, port of ``tpusysbio/model/core.py``.

Every callable takes a leading member dimension:

- ``rhs(t, y, p) -> (B, n)`` with ``t`` (B,), ``y`` (B, n), ``p`` (B, m);
- ``y0(p) -> (B, n)``;
- ``observables(y, p) -> (B, n_obs)``;
- optional closed-form fast paths ``rhs_jac(t, y, p) -> (B, n, n)``,
  ``rhs_sens(t, y, S, p) -> (B, n, m)`` and
  ``rhs_sens_dir(t, y, S, p, C) -> (B, n, G)``. Without them the stepper
  takes the Jacobian by forward-mode AD and the sensitivities come from
  ``sens/forward.py`` (one jvp of ``rhs`` per column).

Only forward integration is ported so far: a decreasing ``t_span`` (the
reference's time reflection), ``events`` and ``dense_output`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from tpusysbio_torch import resolve_device
from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.sens import make_sens_rhs
from tpusysbio_torch.solvers.common import batched_jacobian


@dataclasses.dataclass(frozen=True)
class OdeModel:
    """A parameterized ODE system with observables (batched callables)."""

    name: str
    n_states: int
    n_params: int
    n_obs: int
    rhs: Callable
    y0: Callable
    observables: Callable
    param_names: Tuple[str, ...] = ()
    state_names: Tuple[str, ...] = ()
    rhs_jac: Optional[Callable] = None
    rhs_sens: Optional[Callable] = None
    rhs_sens_dir: Optional[Callable] = None

    def __post_init__(self):
        if self.param_names and len(self.param_names) != self.n_params:
            raise ValueError("param_names length mismatch")
        if self.state_names and len(self.state_names) != self.n_states:
            raise ValueError("state_names length mismatch")

    def _prepare(self, p, t_span, t_eval, events, dense_output, device):
        if events is not None or dense_output:
            raise NotImplementedError(
                "events and dense_output are not ported yet")
        if float(t_span[1]) < float(t_span[0]):
            raise NotImplementedError(
                "backward t_span (time reflection) is not ported yet")
        dev = resolve_device(device)
        p = torch.as_tensor(p, device=dev)
        if not p.is_floating_point():
            p = p.to(torch.float64)
        if p.ndim != 2 or p.shape[1] != self.n_params:
            raise ValueError(
                f"p must be (B, {self.n_params}); got {tuple(p.shape)}")
        t_eval = torch.as_tensor(t_eval, dtype=p.dtype, device=dev)
        return p, t_eval

    def _jac(self, p):
        if self.rhs_jac is None:
            return None
        return lambda t, y: self.rhs_jac(t, y, p.to(y.dtype))

    def simulate(self, p, t_span, t_eval, solver: str = "bdf",
                 config: Optional[SolverConfig] = None, events=None,
                 dense_output: bool = False, device="cuda"):
        """Forward trajectories of the batch ``p`` (B, m) at ``t_eval``.
        Returns an ``IntegrateResult`` whose fields lead with B."""
        from tpusysbio_torch import solvers

        config = config or SolverConfig()
        p, t_eval = self._prepare(p, t_span, t_eval, events, dense_output,
                                  device)
        fn = solvers.SOLVERS[solver]
        return fn(lambda t, y: self.rhs(t, y, p.to(y.dtype)), t_span,
                  self.y0(p), t_eval, config=config, jac=self._jac(p))

    def simulate_sensitivities(self, p, t_span, t_eval, solver: str = "bdf",
                               config: Optional[SolverConfig] = None,
                               dense_output: bool = False, device="cuda"):
        """Trajectories plus forward sensitivities dy/dp (B, T, n, m)."""
        from tpusysbio_torch import solvers

        config = config or SolverConfig()
        p, t_eval = self._prepare(p, t_span, t_eval, None, dense_output,
                                  device)
        if self.rhs_sens is not None:
            def sens_rhs(t, y, S):
                return self.rhs_sens(t, y, S, p)
        else:
            sens_rhs = make_sens_rhs(self.rhs, p)
        fn = solvers.SOLVERS[solver]
        return fn(lambda t, y: self.rhs(t, y, p.to(y.dtype)), t_span,
                  self.y0(p), t_eval, config=config, sens_rhs=sens_rhs,
                  s0=self.y0_sensitivity(p), jac=self._jac(p))

    def y0_sensitivity(self, p: torch.Tensor) -> torch.Tensor:
        """``∂y0/∂p`` per member, (B, n, m), by forward-mode AD."""
        def one(pp):
            return self.y0(pp[None])[0]

        return torch.func.vmap(torch.func.jacfwd(one))(p)

    def jacobian(self, t, y, p) -> torch.Tensor:
        """State Jacobian ``∂f/∂y`` (B, n, n) by forward-mode AD, with
        ``t`` (B,), ``y`` (B, n) and ``p`` (B, m)."""
        return batched_jacobian(lambda yy: self.rhs(t, yy, p), y)
