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

``simulate`` takes ``events`` (``solvers.EventSpec``) and
``dense_output`` (the ``bdf`` solver's export for ``solvers.OdeSolution``),
and a decreasing ``t_span`` integrates backward by time reflection: the
steppers are forward-only, so ``τ = t0 − t`` with ``dy/dτ = −f(t0 − τ,
y)`` runs the same forward machinery (``_reflected``); ``t_eval`` then
decreases from t0 and ``t_final`` is mapped back. A backward ``t_span``
with ``events`` or dense output raises ``ValueError``, as in the
reference.
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

    def _prepare(self, p, t_eval, device):
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

    @staticmethod
    def _dense_kw(solver, dense_output):
        if not dense_output:
            return {}
        if solver != "bdf":
            raise ValueError(
                "dense_output=True is supported by the 'bdf' solver")
        return dict(dense_export=True)

    def _backward(self, run, t_span, t_eval, **kw):
        """``run`` on the time-reflected model over ``[0, t0 − t1]``, with
        ``t_final`` mapped back."""
        t0 = float(t_span[0])
        res = run(self._reflected(t0), (0.0, t0 - float(t_span[1])),
                  t0 - torch.as_tensor(t_eval, dtype=torch.float64), **kw)
        return res._replace(t_final=t0 - res.t_final)

    def simulate(self, p, t_span, t_eval, solver: str = "bdf",
                 config: Optional[SolverConfig] = None, events=None,
                 dense_output: bool = False, device="cuda"):
        """Trajectories of the batch ``p`` (B, m) at ``t_eval``. Returns an
        ``IntegrateResult`` whose fields lead with B.

        ``events``: a ``solvers.EventSpec`` (the ``bdf`` solver) whose
        ``fn(t, y)`` closes over per-member thresholds as (B, ·) tensors.
        ``dense_output=True`` (``bdf`` only) fills the result's ``seg_*``
        buffers for ``solvers.OdeSolution``. A decreasing ``t_span``
        integrates backward (see the module docstring); pass ``t_eval``
        decreasing from t0 to t1."""
        from tpusysbio_torch import solvers

        config = config or SolverConfig()
        if float(t_span[1]) < float(t_span[0]):
            if events is not None or dense_output:
                raise ValueError(
                    "backward t_span does not support events/dense_output")
            return self._backward(
                lambda mdl, ts, te: mdl.simulate(p, ts, te, solver=solver,
                                                 config=config,
                                                 device=device),
                t_span, t_eval)
        kw = self._dense_kw(solver, dense_output)
        if events is not None:
            kw["events"] = events
        p, t_eval = self._prepare(p, t_eval, device)
        fn = solvers.SOLVERS[solver]
        return fn(lambda t, y: self.rhs(t, y, p.to(y.dtype)), t_span,
                  self.y0(p), t_eval, config=config, jac=self._jac(p), **kw)

    def simulate_sensitivities(self, p, t_span, t_eval, solver: str = "bdf",
                               config: Optional[SolverConfig] = None,
                               dense_output: bool = False, device="cuda"):
        """Trajectories plus forward sensitivities dy/dp (B, T, n, m).
        ``dense_output`` and a decreasing ``t_span`` as in
        :meth:`simulate`; backward, the sensitivity RHS reflects with the
        state RHS."""
        from tpusysbio_torch import solvers

        config = config or SolverConfig()
        if float(t_span[1]) < float(t_span[0]):
            if dense_output:
                raise ValueError(
                    "backward t_span does not support dense_output")
            return self._backward(
                lambda mdl, ts, te: mdl.simulate_sensitivities(
                    p, ts, te, solver=solver, config=config, device=device),
                t_span, t_eval)
        kw = self._dense_kw(solver, dense_output)
        p, t_eval = self._prepare(p, t_eval, device)
        if self.rhs_sens is not None:
            def sens_rhs(t, y, S):
                return self.rhs_sens(t, y, S, p)
        else:
            sens_rhs = make_sens_rhs(self.rhs, p)
        fn = solvers.SOLVERS[solver]
        return fn(lambda t, y: self.rhs(t, y, p.to(y.dtype)), t_span,
                  self.y0(p), t_eval, config=config, sens_rhs=sens_rhs,
                  s0=self.y0_sensitivity(p), jac=self._jac(p), **kw)

    def _reflected(self, t0: float) -> "OdeModel":
        """The time-reflected system ``τ = t0 − t``: forward integration
        of the reflected model is backward integration of this one."""
        def opt(fn, wrap):
            return None if fn is None else wrap

        return dataclasses.replace(
            self,
            rhs=lambda tau, y, p: -self.rhs(t0 - tau, y, p),
            rhs_jac=opt(self.rhs_jac, lambda tau, y, p:
                        -self.rhs_jac(t0 - tau, y, p)),
            rhs_sens=opt(self.rhs_sens, lambda tau, y, S, p:
                         -self.rhs_sens(t0 - tau, y, S, p)),
            rhs_sens_dir=opt(self.rhs_sens_dir, lambda tau, y, S, p, C:
                             -self.rhs_sens_dir(t0 - tau, y, S, p, C)))

    def y0_sensitivity(self, p: torch.Tensor) -> torch.Tensor:
        """``∂y0/∂p`` per member, (B, n, m), by forward-mode AD."""
        def one(pp):
            return self.y0(pp[None])[0]

        return torch.func.vmap(torch.func.jacfwd(one))(p)

    def jacobian(self, t, y, p) -> torch.Tensor:
        """State Jacobian ``∂f/∂y`` (B, n, n) by forward-mode AD, with
        ``t`` (B,), ``y`` (B, n) and ``p`` (B, m)."""
        return batched_jacobian(lambda yy: self.rhs(t, yy, p), y)
