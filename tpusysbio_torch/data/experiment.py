"""Experiments and measurements as static-shape records.

Port of ``tpusysbio/data/experiment.py``. ``Measurement`` and ``Experiment``
are host-side numpy records; ``ExperimentBatch`` stacks E experiments into
padded (E, T)/(E, M) tensors with masks on an explicit device. A
``Measurement`` row references its time by INDEX into the experiment's
``t_eval`` grid (the union of measurement times), so solver output aligns to
data by one gather.

Every field of the reference is carried, so shapes match it. Timed
``inputs``/``input_states`` (segments), ``preequilibrate``, ``y0_overrides``
and steady-state rows are constructed as the reference constructs them,
and ``Project`` (project/residuals.py) evaluates them: the segment loop,
pre-equilibration and steady-state rows through ``solvers/steady_state.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusysbio_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One timecourse of one observable: host-side construction record."""

    obs_index: int                # which model observable
    times: np.ndarray             # (n_t,)
    values: np.ndarray            # (n_t,)
    sigmas: np.ndarray            # (n_t,) measurement std devs
    # scale-factor group: measurements sharing a group id share one fitted
    # scale factor B (relative data); None -> absolute data (B = 1).
    scale_group: Optional[str] = None
    # Steady-state rows: the observable is measured at the experiment's
    # algebraic equilibrium f(y*, p) = 0 rather than at a timepoint;
    # ``times`` entries are ignored (conventionally 0 or inf).
    steady_state: bool = False

    def __post_init__(self):
        t = np.asarray(self.times, dtype=np.float64)
        v = np.asarray(self.values, dtype=np.float64)
        s = np.asarray(self.sigmas, dtype=np.float64)
        if not (t.shape == v.shape == s.shape and t.ndim == 1):
            raise ValueError("times/values/sigmas must be equal-length 1-D")
        object.__setattr__(self, "times", t)
        object.__setattr__(self, "values", v)
        object.__setattr__(self, "sigmas", s)

    @staticmethod
    def at_steady_state(obs_index: int, value: float, sigma: float,
                        scale_group: Optional[str] = None) -> "Measurement":
        """Convenience constructor for one equilibrium data point."""
        return Measurement(obs_index=obs_index, times=np.zeros(1),
                           values=np.asarray([value]),
                           sigmas=np.asarray([sigma]),
                           scale_group=scale_group, steady_state=True)


@dataclasses.dataclass(frozen=True)
class Experiment:
    """Host-side experiment record: measurements + parameter overrides.

    ``fixed_params`` maps model-parameter name -> value, expressing the
    reference's condition settings (e.g. input dose, knockout -> rate 0).
    ``t0`` starts the integration; the horizon is the last measurement time.

    ``inputs`` expresses the reference domain's TIMED perturbations —
    stimulus at t>0, dose steps, washout — the capability the reference
    stack implements with ``solve_ivp`` events + restarts (spec:
    ``scipy/integrate/_ivp/ivp.py:29-158``; SURVEY.md §2a #12, #4). Event
    times in this domain are known constants, so the mechanism
    is STATIC segment boundaries: each ``(time, param_name, value)`` entry
    clamps one model parameter to a constant from ``time`` onward (a later
    entry for the same parameter supersedes it — washout is a second
    entry restoring the basal value as a constant). The Project integrates
    segment-by-segment with state carried over and sensitivity columns
    chained (an overridden parameter's direction column is zeroed while
    clamped) — no data-dependent control flow.

    ``preequilibrate=True`` replaces ``y0(p)`` with the algebraic steady
    state under BASAL parameters (``p`` overridden by ``preeq_params``),
    solved by damped Newton with implicit-function-theorem dy*/dp chained
    into the trajectory sensitivity initial condition — the standard
    multi-experiment workflow (equilibrate under basal conditions, then
    perturb; BASELINE.json:10).
    """

    name: str
    measurements: Tuple[Measurement, ...]
    fixed_params: dict = dataclasses.field(default_factory=dict)
    t0: float = 0.0
    # timed perturbations: ((time, param_name, value), ...)
    inputs: Tuple[Tuple[float, str, float], ...] = ()
    # timed STATE assignments: ((time, state_name, value), ...) — at the
    # segment boundary starting at ``time`` the named state is SET to the
    # constant value (a bolus dose / reset; SBML event-assignment to a
    # species with a constant-time trigger lowers to this). Applied once
    # at that boundary; the assigned state's sensitivity rows reset to
    # zero there (a constant has no parameter dependence).
    input_states: Tuple[Tuple[float, str, float], ...] = ()
    preequilibrate: bool = False
    # basal-condition overrides for the pre-equilibration solve
    preeq_params: dict = dataclasses.field(default_factory=dict)
    # initial-VALUE overrides: state name -> value, applied after
    # ``model.y0(p)`` (and after pre-equilibration — PEtab condition-table
    # species-override semantics: non-overridden species keep the preeq
    # steady state, overridden ones reset). The overridden species'
    # sensitivity initial condition is zero (a constant start).
    y0_overrides: dict = dataclasses.field(default_factory=dict)

    def all_times(self) -> np.ndarray:
        ts = np.unique(np.concatenate(
            [m.times for m in self.measurements if not m.steady_state]
            + [np.asarray([self.t0])]))
        return ts

    def event_times(self) -> np.ndarray:
        """Distinct input times strictly inside (t0, t_end) — the segment
        boundaries. Inputs at exactly ``t0`` modify segment 0 and add no
        boundary; inputs at/after the horizon are rejected. State
        assignments (``input_states``) must lie strictly inside (a state
        jump at t0 is just a different y0)."""
        if not self.inputs and not self.input_states:
            return np.zeros(0)
        t_end = float(self.all_times()[-1])
        ts = np.unique([float(t) for t, _, _ in self.inputs]) \
            if self.inputs else np.zeros(0)
        if ts.size and ((ts < self.t0).any() or (ts >= t_end).any()):
            raise ValueError(
                f"experiment {self.name!r}: input times must lie in "
                f"[t0={self.t0}, t_end={t_end})")
        tss = np.unique([float(t) for t, _, _ in self.input_states]) \
            if self.input_states else np.zeros(0)
        if tss.size and ((tss <= self.t0).any() or (tss >= t_end).any()):
            raise ValueError(
                f"experiment {self.name!r}: input_states times must lie "
                f"strictly inside (t0={self.t0}, t_end={t_end})")
        ts = np.unique(np.concatenate([ts, tss]))
        return ts[ts > self.t0]


@dataclasses.dataclass(frozen=True)
class ExperimentBatch:
    """E experiments padded to static shapes (tensors on one device).

    Tensor fields:
      t_eval:   (E, T) output-time grids, padded by repeating the last time
      t0:       (E,)
      t_end:    (E,)
      m_t_idx:  (E, M) int32 index into the experiment's t_eval row
      m_obs:    (E, M) int32 observable index
      values:   (E, M)
      sigmas:   (E, M)
      group:    (E, M) int32 scale-factor group id, -1 for absolute data
      mask:     (E, M) bool validity (padding rows are False)
      m_is_ss:  (E, M) bool — row gathers from the algebraic steady state
                instead of the trajectory (``m_t_idx`` is 0 there)

    ``n_groups`` is the number of distinct scale-factor groups across the
    whole batch: scale factors are a project-level quantity (one B per
    group, pooled over experiments). The optional fields hold the timed
    perturbations (``seg_*``, (E, S+1)/(E, S, P)/(E, S, n)), the
    pre-equilibration flags (``preeq*``) and the initial-value overrides
    (``y0_*``) in the reference's shapes.
    """

    t_eval: torch.Tensor
    t0: torch.Tensor
    t_end: torch.Tensor
    m_t_idx: torch.Tensor
    m_obs: torch.Tensor
    values: torch.Tensor
    sigmas: torch.Tensor
    group: torch.Tensor
    mask: torch.Tensor
    m_is_ss: torch.Tensor
    n_groups: int
    group_names: Tuple[str, ...] = ()
    has_steady: bool = False
    seg_bounds: Optional[torch.Tensor] = None
    seg_mask: Optional[torch.Tensor] = None
    seg_vals: Optional[torch.Tensor] = None
    n_segments: int = 1
    seg_y0_mask: Optional[torch.Tensor] = None
    seg_y0_vals: Optional[torch.Tensor] = None
    preeq: Optional[torch.Tensor] = None
    preeq_mask: Optional[torch.Tensor] = None
    preeq_vals: Optional[torch.Tensor] = None
    has_preeq: bool = False
    y0_mask: Optional[torch.Tensor] = None
    y0_vals: Optional[torch.Tensor] = None
    has_y0_over: bool = False

    @property
    def n_experiments(self) -> int:
        return self.t_eval.shape[0]

    @property
    def n_times(self) -> int:
        return self.t_eval.shape[1]

    @property
    def n_meas(self) -> int:
        return self.m_t_idx.shape[1]

    @property
    def n_residuals(self) -> int:
        return self.n_experiments * self.n_meas

    @property
    def device(self) -> torch.device:
        return self.t_eval.device

    @staticmethod
    def from_experiments(experiments: Sequence[Experiment],
                         dtype=torch.float64,
                         param_names: Optional[Sequence[str]] = None,
                         state_names: Optional[Sequence[str]] = None,
                         device="cuda") -> "ExperimentBatch":
        """Pad & pack host-side experiments into one static batch on
        ``device``.

        ``param_names`` (the model's parameter order) is required when any
        experiment declares timed ``inputs`` or ``preequilibrate`` — those
        override model parameters by name. ``state_names`` (the model's
        state order) is required when any experiment declares
        ``input_states`` or ``y0_overrides``."""
        dev = resolve_device(device)

        def _t(arr, dt=None):
            return torch.as_tensor(np.asarray(arr), dtype=dt, device=dev)

        E = len(experiments)
        grids = [e.all_times() for e in experiments]
        T = max(g.shape[0] for g in grids)
        M = max(sum(m.times.shape[0] for m in e.measurements)
                for e in experiments)

        group_names: List[str] = []
        t_eval = np.zeros((E, T))
        t0 = np.zeros((E,))
        t_end = np.zeros((E,))
        m_t_idx = np.zeros((E, M), dtype=np.int32)
        m_obs = np.zeros((E, M), dtype=np.int32)
        values = np.zeros((E, M))
        sigmas = np.ones((E, M))
        group = np.full((E, M), -1, dtype=np.int32)
        mask = np.zeros((E, M), dtype=bool)
        m_is_ss = np.zeros((E, M), dtype=bool)

        for e_i, exp in enumerate(experiments):
            g = grids[e_i]
            t_eval[e_i, : g.shape[0]] = g
            t_eval[e_i, g.shape[0]:] = g[-1]
            t0[e_i] = exp.t0
            t_end[e_i] = g[-1]
            j = 0
            for meas in exp.measurements:
                if meas.scale_group is None:
                    gid = -1
                else:
                    if meas.scale_group not in group_names:
                        group_names.append(meas.scale_group)
                    gid = group_names.index(meas.scale_group)
                for t, v, s in zip(meas.times, meas.values, meas.sigmas):
                    if meas.steady_state:
                        m_t_idx[e_i, j] = 0
                        m_is_ss[e_i, j] = True
                    else:
                        t_idx = int(np.searchsorted(g, t))
                        assert g[t_idx] == t
                        m_t_idx[e_i, j] = t_idx
                    m_obs[e_i, j] = meas.obs_index
                    values[e_i, j] = v
                    sigmas[e_i, j] = s
                    group[e_i, j] = gid
                    mask[e_i, j] = True
                    j += 1

        # --- timed perturbations -> static segments --------------------
        any_inputs = any(exp.inputs or exp.input_states
                         for exp in experiments)
        any_state_inputs = any(exp.input_states for exp in experiments)
        any_preeq = any(exp.preequilibrate for exp in experiments)
        if (any_inputs or any_preeq) and param_names is None:
            raise ValueError(
                "experiments with timed inputs or preequilibrate need "
                "param_names= (the model's parameter order)")
        if any_state_inputs and state_names is None:
            raise ValueError(
                "experiments with input_states need state_names= "
                "(the model's state order)")
        seg_kwargs = {}
        if any_inputs:
            P = len(param_names)
            name_idx = {n: i for i, n in enumerate(param_names)}
            events = [exp.event_times() for exp in experiments]
            S = max(ev.shape[0] for ev in events) + 1
            seg_bounds = np.zeros((E, S + 1))
            seg_mask = np.zeros((E, S, P), dtype=bool)
            seg_vals = np.zeros((E, S, P))
            if any_state_inputs:
                n = len(state_names)
                sname_idx = {s: i for i, s in enumerate(state_names)}
                seg_y0_mask = np.zeros((E, S, n), dtype=bool)
                seg_y0_vals = np.zeros((E, S, n))
            for e_i, exp in enumerate(experiments):
                ev = events[e_i]
                bounds = np.concatenate(
                    [[exp.t0], ev,
                     np.full(S - ev.shape[0], t_end[e_i])])
                seg_bounds[e_i] = bounds
                # forward-fill overrides: an input at time t clamps its
                # parameter in every segment starting at/after t, until a
                # LATER input for the same parameter supersedes it
                for t_in, pname, val in sorted(exp.inputs,
                                               key=lambda iv: iv[0]):
                    if pname not in name_idx:
                        raise ValueError(
                            f"experiment {exp.name!r}: unknown input "
                            f"parameter {pname!r}")
                    j = name_idx[pname]
                    active = bounds[:-1] >= float(t_in) - 1e-12
                    seg_mask[e_i, active, j] = True
                    seg_vals[e_i, active, j] = float(val)
                # one-shot state assignments at their own boundary
                for t_in, sname, val in exp.input_states:
                    if sname not in sname_idx:
                        raise ValueError(
                            f"experiment {exp.name!r}: unknown state "
                            f"{sname!r} in input_states")
                    k = int(np.argmin(np.abs(bounds[:-1] - float(t_in))))
                    assert abs(bounds[k] - float(t_in)) < 1e-12
                    seg_y0_mask[e_i, k, sname_idx[sname]] = True
                    seg_y0_vals[e_i, k, sname_idx[sname]] = float(val)
            seg_kwargs = dict(
                seg_bounds=_t(seg_bounds, dtype),
                seg_mask=_t(seg_mask),
                seg_vals=_t(seg_vals, dtype),
                n_segments=S)
            if any_state_inputs:
                seg_kwargs.update(
                    seg_y0_mask=_t(seg_y0_mask),
                    seg_y0_vals=_t(seg_y0_vals, dtype))
        preeq_kwargs = {}
        if any_preeq:
            P = len(param_names)
            name_idx = {n: i for i, n in enumerate(param_names)}
            preeq = np.zeros((E,), dtype=bool)
            preeq_mask = np.zeros((E, P), dtype=bool)
            preeq_vals = np.zeros((E, P))
            for e_i, exp in enumerate(experiments):
                preeq[e_i] = exp.preequilibrate
                for pname, val in exp.preeq_params.items():
                    if pname not in name_idx:
                        raise ValueError(
                            f"experiment {exp.name!r}: unknown preeq "
                            f"parameter {pname!r}")
                    if not exp.preequilibrate:
                        raise ValueError(
                            f"experiment {exp.name!r}: preeq_params "
                            "without preequilibrate=True")
                    preeq_mask[e_i, name_idx[pname]] = True
                    preeq_vals[e_i, name_idx[pname]] = float(val)
            preeq_kwargs = dict(
                preeq=_t(preeq),
                preeq_mask=_t(preeq_mask),
                preeq_vals=_t(preeq_vals, dtype),
                has_preeq=True)

        y0_kwargs = {}
        if any(exp.y0_overrides for exp in experiments):
            if state_names is None:
                raise ValueError(
                    "experiments with y0_overrides need state_names= "
                    "(the model's state order)")
            n = len(state_names)
            sname_idx = {s: i for i, s in enumerate(state_names)}
            y0_mask = np.zeros((E, n), dtype=bool)
            y0_vals = np.zeros((E, n))
            for e_i, exp in enumerate(experiments):
                for sname, val in exp.y0_overrides.items():
                    if sname not in sname_idx:
                        raise ValueError(
                            f"experiment {exp.name!r}: unknown state "
                            f"{sname!r} in y0_overrides")
                    y0_mask[e_i, sname_idx[sname]] = True
                    y0_vals[e_i, sname_idx[sname]] = float(val)
            y0_kwargs = dict(y0_mask=_t(y0_mask),
                             y0_vals=_t(y0_vals, dtype),
                             has_y0_over=True)

        return ExperimentBatch(
            t_eval=_t(t_eval, dtype), t0=_t(t0, dtype),
            t_end=_t(t_end, dtype),
            m_t_idx=_t(m_t_idx), m_obs=_t(m_obs),
            values=_t(values, dtype), sigmas=_t(sigmas, dtype),
            group=_t(group), mask=_t(mask), m_is_ss=_t(m_is_ss),
            n_groups=len(group_names), group_names=tuple(group_names),
            has_steady=bool(m_is_ss.any()), **seg_kwargs, **preeq_kwargs,
            **y0_kwargs)
