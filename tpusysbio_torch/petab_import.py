"""PEtab v1 problem import, the port's own copy of
``tpusysbio/petab_import.py``.

PEtab bundles an SBML model with TSV tables (conditions, observables,
measurements, parameters) into a parameter-estimation problem. The table
logic is the reference's; the pieces it assembles are the port's:
``model.sbml_import.from_sbml``, ``data.Experiment``/``ExperimentBatch``,
``project.ParameterMap``/``Priors``/``Project``, all on ``device``. The
problem file is read by ``config.parse_yaml`` (its block-list subset), so
no YAML package is needed.

Supported subset (raise ``PetabError``, never mis-fit, outside it):

- problem YAML (format_version 1) or the table paths passed directly;
- condition table: numeric overrides of model PARAMETERS and of model
  SPECIES' initial values per condition (a non-numeric override raises
  ``PetabError``; compartment overrides are unsupported);
- observable table: ``observableFormula`` over states/parameters with
  ``observableParameter<k>_<observableId>`` placeholders filled per
  measurement (numbers or parameter ids, including ESTIMATED output
  parameters, which are appended to the model's parameter vector);
  ``observableTransformation`` lin/log/log10; normal noise;
  ``noiseFormula`` a number, a non-estimated parameter id or
  ``noiseParameter<k>_<observableId>`` placeholders filled with numbers or
  non-estimated ids (estimated noise is unsupported);
- measurement table: ``observableId, simulationConditionId, time,
  measurement`` (+ ``observableParameters``/``noiseParameters``,
  ``preequilibrationConditionId``, ``time = inf`` for steady-state rows);
- parameter table: ``parameterScale`` lin/log/log10 (bounds and nominals
  to the fit's natural-log θ), ``estimate`` 0/1, priors
  ``parameterScaleNormal``/``logNormal`` → ``Priors``.

Distinct ``(observableId, observableParameters)`` pairs expand into
distinct internal observables with the placeholders baked in.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpusysbio_torch import resolve_device
from tpusysbio_torch.config import SolverConfig, parse_yaml


class PetabError(ValueError):
    pass


def _read_tsv(path: str) -> List[dict]:
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh, delimiter="\t"))
    if not rows:
        raise PetabError(f"empty PEtab table: {path}")
    return rows


def _get(row: dict, key: str, default=None):
    v = row.get(key)
    return default if v is None or v == "" else v


def _number(val: str, cid: str, col: str) -> float:
    """A condition-table override; a parameter id or formula (allowed by
    PEtab v1) is outside the supported subset."""
    try:
        return float(val)
    except ValueError:
        raise PetabError(
            f"condition {cid!r} sets {col!r} to {val!r}: only numeric "
            "condition-table overrides are supported (parameter ids and "
            "formulas are not)") from None


@dataclasses.dataclass(frozen=True)
class PetabProblem:
    """A loaded PEtab problem, assembled into native objects.

    Attributes:
      model: ``OdeModel`` with the PEtab observables installed.
      batch: one experiment per simulation condition (measurement
        grids padded/masked).
      pmap: estimated parameters shared across conditions; condition
        overrides and non-estimated parameters fixed.
      priors: native ``Priors`` (None when the table declares none).
      project: ready-to-fit ``Project``.
      theta0: nominal values in θ (natural log) space.
      lb / ub: bounds in θ space for ``trf_fit``.
      x_ids: estimated parameter ids, θ order.
    """

    model: object
    batch: object
    pmap: object
    priors: Optional[object]
    project: object
    theta0: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    x_ids: Tuple[str, ...]
    # expanded internal observables, "<observableId>[<observableParameters>]"
    # per distinct (observableId, observableParameters) combination
    obs_labels: Tuple[str, ...] = ()

    def sample_startpoints(self, generator, n: int):
        """Latin-hypercube starts inside the PEtab bounds (θ space), (n, G)
        on the problem's device; ``generator`` is a ``torch.Generator``."""
        import torch

        from tpusysbio_torch.fit import latin_hypercube

        dev = self.batch.device
        return latin_hypercube(generator, n,
                               torch.as_tensor(self.lb, device=dev),
                               torch.as_tensor(self.ub, device=dev))


def _to_theta(val: float) -> float:
    """PEtab linear-scale value (nominal/bounds are ALWAYS linear in
    PEtab v1) → this package's natural-log θ."""
    if val <= 0:
        raise PetabError(
            f"linear value {val} <= 0: the fit vector is log-space "
            "(positivity is structural)")
    return math.log(val)


def _augment_model(model, extra_names):
    """Append estimated OUTPUT parameters (PEtab ``observableParameters``
    targets, e.g. Boehm-class scaling factors) to the model's parameter
    vector: the dynamics see only ``p[:P0]``; the extra entries exist for
    the observable map. Closed-form sensitivity fast paths are dropped
    (their column shapes assume the SBML parameter count) — the jvp
    fallback handles the augmented vector exactly, and with
    ``sens_mode='theta'`` (the Project default when G < P) only the G fit
    columns are propagated anyway."""
    import dataclasses as dc

    P0 = model.n_params
    base_rhs, base_y0, base_jac = model.rhs, model.y0, model.rhs_jac

    def rhs(t, y, p):
        return base_rhs(t, y, p[:, :P0])

    def y0(p):
        return base_y0(p[:, :P0])

    jac = (None if base_jac is None
           else (lambda t, y, p: base_jac(t, y, p[:, :P0])))
    return dc.replace(
        model, rhs=rhs, y0=y0, rhs_jac=jac, rhs_sens=None,
        rhs_sens_dir=None, n_params=P0 + len(extra_names),
        param_names=tuple(model.param_names) + tuple(extra_names))


def from_petab(source, config: Optional[SolverConfig] = None,
               device="cuda") -> PetabProblem:
    """Load a PEtab problem onto ``device`` (the card by default;
    ``device="cpu"`` for the CPU).

    Args:
      source: path to the problem YAML, or a dict with keys
        ``sbml``/``conditions``/``observables``/``measurements``/
        ``parameters`` mapping to file paths.
      config: solver config for the assembled ``Project``.
    """
    import sympy as sp

    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.model.sbml_import import from_sbml
    from tpusysbio_torch.model.sympy_import import _lambdify, _stack
    from tpusysbio_torch.project import ParameterMap, Priors, Project

    dev = resolve_device(device)
    if isinstance(source, str):
        base = os.path.dirname(os.path.abspath(source))
        with open(source) as fh:
            doc = parse_yaml(fh.read())
        probs = doc.get("problems")
        if not probs or len(probs) != 1:
            raise PetabError("need exactly one entry in problems[]")
        pr = probs[0]

        def one(key):
            files = pr.get(key) or []
            if len(files) != 1:
                raise PetabError(f"need exactly one file in {key}")
            return os.path.join(base, files[0])

        paths = {
            "sbml": one("sbml_files"),
            "conditions": one("condition_files"),
            "observables": one("observable_files"),
            "measurements": one("measurement_files"),
            "parameters": os.path.join(base, doc["parameter_file"]),
        }
    else:
        paths = dict(source)

    model, p_nominal_sbml = from_sbml(paths["sbml"])
    pnames = list(model.param_names)
    sbml_defaults = dict(zip(pnames, p_nominal_sbml))

    # ---- parameter table -------------------------------------------------
    par_rows = _read_tsv(paths["parameters"])
    estimated: List[str] = []
    theta0, lb, ub = [], [], []
    fixed_vals: Dict[str, float] = {}
    prior_spec: Dict[str, Tuple[float, float]] = {}
    for row in par_rows:
        pid = _get(row, "parameterId")
        if pid is None:
            raise PetabError("parameter row without parameterId")
        scale = _get(row, "parameterScale", "lin")
        if scale not in ("lin", "log", "log10"):
            raise PetabError(f"unknown parameterScale {scale!r}")
        nominal = _get(row, "nominalValue")
        if int(_get(row, "estimate", 1)) == 1:
            # ids not in the SBML model are estimated OUTPUT parameters
            # (observableParameters targets); they are appended to the
            # model's parameter vector below (_augment_model)
            estimated.append(pid)
            theta0.append(_to_theta(float(nominal))
                          if nominal is not None else 0.0)
            lo, hi = _get(row, "lowerBound"), _get(row, "upperBound")
            if lo is None or hi is None:
                raise PetabError(f"estimated {pid!r} needs bounds")
            lb.append(_to_theta(float(lo)))
            ub.append(_to_theta(float(hi)))
            pt = _get(row, "objectivePriorType")
            if pt:
                pp = _get(row, "objectivePriorParameters")
                if pp is None:
                    raise PetabError(f"prior on {pid!r} without "
                                     "objectivePriorParameters")
                a, b = (float(v) for v in str(pp).split(";"))
                if pt == "parameterScaleNormal":
                    # prior on the PEtab-scale value; convert to ln
                    if scale == "log10":
                        mu, sig = a * math.log(10.0), b * math.log(10.0)
                    elif scale == "log":
                        mu, sig = a, b
                    else:
                        raise PetabError(
                            "parameterScaleNormal with lin scale is a "
                            "Gaussian on the linear value — not "
                            "expressible as a log-space row")
                elif pt in ("logNormal", "normal"):
                    if pt == "normal":
                        # approximate: Normal(a, b) on the linear value;
                        # refuse rather than silently mis-weight
                        raise PetabError(
                            "objectivePriorType 'normal' (linear-space "
                            "Gaussian) is unsupported; use logNormal or "
                            "parameterScaleNormal")
                    mu, sig = a, b  # logNormal: a = mean of ln, b = sd
                else:
                    raise PetabError(f"unsupported prior type {pt!r}")
                prior_spec[pid] = (math.exp(mu), sig)
        else:
            if nominal is None:
                raise PetabError(f"non-estimated {pid!r} needs a "
                                 "nominalValue")
            fixed_vals[pid] = float(nominal)

    # ---- estimated output parameters -> model augmentation ---------------
    extra_est = [pid for pid in estimated if pid not in pnames]
    if extra_est:
        model = _augment_model(model, extra_est)
    pnames_aug = pnames + extra_est

    # ---- observable table -----------------------------------------------
    import re as _re

    obs_rows = _read_tsv(paths["observables"])
    state_names = list(model.state_names)
    state_syms = [sp.Symbol(s) for s in state_names]
    param_syms = [sp.Symbol(s) for s in pnames_aug]
    sym_table = {str(s): s for s in state_syms + param_syms}
    known_syms = set(state_syms) | set(param_syms)
    # raw per-observableId records; expansion into concrete internal
    # observables happens per distinct (oid, observableParameters) pair
    obs_meta: Dict[str, dict] = {}
    for row in obs_rows:
        oid = _get(row, "observableId")
        if oid is None:
            raise PetabError("observable row without observableId")
        transform = _get(row, "observableTransformation", "lin")
        if transform not in ("lin", "log", "log10"):
            raise PetabError(f"{oid}: unknown observableTransformation "
                             f"{transform!r}")
        if _get(row, "noiseDistribution", "normal") != "normal":
            raise PetabError(f"{oid}: only normal noise is supported")
        formula = _get(row, "observableFormula")
        if formula is None:
            raise PetabError(f"{oid}: missing observableFormula")
        try:
            expr = sp.sympify(formula, locals=dict(sym_table))
        except Exception as e:  # pragma: no cover - sympy message varies
            raise PetabError(f"{oid}: cannot parse observableFormula "
                             f"{formula!r}: {e}")
        op_pat = _re.compile(rf"^observableParameter(\d+)_{_re.escape(oid)}$")
        n_op = 0
        for s in expr.free_symbols - known_syms:
            mt = op_pat.match(str(s))
            if not mt:
                raise PetabError(
                    f"{oid}: formula references unknown symbol {s}")
            n_op = max(n_op, int(mt.group(1)))
        nf = _get(row, "noiseFormula", "1.0")
        try:
            noise_expr = sp.sympify(str(nf), locals=dict(sym_table))
        except Exception as e:  # pragma: no cover
            raise PetabError(f"{oid}: cannot parse noiseFormula "
                             f"{nf!r}: {e}")
        np_pat = _re.compile(rf"^noiseParameter(\d+)_{_re.escape(oid)}$")
        n_np = 0
        for s in noise_expr.free_symbols:
            mt = np_pat.match(str(s))
            if mt:
                n_np = max(n_np, int(mt.group(1)))
            elif str(s) in estimated:
                raise PetabError(
                    f"{oid}: noiseFormula references estimated parameter "
                    f"{s} (noise estimation is not supported: the "
                    "2 log sigma likelihood term is not a least-squares "
                    "row)")
            elif str(s) in fixed_vals:
                noise_expr = noise_expr.subs(s, float(fixed_vals[str(s)]))
            elif str(s) in sbml_defaults:
                noise_expr = noise_expr.subs(
                    s, float(sbml_defaults[str(s)]))
            else:
                raise PetabError(
                    f"{oid}: noiseFormula symbol {s} is neither a "
                    "noiseParameter placeholder nor a non-estimated "
                    "parameter")
        obs_meta[oid] = dict(expr=expr, transform=transform, n_op=n_op,
                             noise_expr=noise_expr, n_np=n_np,
                             op_pat=op_pat, np_pat=np_pat)

    def _op_token(oid, tok):
        """One observableParameters token -> number or parameter symbol."""
        try:
            return sp.Float(float(tok))
        except ValueError:
            pass
        if tok in pnames_aug:
            return sp.Symbol(tok)
        if tok in fixed_vals:
            return sp.Float(float(fixed_vals[tok]))
        raise PetabError(
            f"{oid}: observableParameters token {tok!r} is neither "
            "numeric nor a known parameter id")

    # ---- condition table --------------------------------------------------
    cond_rows = _read_tsv(paths["conditions"])
    conditions: Dict[str, Dict[str, float]] = {}
    cond_species: Dict[str, Dict[str, float]] = {}
    cond_order: List[str] = []
    for row in cond_rows:
        cid = _get(row, "conditionId")
        if cid is None:
            raise PetabError("condition row without conditionId")
        over: Dict[str, float] = {}
        sp_over: Dict[str, float] = {}
        for col, val in row.items():
            if col in ("conditionId", "conditionName") or val in (None, ""):
                continue
            if col in pnames:
                if col in estimated:
                    raise PetabError(
                        f"condition {cid!r} overrides estimated parameter "
                        f"{col!r} (condition-specific estimation is not "
                        "supported)")
                over[col] = _number(val, cid, col)
            elif col in state_names:
                # numeric initial-value override; NaN = keep model default
                v = _number(val, cid, col)
                if not math.isnan(v):
                    sp_over[col] = v
            else:
                raise PetabError(
                    f"condition {cid!r} overrides {col!r}, which is "
                    "neither a model parameter nor a species "
                    "(compartment overrides are not supported)")
        conditions[cid] = over
        cond_species[cid] = sp_over
        cond_order.append(cid)

    # ---- measurement table -------------------------------------------------
    meas_rows = _read_tsv(paths["measurements"])
    used_conditions: List[str] = []
    preeq_of: Dict[str, Optional[str]] = {}
    series: Dict[tuple, dict] = {}
    # distinct (observableId, observableParameters) -> expanded observable
    expanded: Dict[tuple, int] = {}
    exp_obs_exprs: List[sp.Expr] = []
    exp_obs_transform: List[str] = []
    exp_obs_label: List[str] = []

    def _expand_obs(oid: str, op_str: str) -> int:
        key = (oid, op_str)
        if key in expanded:
            return expanded[key]
        meta = obs_meta[oid]
        tokens = [t.strip() for t in op_str.split(";") if t.strip() != ""] \
            if op_str else []
        if len(tokens) != meta["n_op"]:
            raise PetabError(
                f"{oid}: observableParameters has {len(tokens)} values "
                f"for {meta['n_op']} placeholder(s)")
        sub = {sp.Symbol(f"observableParameter{k}_{oid}"):
               _op_token(oid, tok) for k, tok in enumerate(tokens, 1)}
        expr = meta["expr"].subs(sub)
        if meta["transform"] == "log":
            expr = sp.log(expr)
        elif meta["transform"] == "log10":
            expr = sp.log(expr) / sp.log(10)
        idx = len(exp_obs_exprs)
        expanded[key] = idx
        exp_obs_exprs.append(expr)
        exp_obs_transform.append(meta["transform"])
        exp_obs_label.append(f"{oid}[{op_str}]" if op_str else oid)
        return idx

    def _row_sigma(oid: str, np_str: str) -> float:
        meta = obs_meta[oid]
        tokens = [t.strip() for t in np_str.split(";") if t.strip() != ""] \
            if np_str else []
        if meta["n_np"] == 0:
            # no placeholders: a single numeric noiseParameters entry
            # overrides the (numeric) noiseFormula per PEtab convention
            if len(tokens) == 1:
                try:
                    return float(tokens[0])
                except ValueError:
                    if tokens[0] in fixed_vals:
                        return float(fixed_vals[tokens[0]])
                    raise PetabError(
                        f"{oid}: noiseParameters {tokens[0]!r} must be "
                        "numeric or a non-estimated parameter id")
            if tokens:
                raise PetabError(
                    f"{oid}: noiseFormula has no placeholders but "
                    f"{len(tokens)} noiseParameters were given")
            val = meta["noise_expr"]
        else:
            if len(tokens) != meta["n_np"]:
                raise PetabError(
                    f"{oid}: noiseParameters has {len(tokens)} values "
                    f"for {meta['n_np']} placeholder(s)")
            sub = {}
            for k, tok in enumerate(tokens, 1):
                try:
                    v = float(tok)
                except ValueError:
                    if tok in fixed_vals:
                        v = float(fixed_vals[tok])
                    elif tok in estimated:
                        raise PetabError(
                            f"{oid}: estimated noise parameter {tok!r} "
                            "is not supported")
                    else:
                        raise PetabError(
                            f"{oid}: noiseParameters token {tok!r} is "
                            "neither numeric nor a non-estimated "
                            "parameter id")
                sub[sp.Symbol(f"noiseParameter{k}_{oid}")] = v
            val = meta["noise_expr"].subs(sub)
        try:
            return float(val)
        except TypeError:
            raise PetabError(
                f"{oid}: noiseFormula {val} does not reduce to a number")

    def _transform_value(oid: str, v: float) -> float:
        tr = obs_meta[oid]["transform"]
        if tr == "lin":
            return v
        if v <= 0:
            raise PetabError(
                f"{oid}: measurement {v} <= 0 under a {tr} "
                "observableTransformation")
        return math.log(v) if tr == "log" else math.log10(v)

    for row in meas_rows:
        oid = _get(row, "observableId")
        cid = _get(row, "simulationConditionId")
        if oid not in obs_meta:
            raise PetabError(f"measurement references unknown "
                             f"observable {oid!r}")
        if cid not in conditions:
            raise PetabError(f"measurement references unknown "
                             f"condition {cid!r}")
        pre = _get(row, "preequilibrationConditionId")
        if pre is not None and pre not in conditions:
            raise PetabError(f"unknown preequilibration condition {pre!r}")
        if cid not in used_conditions:
            used_conditions.append(cid)
            preeq_of[cid] = pre
        elif preeq_of[cid] != pre:
            raise PetabError(
                f"condition {cid!r} has measurements with different "
                "preequilibration conditions")
        t = float(_get(row, "time"))
        op_str = str(_get(row, "observableParameters", "") or "")
        np_str = str(_get(row, "noiseParameters", "") or "")
        o_idx = _expand_obs(oid, op_str)
        sigma = _row_sigma(oid, np_str)
        key = (cid, o_idx, math.isinf(t))
        rec = series.setdefault(key, {"t": [], "v": [], "s": []})
        rec["t"].append(t)
        rec["v"].append(_transform_value(oid, float(_get(row,
                                                         "measurement"))))
        rec["s"].append(float(sigma))

    # install the EXPANDED observables on the (possibly augmented) model
    obs_fn = _lambdify((state_syms, param_syms), exp_obs_exprs)
    n_st, n_par = len(state_syms), len(param_syms)

    def observables(y, p):
        cols = obs_fn([y[:, i] for i in range(n_st)],
                      [p[:, j] for j in range(n_par)])
        return _stack(cols, y[:, 0]).to(y.dtype)

    model = dataclasses.replace(model, observables=observables,
                                n_obs=len(exp_obs_exprs))

    experiments = []
    for cid in used_conditions:
        meas = []
        for (c, o_idx, is_ss), rec in series.items():
            if c != cid:
                continue
            order = np.argsort(rec["t"], kind="stable")
            times = np.asarray(rec["t"])[order]
            if is_ss:
                times = np.zeros_like(times)
            meas.append(Measurement(
                obs_index=o_idx, times=times,
                values=np.asarray(rec["v"])[order],
                sigmas=np.asarray(rec["s"])[order],
                steady_state=bool(is_ss)))
        pre = preeq_of[cid]
        if pre is not None and cond_species.get(pre):
            raise PetabError(
                f"preequilibration condition {pre!r} carries species "
                "overrides (unsupported: the pre-equilibration solve "
                "starts from the model y0)")
        experiments.append(Experiment(
            cid, tuple(meas), preequilibrate=pre is not None,
            preeq_params=dict(conditions[pre]) if pre else {},
            y0_overrides=dict(cond_species.get(cid, {}))))
    if not experiments:
        raise PetabError("no measurements")

    # ---- parameter map -----------------------------------------------------
    E = len(used_conditions)
    fixed_map: Dict[str, list] = {}
    for name in pnames_aug:
        if name in estimated:
            continue
        per_exp = []
        for cid in used_conditions:
            if name in conditions[cid]:
                per_exp.append(conditions[cid][name])
            elif name in fixed_vals:
                per_exp.append(fixed_vals[name])
            elif name in sbml_defaults:
                per_exp.append(float(sbml_defaults[name]))
            else:  # pragma: no cover - sbml always supplies a value
                raise PetabError(f"no value for fixed parameter {name!r}")
        fixed_map[name] = per_exp

    pmap = ParameterMap.create(pnames_aug, E, shared=tuple(estimated),
                               fixed=fixed_map, device=dev)
    batch = ExperimentBatch.from_experiments(experiments,
                                             param_names=pnames_aug,
                                             state_names=state_names,
                                             device=dev)

    priors = None
    if prior_spec:
        priors = Priors.create(pmap, batch, params=prior_spec, device=dev)

    project = Project(model=model, pmap=pmap, batch=batch,
                      config=config or SolverConfig(), priors=priors)
    return PetabProblem(
        model=model, batch=batch, pmap=pmap, priors=priors,
        project=project, theta0=np.asarray(theta0), lb=np.asarray(lb),
        ub=np.asarray(ub), x_ids=tuple(estimated),
        obs_labels=tuple(exp_obs_label))
