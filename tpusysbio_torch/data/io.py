"""Tidy-CSV experiment loading, the port's own copy of
``tpusysbio/data/io.py``.

Expected columns (header required; extra columns are ignored):

  experiment   experiment name (groups rows)
  observable   model observable — integer index, or a state name resolved
               against ``model.state_names``
  time         measurement time
  value        measured value
  sigma        measurement standard deviation (optional; default 1.0)
  scale_group  relative-data scale-factor group (optional; empty/absent
               ⇒ absolute data)
  steady_state optional truthy flag ('1'/'true') marking equilibrium rows

Rows sharing (experiment, observable, scale_group, steady_state) become
ONE ``Measurement``; experiments keep first-appearance order. Condition
settings (doses, timed inputs, pre-equilibration) come in through
``settings``. The records are host-side; ``ExperimentBatch.
from_experiments(..., device=)`` puts them on a device.
"""

from __future__ import annotations

import csv
import io as _io
import os
from typing import Dict, List, Optional

import numpy as np

from tpusysbio_torch.data.experiment import Experiment, Measurement

_TRUTHY = {"1", "true", "yes", "y"}


def _resolve_obs(token: str, model) -> int:
    token = token.strip()
    try:
        return int(token)
    except ValueError:
        pass
    if model is None:
        raise ValueError(
            f"observable {token!r} is not an index; pass model= to "
            "resolve names")
    names = list(getattr(model, "state_names", ()) or ())
    if token in names:
        return names.index(token)
    raise ValueError(f"observable {token!r} not in model.state_names "
                     f"{tuple(names)}")


def experiments_from_csv(source: str, model=None,
                         settings: Optional[Dict[str, dict]] = None,
                         ) -> List[Experiment]:
    """Load tidy CSV (path or literal text) into ``Experiment`` records.

    Args:
      source: file path, or the CSV text itself (detected by newline).
      model: optional ``OdeModel`` for observable-by-name resolution.
      settings: per-experiment constructor overrides, e.g.
        ``{"dose10": dict(fixed_params={"dose": 10.0}),
           "pulse": dict(inputs=((5.0, "stim", 1.0),))}``.

    Returns:
      Experiments in first-appearance order, each with its measurements
      merged per (observable, scale_group, steady_state) and sorted by
      time — ready for ``ExperimentBatch.from_experiments``.
    """
    if "\n" in source or "\r" in source:
        fh = _io.StringIO(source)
    else:
        if not os.path.exists(source):
            raise FileNotFoundError(source)
        fh = open(source, newline="")
    with fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames is None:
            raise ValueError("empty CSV")
        cols = {c.strip().lower(): c for c in reader.fieldnames}
        for required in ("experiment", "observable", "time", "value"):
            if required not in cols:
                raise ValueError(f"missing column {required!r} "
                                 f"(have {sorted(cols)})")

        # key -> {"t": [...], "v": [...], "s": [...]}
        series: Dict[tuple, dict] = {}
        exp_order: List[str] = []
        for row in reader:
            def get(name, default=None):
                c = cols.get(name)
                v = row.get(c) if c else None
                return default if v is None or v == "" else v

            exp = str(get("experiment"))
            if exp not in exp_order:
                exp_order.append(exp)
            obs = _resolve_obs(str(get("observable")), model)
            group = get("scale_group")
            is_ss = str(get("steady_state", "0")).strip().lower() in _TRUTHY
            key = (exp, obs, group, is_ss)
            rec = series.setdefault(key, {"t": [], "v": [], "s": []})
            rec["t"].append(float(get("time")))
            rec["v"].append(float(get("value")))
            rec["s"].append(float(get("sigma", 1.0)))

    settings = settings or {}
    out = []
    for exp in exp_order:
        meas = []
        for (e, obs, group, is_ss), rec in series.items():
            if e != exp:
                continue
            order = np.argsort(rec["t"], kind="stable")
            t = np.asarray(rec["t"])[order]
            if not is_ss and len(np.unique(t)) != len(t):
                raise ValueError(
                    f"duplicate times for experiment {exp!r} observable "
                    f"{obs} group {group!r}")
            meas.append(Measurement(
                obs_index=obs, times=t,
                values=np.asarray(rec["v"])[order],
                sigmas=np.asarray(rec["s"])[order],
                scale_group=group, steady_state=is_ss))
        out.append(Experiment(exp, tuple(meas), **settings.get(exp, {})))
    unknown = set(settings) - set(exp_order)
    if unknown:
        raise ValueError(f"settings for unknown experiments: {sorted(unknown)}")
    return out
