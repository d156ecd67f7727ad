"""Frozen solver and fit configurations, field for field with
``tpusysbio/config.py``.

Same names, defaults and ``__post_init__`` checks as the reference's
``SolverConfig``, ``FitConfig``, ``MeshConfig`` and ``RunSpec``, so a
configuration means the same thing in both packages.
``linear_solver='pallas'`` keeps its name: in the port it selects the
hand-written CUDA kernels of ``linalg/gpu_lu.py``.

``load_config`` reads the canonical run files (``configs/*.yaml``) and JSON.
YAML goes through the small reader ``parse_yaml`` below, which covers the
subset those files and PEtab v1 problem files use, so the port needs no
YAML package.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional, Tuple


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
    # 'lu' | 'inv' | 'inv32' | 'pallas' (CUDA kernels) | 'banded' (LU in
    # diagonal-packed storage, linalg/banded.py)
    linear_solver: str = "inv"
    # (kl, ku) bandwidth of the state Jacobian, for linear_solver='banded'
    jac_bandwidth: tuple = None
    # Dense-output interpolation correction in f32 on top of the exact
    # D[0] anchor.
    dense_f32: bool = False
    # Dense-output windowing (0 = off): the BDF stepper interpolates only
    # a window of the t_eval grid per step and caps the step to keep it.
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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout for multi-start parallelism: the one axis ``starts``
    splits the members across cards. ``axis_sizes=None`` means every local
    device. The port runs on one card; a layout of more than one device
    raises where it is used (``cli.py``)."""

    axis_names: Tuple[str, ...] = ("starts",)
    axis_sizes: Optional[Tuple[int, ...]] = None  # None -> all local devices


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One declarative fit run: model + solver/fit configs + run settings.

    ``run`` holds the run-level knobs (starts, top_k, iteration splits,
    data synthesis settings) — plain values, validated by the consumer.
    """

    model: str
    solver: SolverConfig = SolverConfig()
    screen_solver: Optional[SolverConfig] = None
    fit: FitConfig = FitConfig()
    screen_fit: Optional[FitConfig] = None
    mesh: Optional[MeshConfig] = None
    run: dict = dataclasses.field(default_factory=dict)


def _build(cls, d: dict):
    """Construct a frozen config dataclass from a mapping, rejecting
    unknown keys (a typo in a file must fail loudly, not fall back to a
    default) and coercing list-valued fields to tuples (the dataclasses
    stay hashable)."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys: {sorted(unknown)}; "
            f"valid keys: {sorted(names)}")
    coerced = {k: tuple(v) if isinstance(v, list) else v
               for k, v in d.items()}
    return cls(**coerced)


# --------------------------------------------------------------------------
# A YAML reader for the run files' subset
# --------------------------------------------------------------------------

# A plain scalar of the subset: an int, a float with a dot (YAML 1.1, as
# ``yaml.safe_load`` reads it: ``1.0e-6`` is a float, ``1e-6`` a string),
# true/false/null, or a word: a letter or ``_`` and then letters, digits
# and ``_ . - /`` (file names such as ``model.xml``). Words that YAML 1.1
# would read as something else (yes, on, .inf, quoted text, ...) are
# outside the subset.
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*$")
_CONSTANTS = {"true": True, "false": False, "null": None, "~": None}
_YAML11_WORDS = {"y", "n", "yes", "no", "on", "off", "true", "false", "null"}


def _scalar(text: str):
    text = text.strip()
    if text in _CONSTANTS:
        return _CONSTANTS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _WORD.match(text) and text.lower() not in _YAML11_WORDS:
        return text
    raise ValueError(f"YAML scalar outside the supported subset: {text!r}")


def _flow(text: str, lists_only: bool = False):
    """A scalar, a flow list ``[a, b]`` of scalars, or a flow mapping
    ``{k: v}`` whose values are scalars or such lists."""
    text = text.strip()
    if not text.startswith(("[", "{")):
        return _scalar(text)
    close = "]" if text[0] == "[" else "}"
    inner = text[1:-1]
    nested = "[]{}" if close == "]" else "{}"
    if (text[-1] != close or any(c in inner for c in nested)
            or (lists_only and close == "}")):
        raise ValueError(f"flow collection outside the supported subset: "
                         f"{text!r}")
    if close == "]":
        return [_scalar(s) for s in inner.split(",")] if inner.strip() else []
    out = {}
    # the commas outside a list
    for item in re.split(r",(?![^\[]*\])", inner) if inner.strip() else []:
        key, sep, val = item.partition(": ")
        if not sep or _scalar(key) in out:
            raise ValueError(f"flow mapping entry {item!r} in {text!r}")
        out[_scalar(key)] = _flow(val, lists_only=True)
    return out


def _entry(line: str, n: int, raw: str):
    """``key: value`` of one line; ``value`` is the raw text after the
    colon."""
    key, sep, val = line.partition(":")
    if not sep or (val and not val.startswith(" ")):
        raise ValueError(f"line {n}: expected 'key: value': {raw!r}")
    return _scalar(key), val


def parse_yaml(text: str) -> dict:
    """Parse the YAML subset of ``configs/*.yaml`` and of PEtab v1 problem
    files: ``#`` comments, a mapping whose values are scalars, one-level
    flow lists or mappings of scalars, sections of ``key: value`` lines
    one level deeper, or block lists (``- key: value`` items) of one-level
    mappings whose values are scalars or flow lists of scalars. Anything
    else (lists of scalars, deeper nesting, anchors, quotes, multi-line
    scalars) raises ``ValueError``. Equal to ``yaml.safe_load`` on that
    subset."""
    root: dict = {}
    # the open section: [indent or None until its first line, key, kind]
    # with kind 'map' or 'list'; item: [key indent, mapping] of the open
    # list item
    section = None
    item = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = re.sub(r"(^|\s)#.*", "", raw).rstrip()
        if not line:
            continue
        if "\t" in line:
            raise ValueError(f"line {n}: a tab is outside the supported "
                             "subset")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body == "-" or body.startswith("- "):
            if section is None or section[0] not in (None, indent) or (
                    section[0] is not None and section[2] != "list"):
                raise ValueError(f"line {n}: a block list outside a "
                                 "top-level key's value")
            if section[0] is None:
                section[0], section[2] = indent, "list"
                root[section[1]] = []
            rest = body[1:]
            pad = len(rest) - len(rest.lstrip(" "))
            key, val = _entry(rest.strip(), n, raw)
            if not val.strip():
                raise ValueError(f"line {n}: a list item must be a "
                                 "one-level mapping of scalars and lists")
            item = [indent + 1 + pad, {key: _flow(val, lists_only=True)}]
            root[section[1]].append(item[1])
            continue
        key, val = _entry(body, n, raw)
        if indent == 0:
            if key in root:
                raise ValueError(f"line {n}: duplicate key {key!r}")
            root[key] = _flow(val) if val.strip() else None
            section = None if val.strip() else [None, key, None]
            item = None
            continue
        if section is None:
            raise ValueError(f"line {n}: indented line outside a section")
        if section[2] == "list":
            if item is None or indent != item[0] or not val.strip():
                raise ValueError(f"line {n}: a list item must be a "
                                 "one-level mapping of scalars and lists")
            if key in item[1]:
                raise ValueError(f"line {n}: duplicate key {key!r}")
            item[1][key] = _flow(val, lists_only=True)
            continue
        if section[0] is None:
            section[0], section[2] = indent, "map"
            root[section[1]] = {}
        if indent != section[0] or not val.strip():
            raise ValueError(f"line {n}: nesting deeper than one level is "
                             "outside the supported subset")
        if key in root[section[1]]:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        root[section[1]][key] = _flow(val)
    return root


def load_config(source) -> RunSpec:
    """Load a ``RunSpec`` from a YAML/JSON file path or an already-parsed
    mapping.

    File format (sections all optional except ``model``)::

        model: mapk22
        solver:        {rtol: 1.0e-6, linear_solver: pallas}
        screen_solver: {rtol: 1.0e-3, mixed_precision: true}
        fit:           {max_iter: 20, eval_mode: lockstep}
        screen_fit:    {max_iter: 8, ftol: 1.0e-4}
        mesh:          {axis_names: [starts]}
        run:           {starts: 1024, top_k: 64, seed: 0}

    ``.yaml``/``.yml`` files go through :func:`parse_yaml`, anything else
    through ``json``.
    """
    if isinstance(source, dict):
        raw = dict(source)
    else:
        path = str(source)
        with open(path) as fh:
            text = fh.read()
        if path.endswith((".yaml", ".yml")):
            raw = parse_yaml(text)
        else:
            raw = json.loads(text)
    if not isinstance(raw, dict):
        raise ValueError(f"config must be a mapping, got {type(raw)}")
    known = {"model", "solver", "screen_solver", "fit", "screen_fit",
             "mesh", "run"}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown config sections: {sorted(unknown)}; "
                         f"valid: {sorted(known)}")
    if "model" not in raw:
        raise ValueError("config requires a 'model' entry")

    def section(key, cls):
        if key not in raw or raw[key] is None:
            return None
        return _build(cls, dict(raw[key]))

    return RunSpec(
        model=str(raw["model"]),
        solver=section("solver", SolverConfig) or SolverConfig(),
        screen_solver=section("screen_solver", SolverConfig),
        fit=section("fit", FitConfig) or FitConfig(),
        screen_fit=section("screen_fit", FitConfig),
        mesh=section("mesh", MeshConfig),
        run=dict(raw.get("run") or {}))
