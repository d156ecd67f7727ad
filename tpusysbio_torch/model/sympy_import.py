"""SymPy → batched PyTorch model import, port of
``tpusysbio/model/sympy_import.py``.

Symbolic right-hand sides lambdify into torch functions
(``sympy.lambdify(..., modules="torch")``); the Jacobian and the
sensitivities come from forward-mode AD (``solvers.common.
batched_jacobian``, ``sens/forward.py``), so there is no code generation
step. SBML import (``sbml_import.py``) lands here.

The generated functions take every state and parameter as a column
``y[:, i]``/``p[:, j]`` of the batch, and ``t`` (B,). They are lambdified
with common-subexpression elimination (``cse=True``): a mass-action rate
that enters several species' equations is computed once, which cuts the
kernel launches of one RHS call on the card. SymPy's torch printer
emits calls such as ``torch.min(2, k)``, ``torch.log(10)`` or
``torch.where(c, 1, 0)`` that torch refuses for Python numbers, so the
namespace below wraps those names: a call on numbers alone computes with
``math``, a call that mixes numbers with tensors lifts the numbers to the
tensors' dtype and device. An output that is a plain number (an ODE that
is ``0``, a constant observable) is broadcast to (B,); every output takes
the dtype the reference's ``jnp.stack`` would give (the promotion of the
outputs with the state's dtype). Everything runs under ``torch.func.jvp``
and ``torch.func.vmap``.

Example::

    import sympy as sp
    S, C, P = sp.symbols("S C P")
    k1, km1, k2, E0 = sp.symbols("k1 km1 k2 E0")
    model = from_sympy(
        name="mm3", states=[S, C, P], params=[k1, km1, k2, E0],
        odes=[-k1*(E0-C)*S + km1*C, k1*(E0-C)*S - (km1+k2)*C, k2*C],
        y0=[1.0, 0.0, 0.0])
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from tpusysbio_torch.model.core import OdeModel


def _tensors(args):
    return [a for a in args if isinstance(a, torch.Tensor)]


def _lift(args):
    """The arguments with Python numbers as tensors like the first tensor
    argument (float64 where every tensor argument is boolean)."""
    ts = _tensors(args)
    like = ts[0]
    dtype = next((t.dtype for t in ts if t.is_floating_point()),
                 torch.float64)
    return [a if isinstance(a, torch.Tensor)
            else torch.as_tensor(a, dtype=dtype, device=like.device)
            for a in args]


def _unary(torch_fn, math_fn):
    def fn(x):
        if isinstance(x, torch.Tensor):
            return torch_fn(x)
        return math_fn(x)
    return fn


def _binary(torch_fn, py_fn):
    def fn(a, b):
        if not _tensors((a, b)):
            return py_fn(a, b)
        return torch_fn(*_lift((a, b)))
    return fn


def _where(cond, a, b):
    if not isinstance(cond, torch.Tensor):
        return a if cond else b
    if not _tensors((a, b)):
        # two numbers: f32 when both are exact in f32 (0, 1, 0.5, ...), so
        # that they do not promote an f32 state to f64 (the reference's
        # numbers are weakly typed), else f64
        exact = all(float(np.float32(v)) == float(v) for v in (a, b))
        dtype = torch.float32 if exact else torch.float64
        a, b = (torch.as_tensor(v, dtype=dtype, device=cond.device)
                for v in (a, b))
    else:
        a, b = _lift((a, b))
    return torch.where(cond, a, b)


# the names SymPy's torch printer emits for the functions that SBML's
# MathML has (``sbml_import._MathML``); any other name resolves to torch
_NAMESPACE = {
    "where": _where,
    "min": _binary(torch.minimum, min),
    "max": _binary(torch.maximum, max),
    "pow": _binary(torch.pow, pow),
    "eq": _binary(torch.eq, lambda a, b: a == b),
    "ne": _binary(torch.ne, lambda a, b: a != b),
    "gt": _binary(torch.gt, lambda a, b: a > b),
    "lt": _binary(torch.lt, lambda a, b: a < b),
    "ge": _binary(torch.ge, lambda a, b: a >= b),
    "le": _binary(torch.le, lambda a, b: a <= b),
    "logical_and": _binary(torch.logical_and, lambda a, b: a and b),
    "logical_or": _binary(torch.logical_or, lambda a, b: a or b),
    "logical_not": _unary(torch.logical_not, lambda a: not a),
    "abs": _unary(torch.abs, abs),
    "ceil": _unary(torch.ceil, math.ceil),
    "floor": _unary(torch.floor, math.floor),
    **{name: _unary(getattr(torch, name), getattr(math, name))
       for name in ("log", "exp", "sqrt", "cos", "acos", "sin", "asin",
                    "tan", "atan", "cosh", "sinh", "tanh")},
}


def _lambdify(args, exprs):
    import sympy as sp

    return sp.lambdify(args, exprs, modules=[_NAMESPACE, "torch"], cse=True)


def _stack(outs, like: torch.Tensor) -> torch.Tensor:
    """Stack lambdified outputs (tensors or numbers) to (B, k) with the
    reference's dtype promotion; ``like`` is a (B,) column."""
    dtype = like.dtype
    for v in _tensors(outs):
        dtype = torch.promote_types(dtype, v.dtype)
    cols = []
    for v in outs:
        if isinstance(v, torch.Tensor):
            v = v.to(dtype)
            if v.shape != like.shape:
                v = v.expand_as(like)
        else:
            v = torch.full_like(like, float(v), dtype=dtype)
        cols.append(v)
    return torch.stack(cols, dim=-1)


def from_sympy(name: str, states: Sequence, params: Sequence,
               odes: Sequence, y0, t=None,
               observables: Optional[Sequence] = None) -> OdeModel:
    """Build a batched ``OdeModel`` from SymPy expressions.

    Args:
      states/params: SymPy symbols, defining state/parameter order.
      odes: one expression per state (may reference ``t``).
      y0: initial condition — floats, or SymPy expressions in ``params``.
      observables: expressions in states+params; defaults to all states.
    """
    import sympy as sp

    states = list(states)
    params = list(params)
    odes = list(odes)
    if len(odes) != len(states):
        raise ValueError("need one ODE per state")
    t_sym = t if t is not None else sp.Symbol("t")
    n, m = len(states), len(params)

    rhs_fn = _lambdify((t_sym, states, params), odes)

    def rhs(tt, y, p):
        cols = rhs_fn(tt, [y[:, i] for i in range(n)],
                      [p[:, j] for j in range(m)])
        return _stack(cols, y[:, 0])

    y0_exprs = list(y0)
    if any(isinstance(v, sp.Basic) and v.free_symbols for v in y0_exprs):
        y0_fn = _lambdify((params,), y0_exprs)

        def y0_builder(p):
            cols = y0_fn([p[:, j] for j in range(m)])
            return _stack(cols, p[:, 0]).to(p.dtype)
    else:
        y0_const = np.asarray([float(v) for v in y0_exprs])

        def y0_builder(p):
            y = torch.as_tensor(y0_const, dtype=p.dtype, device=p.device)
            return y.expand(p.shape[0], n).clone()

    if observables is None:
        n_obs = n

        def obs(y, p):
            return y
    else:
        obs_exprs = list(observables)
        n_obs = len(obs_exprs)
        obs_fn = _lambdify((states, params), obs_exprs)

        def obs(y, p):
            cols = obs_fn([y[:, i] for i in range(n)],
                          [p[:, j] for j in range(m)])
            return _stack(cols, y[:, 0]).to(y.dtype)

    return OdeModel(
        name=name, n_states=n, n_params=m, n_obs=n_obs,
        rhs=rhs, y0=y0_builder, observables=obs,
        param_names=tuple(str(s) for s in params),
        state_names=tuple(str(s) for s in states))
