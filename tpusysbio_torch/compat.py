"""SciPy-style facades over the port, after ``tpusysbio/compat.py``.

``solve_ivp``, ``odeint``, ``leastsq`` and ``least_squares`` with SciPy's
signatures (``scipy/integrate/_ivp/ivp.py:161``,
``scipy/integrate/_odepack_py.py:252``, ``scipy/optimize/_minpack_py.py:292``,
``scipy/optimize/_lsq/least_squares.py:267``) plus ``device=`` (the card by
default; ``device="cpu"`` for the CPU), so a SciPy call site switches by
changing its import. Results are numpy, as SciPy's.

User callables are unbatched torch functions: ``fun(t, y)`` gets ``t`` a
0-d tensor and ``y`` (n,) and returns (n,) (a tensor, or a list of 0-d
tensors and numbers); a residual function gets θ (G,) and returns (R,).
They run as a batch of one for the port's batched steppers, ``EventSpec``
and ``lm_fit``/``trf_fit``; Jacobians they do not supply come from
``torch.func`` forward-mode AD (so ``torch.tensor([...])`` of computed
values, which cuts the graph, must be ``torch.stack``).

Where the reference differs from SciPy, the port behaves as SciPy does:

- ``solve_ivp`` with a terminal event stops its output at the event: with
  ``t_eval=None`` the accepted-step grid ends at ``t_event`` with the
  state there, and ``t_eval`` points past the event are dropped;
- ``odeint`` with a ``t`` that is not monotonic raises ``ValueError``;
- ``least_squares(method='lm')`` with a robust ``loss`` raises
  ``ValueError``.

Static-shape notes as in the reference: ``t_eval=None`` and
``dense_output=True`` need the BDF dense-export channel
(``method='BDF'``); each event function records at most ``max_events``
occurrences.
"""

from __future__ import annotations

import types
from typing import Callable, Optional

import numpy as np
import torch

from tpusysbio_torch import resolve_device, solvers
from tpusysbio_torch.config import FitConfig, SolverConfig
from tpusysbio_torch.optim import lm_fit, trf_fit
from tpusysbio_torch.solvers import (STATUS_DONE, STATUS_EVENT, EventSpec,
                                     OdeSolution)

__all__ = ["solve_ivp", "odeint", "leastsq", "least_squares"]

_METHODS = {
    # scipy name -> solver key
    "BDF": "bdf",
    "LSODA": "auto",
    "Radau": "radau",
    "RK45": "dopri5",
    "DOP853": "dopri5",   # same family: an order-5 core, not 8
    "Rosenbrock": "rosenbrock",  # extension (not a scipy method name)
    "Adams": "adams",            # extension
}

_STATUS_MSG = {
    0: "The solver successfully reached the end of the integration interval.",
    1: "A termination event occurred.",
    -1: "Integration step failed.",
}


def _vector(out, like: torch.Tensor) -> torch.Tensor:
    """A user function's value as a 1-D tensor in ``like``'s dtype."""
    if isinstance(out, torch.Tensor):
        return out.to(like.dtype).reshape(-1)
    return torch.stack([torch.as_tensor(v, dtype=like.dtype,
                                        device=like.device).reshape(())
                        for v in out])


def _batched(fun: Callable, sign: float) -> Callable:
    """``fun(t, y)`` as the steppers' ``f(t (1,), y (1, n)) -> (1, n)``,
    time-reflected (τ = −t) when ``sign`` is −1."""
    def f(t, y):
        return sign * _vector(fun(sign * t[0], y[0]), y)[None]
    return f


def solve_ivp(fun: Callable, t_span, y0, method: str = "RK45",
              t_eval=None, dense_output: bool = False,
              events=None, args=None,
              rtol: float = 1e-3, atol: float = 1e-6,
              first_step: Optional[float] = None,
              max_step: float = float("inf"),
              jac: Optional[Callable] = None,
              max_steps: int = 4096, max_events: int = 8, device="cuda"):
    """``scipy.integrate.solve_ivp`` facade.

    Differences from SciPy, all static-shape consequences: ``t_eval=None``
    and ``dense_output=True`` need ``method='BDF'``; events need
    ``method='BDF'`` and record at most ``max_events`` occurrences each;
    a decreasing ``t_span`` integrates by time reflection."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; "
                         f"one of {sorted(_METHODS)}")
    key = _METHODS[method]
    dev = resolve_device(device)
    t0, t1 = float(t_span[0]), float(t_span[1])
    sign = 1.0 if t1 >= t0 else -1.0
    if args:
        base = fun
        fun = lambda t, y: base(t, y, *args)  # noqa: E731
    y0 = torch.as_tensor(np.asarray(y0, np.float64), device=dev)[None]
    f = _batched(fun, sign)
    span = (t0 * sign, t1 * sign)
    jac_f = None
    if jac is not None:
        def jac_f(t, y):
            J = torch.as_tensor(jac(sign * t[0], y[0]), dtype=y.dtype,
                                device=y.device)
            return sign * J[None]

    needs_dense = t_eval is None or dense_output
    if needs_dense and key != "bdf":
        raise ValueError(
            "t_eval=None / dense_output=True need the dense-export "
            "channel — use method='BDF'")
    te_np = (np.asarray([t1]) if t_eval is None
             else np.asarray(t_eval, np.float64))
    te = torch.as_tensor(te_np * sign, device=dev)

    ev_spec = None
    if events is not None:
        ev_list = list(events) if isinstance(events, (list, tuple)) \
            else [events]
        ev_fns = ([lambda t, y, _e=e: _e(t, y, *args) for e in ev_list]
                  if args else list(ev_list))

        def ev_vec(t, y):
            return torch.stack([
                torch.as_tensor(e(sign * t[0], y[0]), dtype=y.dtype,
                                device=y.device).reshape(())
                for e in ev_fns])[None]

        ev_spec = EventSpec(
            fn=ev_vec,
            direction=tuple(float(getattr(e, "direction", 0.0))
                            for e in ev_list),
            terminal=tuple(bool(getattr(e, "terminal", False))
                           for e in ev_list),
            capacity=max_events)
        if key != "bdf":
            raise ValueError("events need method='BDF'")

    cfg = SolverConfig(rtol=float(rtol), atol=float(atol),
                       max_steps=int(max_steps),
                       first_step=first_step, max_step=float(max_step))
    # explicit methods take no Jacobian (scipy ignores it there too)
    kwargs = ({"jac": jac_f} if jac_f is not None
              and key in ("bdf", "radau", "auto", "rosenbrock") else {})
    if key == "bdf":
        res = solvers.bdf_solve(f, span, y0, te, config=cfg,
                                events=ev_spec, dense_export=needs_dense,
                                **kwargs)
    else:
        res = solvers.SOLVERS[key](f, span, y0, te, config=cfg, **kwargs)

    st = int(res.status[0])
    status = 0 if st == STATUS_DONE else (1 if st == STATUS_EVENT else -1)
    # where the member stopped, in the reflected (forward) time
    t_stop = float(res.t_final[0])
    sol = None
    ts_out = te_np
    ys_out = res.ys[0].cpu().numpy()
    if t_eval is not None and status == 1:
        keep = te_np * sign <= t_stop
        ts_out, ys_out = ts_out[keep], ys_out[keep]
    if needs_dense:
        dsol = OdeSolution(res)
        if t_eval is None:
            # scipy convention: t = [t0, every accepted step's end time],
            # ending at the event time when a terminal event stopped it
            steps = dsol.ts[0, :int(dsol.nacc[0])].cpu().numpy()
            if status == 1:
                steps = np.append(steps[steps < t_stop], t_stop)
            grid = np.concatenate([[t0 * sign], steps])
            ys_out = dsol(torch.as_tensor(grid, device=dev))[0].cpu().numpy()
            ts_out = grid * sign
        if dense_output:
            def sol(t):
                tt = torch.as_tensor(np.asarray(t, np.float64) * sign,
                                     device=dev)
                return dsol(tt)[0].cpu().numpy()

    t_events = y_events = None
    if ev_spec is not None:
        t_events, y_events = [], []
        cnt = res.event_count[0].cpu().numpy()
        et = res.event_t[0].cpu().numpy()
        ey = res.event_y[0].cpu().numpy()
        for i in range(len(ev_spec.direction)):
            k = int(min(cnt[i], et.shape[1]))
            t_events.append(et[i, :k] * sign)
            y_events.append(ey[i, :k])

    return types.SimpleNamespace(
        t=ts_out, y=ys_out.T, sol=sol,
        t_events=t_events, y_events=y_events,
        nfev=int(res.nfev[0]), njev=int(res.njev[0]), nlu=int(res.nlu[0]),
        status=status, success=status >= 0,
        message=_STATUS_MSG[status])


def odeint(func: Callable, y0, t, args=(), Dfun: Optional[Callable] = None,
           full_output: bool = False, rtol: Optional[float] = None,
           atol: Optional[float] = None, tfirst: bool = False,
           mxstep: int = 0, device="cuda"):
    """``scipy.integrate.odeint`` facade (the LSODA role: ``auto``).

    ``func(y, t, *args)`` (``tfirst=False``, odeint's convention). ``t[0]``
    is the initial time; ``t`` must be monotonic (increasing or
    decreasing; repeated values are allowed), else ``ValueError`` as in
    SciPy. Defaults match odeint's ``rtol = atol = 1.49012e-8``.
    """
    dev = resolve_device(device)
    t = np.asarray(t, np.float64)
    if t.ndim != 1 or t.size < 1:
        raise ValueError("t must be a 1-D array of at least one time")
    dt = np.diff(t)
    if not ((dt >= 0).all() or (dt <= 0).all()):
        raise ValueError("The values in t must be monotonically increasing "
                         "or monotonically decreasing; repeated values are "
                         "allowed.")
    rtol = 1.49012e-8 if rtol is None else float(rtol)
    atol = 1.49012e-8 if atol is None else float(atol)
    if tfirst:
        def f(tt, y):
            return func(tt, y, *args)

        jac = None if Dfun is None else (lambda tt, y: Dfun(tt, y, *args))
    else:
        def f(tt, y):
            return func(y, tt, *args)

        jac = None if Dfun is None else (lambda tt, y: Dfun(y, tt, *args))

    t0, tf = float(t[0]), float(t[-1])
    y0_np = np.asarray(y0, np.float64)
    if t.size == 1 or tf == t0:
        ys = np.broadcast_to(y0_np, (t.size, y0_np.shape[0])).copy()
        return (ys, {"nst": 0, "nfe": 0, "nje": 0,
                     "message": "Integration successful."}) \
            if full_output else ys
    sign = 1.0 if tf >= t0 else -1.0
    g = _batched(f, sign)
    kwargs = {}
    if jac is not None:
        def jg(tt, y):
            J = torch.as_tensor(jac(sign * tt[0], y[0]), dtype=y.dtype,
                                device=y.device)
            return sign * J[None]

        kwargs["jac"] = jg
    cfg = SolverConfig(rtol=rtol, atol=atol,
                       max_steps=int(mxstep) if mxstep else 4096)
    te = torch.as_tensor(t * sign, device=dev)
    res = solvers.auto_solve(g, (t0 * sign, tf * sign),
                             torch.as_tensor(y0_np, device=dev)[None], te,
                             config=cfg, **kwargs)
    ys = res.ys[0].cpu().numpy()
    if not full_output:
        return ys
    st = int(res.status[0])
    info = {
        "nst": int(res.nsteps[0]), "nfe": int(res.nfev[0]),
        "nje": int(res.njev[0]),
        "message": ("Integration successful." if st == STATUS_DONE
                    else f"solver status {st}"),
    }
    return ys, info


def _wrap_residuals(func, x0, args, Dfun, dev):
    """θ (G,) functions as the optimizers' batches of one: ``r_fn(θ (1, G))
    -> (1, R)`` and ``rj_fn -> ((1, R), (1, R, G))``."""
    x0 = torch.as_tensor(np.asarray(x0, np.float64), device=dev)

    def one(th):
        out = func(th, *args) if args else func(th)
        return _vector(out, th)

    def r_fn(theta):
        return one(theta[0])[None]

    if Dfun is not None:
        def jac_one(th):
            J = Dfun(th, *args) if args else Dfun(th)
            J = torch.as_tensor(J, dtype=th.dtype, device=th.device)
            return J.reshape(-1, th.shape[0])
    else:
        jac_one = torch.func.jacfwd(one)

    def rj_fn(theta):
        return r_fn(theta), jac_one(theta[0])[None]

    return x0, r_fn, rj_fn


def leastsq(func: Callable, x0, args=(), Dfun: Optional[Callable] = None,
            full_output: bool = False, ftol: float = 1.49012e-8,
            xtol: float = 1.49012e-8, gtol: float = 0.0,
            maxfev: int = 0, device="cuda"):
    """``scipy.optimize.leastsq`` facade (MINPACK's lmdif/lmder role):
    Levenberg–Marquardt; with no ``Dfun`` the Jacobian is forward-mode AD
    rather than MINPACK's finite differences."""
    dev = resolve_device(device)
    x0, r_fn, rj_fn = _wrap_residuals(func, x0, args, Dfun, dev)
    n = int(x0.shape[0])
    max_iter = int(maxfev) if maxfev else 100 * (n + 1)
    cfg = FitConfig(ftol=float(ftol), xtol=float(xtol),
                    gtol=float(gtol) if gtol else 1e-14,
                    max_iter=max_iter)
    fit = lm_fit(r_fn, rj_fn, x0[None], cfg)
    status = int(fit.status[0])
    # MINPACK ier: 1-4 are success flavours, 5 = exceeded maxfev
    ier = {1: 4, 2: 1, 3: 2}.get(status, 5)
    x = fit.theta[0].cpu().numpy()
    if not full_output:
        return x, ier
    infodict = {
        "fvec": r_fn(fit.theta)[0].cpu().numpy(),
        "nfev": int(fit.nfev[0]) + int(fit.njev[0]),
        "njev": int(fit.njev[0]),
    }
    mesg = ("Both actual and predicted relative reductions in the sum "
            "of squares are at most ftol." if ier in (1, 2, 3, 4)
            else "Number of iterations has reached max_iter.")
    cov_x = None if fit.cov is None else fit.cov[0].cpu().numpy()
    return x, cov_x, infodict, mesg, ier


def least_squares(fun: Callable, x0, jac=None, bounds=(-np.inf, np.inf),
                  method: str = "trf", ftol: float = 1e-8,
                  xtol: float = 1e-8, gtol: float = 1e-8,
                  loss: str = "linear", f_scale: float = 1.0,
                  max_nfev: Optional[int] = None, args=(),
                  tr_solver: Optional[str] = None, device="cuda"):
    """``scipy.optimize.least_squares`` facade. ``jac`` is a callable or
    None (forward-mode AD); the finite-difference strings raise.
    ``method='trf'`` (bounds, robust losses) and ``method='lm'``
    (unbounded, linear loss only, as in SciPy); ``tr_solver='svd'``
    selects the SVD trust-region subproblem."""
    if isinstance(jac, str):
        raise ValueError(
            "finite-difference jac strings are not supported: the "
            "Jacobian is exact forward-mode autodiff when jac=None")
    if method not in ("trf", "lm"):
        raise ValueError(f"method {method!r} not supported (trf | lm)")
    if method == "lm" and loss != "linear":
        raise ValueError("method='lm' supports only 'linear' loss function.")
    dev = resolve_device(device)
    x0, r_fn, rj_fn = _wrap_residuals(fun, x0, args, jac, dev)
    n = int(x0.shape[0])
    cfg = FitConfig(ftol=float(ftol), xtol=float(xtol), gtol=float(gtol),
                    max_iter=int(max_nfev) if max_nfev else 100 * n)

    lb = np.broadcast_to(np.asarray(bounds[0], np.float64), (n,))
    ub = np.broadcast_to(np.asarray(bounds[1], np.float64), (n,))
    unbounded = bool(np.all(np.isinf(lb)) and np.all(np.isinf(ub)))

    if method == "lm" or (unbounded and loss == "linear"):
        if not unbounded:
            raise ValueError("method='lm' supports no bounds")
        fit = lm_fit(r_fn, rj_fn, x0[None], cfg)
    else:
        sub = "svd" if tr_solver == "svd" else "normal"
        fit = trf_fit(r_fn, rj_fn, x0[None],
                      torch.as_tensor(lb.copy(), device=dev),
                      torch.as_tensor(ub.copy(), device=dev), cfg,
                      subproblem=sub, loss=loss, f_scale=float(f_scale))

    r_t, J_t = rj_fn(fit.theta)
    x = fit.theta[0].cpu().numpy()
    r = r_t[0].cpu().numpy()
    J = J_t[0].cpu().numpy()
    g = J.T @ r
    active = np.zeros(n, int)
    if not unbounded:
        active[np.isclose(x, lb)] = -1
        active[np.isclose(x, ub)] = 1
    status = int(fit.status[0])
    msgs = {1: "`gtol` termination condition is satisfied.",
            2: "`ftol` termination condition is satisfied.",
            3: "`xtol` termination condition is satisfied.",
            0: "The maximum number of iterations is exceeded."}
    return types.SimpleNamespace(
        x=x, cost=float(fit.cost[0]), fun=r, jac=J, grad=g,
        optimality=float(np.max(np.abs(g))), active_mask=active,
        nfev=int(fit.nfev[0]) + int(fit.njev[0]), njev=int(fit.njev[0]),
        status=status, success=status > 0,
        message=msgs.get(status, f"status {status}"))
