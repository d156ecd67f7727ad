"""Variable-order BDF/NDF stiff integrator over a batch of members.

Port of ``tpusysbio/solvers/bdf.py`` (itself SciPy's ``_ivp/bdf.py``
algorithm): NDF constants, the difference array ``D`` with the
``change_D``/``compute_R`` rescaling, modified Newton with a reused
factorization and SciPy's reuse quirks (``current_jac`` resets at each
fresh step; an error-test rejection keeps the stale factorization), order
adaptation from ``D[order±1]``, and the ``BdfDenseOutput`` interpolant
evaluated at every ``t_eval`` point after each accepted step.

Batching. The reference gets its ensemble from ``jax.vmap`` over a
``lax.while_loop`` whose body is one step ATTEMPT with branchless
``jnp.where`` merges. Here every quantity carries a leading member
dimension B, and the reference's batching semantics are written out:

- the step loop runs until no member is ``STATUS_RUNNING``; a member that
  is not running keeps its whole state (``torch.where(running, new,
  old)`` on every field), as a vmapped ``while_loop`` freezes its lanes;
- the Newton loop runs the batch union of trips, at most
  ``NEWTON_MAXITER``; a member whose own condition is false keeps its
  whole carry, its trip counter included;
- ``lax.cond(lu_valid, reuse, factor)`` becomes: factor the batch (when
  any running member needs it), then ``where(lu_valid, old, new)``;
- a fatal step-size underflow freezes the member with
  ``STATUS_TOO_SMALL_STEP``.

The column block is a tuple of PARTS with their own dtypes: with
``sens_precision='f32'`` the state column (error control, dense output)
stays f64 and the sensitivity columns live entirely in f32. With
``mixed_precision`` (the screening mode) the whole block is one f32 part:
RHS, Jacobian, factorization, solves, difference arrays and dense output
run in f32, while time, step size, the error norm's comparison and the
order logic stay f64.

Each member has its own interval and output grid: ``t_span`` ends may be
floats or (B,) tensors, ``t_eval`` is (T,) or (B, T). Each trip folds its
step's interpolant into the ``t_eval`` accumulator with :func:`dense_fold`:
on the card one launch of the hand-written kernel K5
(``linalg/csrc/dense_fold.cu``) writes only the points the step covers;
on the CPU its plain twin evaluates the grid and keeps those points. The
step controller after the Newton loop (error test, order and step choice,
the update of ``D``) is :func:`step_control`: on the card one launch of
K6 (``linalg/csrc/step_control.cu``), on the CPU its plain twin.

Channels beside ``t_eval``:

- ``events`` (``common.EventSpec``): sign changes of ``fn`` across each
  accepted step, roots bisected on the step's interpolant for the batch
  when any member fired, (B, E, capacity) buffers, and a terminal stop.
  The ``t_eval`` points of a terminal step are filled from the step's own
  polynomial up to the event time, and only then is the anchor row
  rewritten to the state at the event. The reference fills them after the
  rewrite, which shifts the polynomial and puts those points off by the
  size of the step's last correction; the port does not copy that.
- ``dense_export``: each accepted step's interpolant (``t_new``, ``h``,
  order, ``D[:MAX_ORDER+1]``) into (B, max_steps, ...) buffers for
  ``solvers.dense.OdeSolution``; the buffers are written in place.
- ``config.dense_window``: the step is capped at the (window-1)-th next
  ``t_eval`` point and the plain twin interpolates only that window of
  the grid.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpusysbio_torch import trace
from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.linalg import kernels, make_linear_solver
from tpusysbio_torch.solvers import common
from tpusysbio_torch.solvers.common import (
    STATUS_EVENT,
    STATUS_RUNNING,
    IntegrateResult,
    bcast,
    rms_norm,
    where_members,
)

MAX_ORDER = 5
NEWTON_MAXITER = 4
# Rows of the difference array: D[0..order+2] live, order <= 5 -> 8 rows.
D_ROWS = MAX_ORDER + 3


def _ndf_constants(dtype, device):
    """NDF modification constants (SciPy bdf.py:244-247)."""
    kw = dict(dtype=dtype, device=device)
    kappa = torch.tensor([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0], **kw)
    k = torch.arange(1, MAX_ORDER + 1, **kw)
    gamma = torch.cat([torch.zeros(1, **kw), torch.cumsum(1.0 / k, 0)])
    alpha = (1.0 - kappa) * gamma
    error_const = kappa * gamma + 1.0 / torch.arange(1, MAX_ORDER + 2, **kw)
    return gamma, alpha, error_const


def _compute_R(factor):
    """(B, MAX_ORDER+1, MAX_ORDER+1) difference-rescaling matrices for the
    per-member step ratio ``factor`` (B,), in ``factor``'s dtype."""
    kw = dict(dtype=factor.dtype, device=factor.device)
    i = torch.arange(MAX_ORDER + 1, **kw)[:, None]
    j = torch.arange(MAX_ORDER + 1, **kw)[None, :]
    body = (i - 1.0 - factor[:, None, None] * j) / torch.clamp(i, min=1.0)
    one = torch.ones((), **kw)
    m = torch.where(i == 0, one, torch.where(j == 0, 0.0 * one, body))
    return torch.cumprod(m, dim=1)


def _ordered_bmm(a, b):
    """``a @ b`` for (B, I, K) and (B, K, J), the terms added to zero in
    order k = 0, 1, ... with each product and each sum rounded on its own.
    On the operands the step controller forms (6 x 6 factors; 8 x 8 and
    8 x 1 products whose right factor holds only 0 and ±1) that is the
    CPU's ``matmul``, bit for bit, and K6 repeats it on the card, where
    cuBLAS's order changes with the batch."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=a.dtype,
                      device=a.device)
    for k in range(a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _padded_transform(h_factor, order, product=torch.matmul):
    """change_D's map as a (B, D_ROWS, D_ROWS) matrix ``T`` with
    ``D_new[i] = Σ_j T[i, j] D[j]``: ``(R(f) R(1))ᵀ`` on the leading
    (order+1)² block, identity outside. In ``h_factor``'s dtype; the
    product of the two R by ``product``."""
    B = h_factor.shape[0]
    P = product(_compute_R(h_factor), _compute_R(torch.ones_like(h_factor)))
    rows = torch.arange(D_ROWS, device=h_factor.device)
    i, j = rows[:, None], rows[None, :]
    eye = (i == j).to(h_factor.dtype)
    Ppad = torch.zeros((B, D_ROWS, D_ROWS), dtype=h_factor.dtype,
                       device=h_factor.device)
    Ppad[:, :MAX_ORDER + 1, :MAX_ORDER + 1] = P
    o = order[:, None, None]
    return torch.where((i <= o) & (j <= o), Ppad.transpose(1, 2), eye)


def _wsum(w, D):
    """Weighted sum over the row axis of ``D`` (B, J, ...), in D's dtype.

    ``w`` (B, J) gives ``Σ_j w[:, j] D[:, j]``; ``w`` (B, I, J) gives the
    row mix ``out[:, i] = Σ_j w[:, i, j] D[:, j]``. The terms are added in
    order j = 0, 1, ..., as the reference's elementwise reduction does, so
    the f64 state part rounds the same way in both packages."""
    w = w.to(D.dtype)
    tail = (1,) * (D.ndim - 2)
    if w.ndim == 2:
        out = w[:, 0].reshape(-1, *tail) * D[:, 0]
        for j in range(1, D.shape[1]):
            out = out + w[:, j].reshape(-1, *tail) * D[:, j]
        return out
    out = w[:, :, 0].reshape(*w.shape[:2], *tail) * D[:, None, 0]
    for j in range(1, D.shape[1]):
        out = out + w[:, :, j].reshape(*w.shape[:2], *tail) * D[:, None, j]
    return out


def interp_part(Dp, tv, t_new, h_new, order_new, dense_f32):
    """BdfDenseOutput of part ``Dp`` (B, D_ROWS, n, k) at times ``tv``
    (B, T) -> (B, T, n, k). With ``dense_f32`` the correction on top of the
    exact D[0] anchor runs in f32."""
    dt = Dp.dtype
    cdt = torch.float32 if dense_f32 else dt
    kw = dict(dtype=t_new.dtype, device=t_new.device)
    jj = torch.arange(MAX_ORDER, **kw)
    t_shift = t_new[:, None] - h_new[:, None] * jj
    denom = h_new[:, None] * (1.0 + jj)
    # form x in f64 (the time differences cancel), then the polynomial
    x = (tv[:, :, None] - t_shift[:, None, :]) / denom[:, None, :]
    # running product left to right, as the reference's cumprod (a
    # CPU torch.cumprod associates differently and rounds elsewhere)
    xc = x.to(cdt)
    cols = [xc[..., 0]]
    for j in range(1, MAX_ORDER):
        cols.append(cols[-1] * xc[..., j])
    p = torch.stack(cols, dim=2)
    ks = torch.arange(1, MAX_ORDER + 1, device=t_new.device)
    p = torch.where(ks <= order_new[:, None, None], p,
                    torch.zeros((), dtype=cdt, device=t_new.device))
    corr = _wsum(p, Dp[:, 1:MAX_ORDER + 1].to(cdt))
    return Dp[:, None, 0] + corr.to(dt)


def dense_fold_plain(ys_acc, D, t_eval, t_old, t_hi, t_new, h_new,
                     order_new, accept, running, too_small, dense_f32,
                     window=None):
    """Plain twin of K5 (:func:`dense_fold`): the interpolant over the
    whole grid, or over ``window``'s slice, then one ``where``."""
    gate = accept & running & ~too_small

    def interp(Dp):
        return lambda tv: interp_part(Dp, tv, t_new, h_new, order_new,
                                      dense_f32)

    if t_eval.ndim == 1:
        t_eval = t_eval[None, :].expand(t_old.shape[0], -1)
    if window is not None:
        lo, dw = window
        return tuple(common.interp_accumulate_windowed(
            t_eval, lo, t_old, t_hi, interp(Dp), acc, dw, gate=gate)
            for Dp, acc in zip(D, ys_acc))
    mask = ((t_eval > t_old[:, None]) & (t_eval <= t_hi[:, None])
            & gate[:, None])
    return tuple(torch.where(bcast(mask, acc), interp(Dp)(t_eval), acc)
                 for Dp, acc in zip(D, ys_acc))


# (storage dtype, compute dtype) of a part -> K5's code for it
_FOLD_KINDS = {(torch.float64, torch.float64): 0,
               (torch.float64, torch.float32): 1,
               (torch.float32, torch.float32): 2}


def _fold_launch(ys_acc, D, t_eval, t_old, t_hi, t_new, h_new, order_new,
                 accept, running, too_small, dense_f32):
    """One launch of K5 on the card, writing ``ys_acc`` in place (a
    non-contiguous part is first copied); returns the written parts."""
    f32 = torch.float32
    kinds = [_FOLD_KINDS.get((Dp.dtype, f32 if dense_f32 else Dp.dtype))
             for Dp in D]
    if None in kinds or any(acc.dtype != Dp.dtype
                            for acc, Dp in zip(ys_acc, D)):
        raise TypeError(
            f"dense_fold: K5 takes float32 or float64 parts, got D "
            f"{[Dp.dtype for Dp in D]}, ys_acc {[a.dtype for a in ys_acc]}")
    if len(D) not in (1, 2) or len(ys_acc) != len(D):
        raise ValueError(f"dense_fold: K5 takes one or two parts, got "
                         f"{len(D)} of D and {len(ys_acc)} of ys_acc")
    times = (t_eval, t_old, t_hi, t_new, h_new)
    if (t_eval.dtype not in (torch.float32, torch.float64)
            or any(x.dtype != t_eval.dtype for x in times)):
        raise TypeError(f"dense_fold: K5 takes float32 or float64 times of "
                        f"one dtype, got {[x.dtype for x in times]}")
    if t_eval.ndim == 1:
        t_eval = t_eval[None, :].expand(t_old.shape[0], -1)
    B, T = t_eval.shape
    n, rows = D[0].shape[2], D[0].shape[1]
    ys_acc = tuple(acc.contiguous() for acc in ys_acc)
    D = tuple(Dp.contiguous() for Dp in D)
    parts = []
    for kind, Dp, acc in zip(kinds, D, ys_acc):
        parts += [kind, Dp.shape[-1], Dp.data_ptr(), acc.data_ptr()]
    if len(D) == 1:
        parts += [-1, 0, None, None]
    t_old, t_hi, t_new, h_new, order_new, accept, running, too_small = (
        x.contiguous() for x in (t_old, t_hi, t_new, h_new, order_new,
                                 accept, running, too_small))
    kernels.launch(
        "tsb_dense_fold", int(t_eval.dtype == torch.float64), B, T, n,
        t_eval.data_ptr(), t_eval.stride(0), t_eval.stride(1),
        t_old.data_ptr(), t_hi.data_ptr(), t_new.data_ptr(), h_new.data_ptr(),
        order_new.to(torch.int64).data_ptr(), accept.data_ptr(),
        running.data_ptr(), too_small.data_ptr(), rows, *parts,
        device=t_eval.device, counter="bdf.fold")
    return ys_acc


def dense_fold(ys_acc, D, t_eval, t_old, t_hi, t_new, h_new, order_new,
               accept, running, too_small, dense_f32, window=None):
    """Fold one step's dense output into the ``t_eval`` accumulator.

    ``ys_acc`` and ``D`` are tuples of parts, (B, T, n, k_p) and (B,
    D_ROWS, n, k_p); ``t_eval`` (T,) or (B, T); the rest (B,). The points
    in ``(t_old, t_hi]`` take the interpolant of ``D``'s step (``t_new``,
    ``h_new``, ``order_new``) on the members with ``accept & running &
    ~too_small``; every other value keeps its bits. ``window`` ``(lo,
    dw)`` is ``SolverConfig.dense_window``'s slice for the twin.

    The result replaces ``ys_acc``, which the call consumes: on the card
    its parts are written in place, so the caller keeps no use of them.

    On the card every call is one launch of K5 (``linalg/csrc/dense_fold.cu``)
    over every part, which writes only those points and counts
    ``bdf.fold``; parts or times it has no code for raise. Inside a
    ``torch.func`` transform, or where autograd has to differentiate the
    call, the launch still gives the value, into a copy of the
    accumulator, and the twin the derivatives, counted as
    ``bdf.fold.plain`` (``linalg/kernels.py``'s ``call``). On the CPU the
    plain twin, :func:`dense_fold_plain`, runs."""
    k = len(D)

    def launch(*xs):
        return _fold_launch(xs[:k], xs[k:2 * k], *xs[2 * k:], dense_f32)

    def twin(*xs):
        return dense_fold_plain(xs[:k], xs[k:2 * k], *xs[2 * k:], dense_f32,
                                window)

    return kernels.call(
        launch, twin, (*ys_acc, *D, t_eval, t_old, t_hi, t_new, h_new,
                       order_new, accept, running, too_small),
        plain_counter="bdf.fold.plain", writes=k,
        vmap_message="dense_fold: K5 cannot run under vmap over its inputs; "
        "call dense_fold_plain instead")


def step_control_plain(d, D, D_old, Y0, order, n_iter, n_equal_steps,
                       converged, current_jac, h_abs, t, t_new, running,
                       too_small, error_const, *, rtol, atol, safety,
                       min_factor, max_factor, sens_error_control):
    """Plain twin of K6 (:func:`step_control`): the error test, the order
    and step choice and the difference-array update of one step attempt,
    as PyTorch ops."""
    dtype = h_abs.dtype
    dev = h_abs.device
    kw = dict(dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps
    one = torch.ones((), **kw)
    inf = torch.tensor(float("inf"), **kw)
    rows = torch.arange(D_ROWS, device=dev)
    bi_all = torch.arange(order.shape[0], device=dev)
    orderf = order.to(dtype)
    # B: Newton failed with a stale J; C: Newton failed with a fresh J
    case_B = ~converged & ~current_jac
    case_C = ~converged & current_jac

    safety = (safety * (2 * NEWTON_MAXITER + 1)
              / (2 * NEWTON_MAXITER + n_iter.to(dtype)))
    scale_new = atol + rtol * torch.abs(Y0[..., 0])
    d0, D0 = d[0], D[0]
    pdt = D0.dtype
    err = bcast(error_const[order].to(pdt), d0) * d0
    if sens_error_control:
        scale_full = atol + rtol * torch.abs(Y0)
        error_norm = rms_norm(err / scale_full).to(dtype)
    else:
        scale_full = None
        error_norm = rms_norm(err[..., 0] / scale_new).to(dtype)
    # NaN compares false and would ACCEPT a garbage step
    bad_err = ~torch.isfinite(error_norm)
    error_norm = torch.where(bad_err, 2.0 * one, error_norm)
    reject = converged & ((error_norm > 1.0) | bad_err)
    accept = converged & ~reject

    # --- order/step adaptation once n_equal > order ---
    n_equal_acc = n_equal_steps + 1
    do_adapt = accept & (n_equal_acc >= order + 1)
    ec_m = error_const[torch.clamp(order - 1, min=0)].to(pdt)
    ec_p = error_const[torch.clamp(order + 1, max=MAX_ORDER)].to(pdt)
    # D_acc[order] = D[order] + d;  D_acc[order+2] = d - D[order+1]
    err_m = bcast(ec_m, d0) * (D0[bi_all, order] + d0)
    err_p = bcast(ec_p, d0) * (d0 - D0[bi_all, order + 1])
    if scale_full is not None:
        em = rms_norm(err_m / scale_full).to(dtype)
        ep = rms_norm(err_p / scale_full).to(dtype)
    else:
        em = rms_norm(err_m[..., 0] / scale_new).to(dtype)
        ep = rms_norm(err_p[..., 0] / scale_new).to(dtype)
    err_m_norm = torch.where(order > 1, em, inf)
    err_p_norm = torch.where(order < MAX_ORDER, ep, inf)
    error_norms = torch.stack([err_m_norm, error_norm, err_p_norm], 1)
    exponents = -1.0 / (orderf[:, None] + torch.arange(3, **kw)[None, :])
    finite_norm = torch.isfinite(error_norms)
    safe_norms = torch.where(finite_norm,
                             torch.clamp(error_norms, min=eps), one)
    factors = torch.where(finite_norm, safe_norms ** exponents, 0.0 * one)
    best = torch.argmax(factors, dim=1)
    order_adapt = torch.clamp(order + best - 1, 1, MAX_ORDER)
    factor_adapt = torch.clamp(safety * torch.amax(factors, dim=1),
                               max=max_factor)

    factor_rej = torch.clamp(
        safety * error_norm ** (-1.0 / (orderf + 1.0)), min=min_factor)
    h_factor = torch.where(
        case_C, 0.5 * one,
        torch.where(reject, factor_rej,
                    torch.where(do_adapt, factor_adapt, one)))
    change = case_C | reject | do_adapt
    order_new = torch.where(do_adapt, order_adapt, order)

    # Compose (change_D rescale ∘ accept update) into one (D_ROWS,
    # D_ROWS) map W and a rank-one weight v per member:
    # D_new = W @ D + v ⊗ d. The accept update (append d at rows
    # order+1/order+2, then the downward telescoping sweep) is
    #   rows i<=order:  Σ_{j=i}^{order} D[j] + d
    #   row order+1:    d
    #   row order+2:    d - D[order+1]
    #   rows above:     identity
    ri, rj = rows[:, None], rows[None, :]
    o = order[:, None, None]
    eyeD = (ri == rj).to(dtype)
    acc_M = torch.where(
        ri <= o, ((rj >= ri) & (rj <= o)).to(dtype),
        torch.where(ri == o + 2, -(rj == o + 1).to(dtype),
                    ((ri == rj) & (ri > o + 2)).to(dtype)))
    acc_u = (rows[None, :] <= order[:, None] + 2).to(dtype)
    Ma = torch.where(accept[:, None, None], acc_M, eyeD)
    ua = torch.where(accept[:, None], acc_u, 0.0 * one)
    Tc = torch.where(change[:, None, None],
                     _padded_transform(h_factor, order_new, _ordered_bmm),
                     eyeD)
    W = _ordered_bmm(Tc, Ma)
    v = _ordered_bmm(Tc, ua[:, :, None])[:, :, 0]
    # a member that is not running, or whose step underflowed, keeps the
    # rows it began the attempt with (the gate settle applies to the rest
    # of the state)
    gate = running & ~too_small
    D_new = tuple(where_members(gate, _wsum(W, Dp)
                                + bcast(v.to(Dp.dtype), Dp) * dp[:, None],
                                Do)
                  for Dp, dp, Do in zip(D, d, D_old))
    h_new = h_abs * torch.where(change, h_factor, one)

    t_next = torch.where(accept, t_new, t)
    n_equal_new = torch.where(accept & ~do_adapt, n_equal_acc, 0)
    # SciPy keeps the factorization across error-test rejections;
    # only Newton failure, a Jacobian refresh or adaptation drop it.
    lu_valid_new = ~(case_B | case_C | do_adapt)
    current_jac_new = torch.where(
        case_B, True, torch.where(accept, False, current_jac))
    return (*D_new, accept, reject, order_new, h_new, t_next, n_equal_new,
            lu_valid_new, current_jac_new)


# a float dtype -> K6's code for it
_CTRL_KINDS = {torch.float64: 0, torch.float32: 1}


def _ctrl_launch(d, D, D_old, Y0, order, n_iter, n_equal_steps, converged,
                 current_jac, h_abs, t, t_new, running, too_small,
                 error_const, *, rtol, atol, safety, min_factor, max_factor,
                 sens_error_control):
    """One launch of K6 on the card into outputs it allocates; returns
    them as the plain twin does."""
    ct = h_abs.dtype
    kinds = [_CTRL_KINDS.get(Dp.dtype) for Dp in D]
    if (ct not in _CTRL_KINDS or None in kinds
            or any(x.dtype != ct for x in (t, t_new, error_const))
            or any(dp.dtype != Dp.dtype or Do.dtype != Dp.dtype
                   for dp, Dp, Do in zip(d, D, D_old))
            or Y0.dtype != D[0].dtype
            or (ct == torch.float32 and torch.float64 in
                [Dp.dtype for Dp in D])):
        raise TypeError(
            f"step_control: K6 takes float32 or float64 parts no wider than "
            f"the float32 or float64 control, got control {ct}, times "
            f"{[x.dtype for x in (t, t_new)]}, D {[Dp.dtype for Dp in D]}, "
            f"d {[dp.dtype for dp in d]}, Y {Y0.dtype}")
    if len(D) not in (1, 2) or len(d) != len(D) or len(D_old) != len(D):
        raise ValueError(f"step_control: K6 takes one or two parts, got "
                         f"{len(D)} of D, {len(D_old)} of D_old and "
                         f"{len(d)} of d")
    B, rows, n = D[0].shape[:3]
    if (rows != D_ROWS or error_const.shape != (MAX_ORDER + 1,)
            or any(Dp.shape[:3] != (B, D_ROWS, n)
                   or dp.shape != (B, n, Dp.shape[3])
                   or Do.shape != Dp.shape
                   for Dp, dp, Do in zip(D, d, D_old))
            or Y0.shape != d[0].shape):
        raise ValueError(
            f"step_control: K6 takes D (B, {D_ROWS}, n, k) with d and Y "
            f"(B, n, k), got D {[tuple(Dp.shape) for Dp in D]}, d "
            f"{[tuple(dp.shape) for dp in d]}, Y {tuple(Y0.shape)}")
    dev = h_abs.device
    D, D_old, d = (tuple(x.contiguous() for x in xs) for xs in (D, D_old, d))
    D_new = tuple(torch.empty_like(Dp) for Dp in D)
    parts = []
    for kind, Dp, Do, dp, Dn in zip(kinds, D, D_old, d, D_new):
        parts += [kind, Dp.shape[3], Dp.data_ptr(), Do.data_ptr(),
                  dp.data_ptr(), Dn.data_ptr()]
    if len(D) == 1:
        parts += [-1, 0, None, None, None, None]
    Y0, h_abs, t, t_new, error_const = (
        x.contiguous() for x in (Y0, h_abs, t, t_new, error_const))
    order = order.to(torch.int64).contiguous()
    n_iter, n_equal_steps = (x.to(torch.int32).contiguous()
                             for x in (n_iter, n_equal_steps))
    converged, current_jac, running, too_small = (
        x.contiguous() for x in (converged, current_jac, running, too_small))

    def out(dtype):
        return torch.empty(B, dtype=dtype, device=dev)

    flags = dict(accept=out(torch.bool), reject=out(torch.bool),
                 order_new=out(torch.int64), h_new=out(ct), t_next=out(ct),
                 n_equal_new=out(torch.int32), lu_valid_new=out(torch.bool),
                 current_jac_new=out(torch.bool))
    kernels.launch(
        "tsb_step_control", _CTRL_KINDS[ct], B, n, int(sens_error_control),
        Y0.data_ptr(), order.data_ptr(), n_iter.data_ptr(),
        n_equal_steps.data_ptr(), converged.data_ptr(),
        current_jac.data_ptr(), h_abs.data_ptr(), t.data_ptr(),
        t_new.data_ptr(), running.data_ptr(), too_small.data_ptr(),
        error_const.data_ptr(), float(rtol), float(atol),
        float(safety * (2 * NEWTON_MAXITER + 1)), float(min_factor),
        float(max_factor), *(x.data_ptr() for x in flags.values()),
        *parts, device=dev, counter="bdf.ctrl")
    return (*D_new, *flags.values())


def step_control(d, D, D_old, Y0, order, n_iter, n_equal_steps, converged,
                 current_jac, h_abs, t, t_new, running, too_small,
                 error_const, *, rtol, atol, safety, min_factor, max_factor,
                 sens_error_control):
    """The step controller of one attempt, after the Newton loop.

    ``d``, ``D`` and ``D_old`` are tuples of parts, (B, n, k_p) and (B,
    D_ROWS, n, k_p) twice: the attempt's total correction, the difference
    array it was predicted from, and that array as the attempt began,
    before the step-size rescaling; ``Y0`` (B, n, k_0) is part 0 of the
    corrected block;
    ``h_abs``, ``t``, ``t_new`` and the NDF ``error_const`` are in the
    control dtype; the rest (B,). Returns ``(*D_new, accept, reject,
    order_new, h_new, t_next, n_equal_new, lu_valid_new,
    current_jac_new)``: SciPy's error test on the state column (on all of
    part 0 with ``sens_error_control``), the order and step choice, and
    ``D`` rescaled and updated into new tensors, in which a member that is
    not ``running`` or whose step underflowed (``too_small``) keeps the
    rows of ``D_old``.

    On the card every call is one launch of K6
    (``linalg/csrc/step_control.cu``), counted as ``bdf.ctrl``; parts it
    has no code for raise. Under a ``torch.func`` transform, or where
    autograd has to differentiate the call, the launch gives the value and
    the twin the derivatives, counted as ``bdf.ctrl.plain``. On the CPU
    the plain twin, :func:`step_control_plain`, runs."""
    k = len(D)
    opts = dict(rtol=rtol, atol=atol, safety=safety, min_factor=min_factor,
                max_factor=max_factor, sens_error_control=sens_error_control)

    def launch(*xs):
        return _ctrl_launch(xs[:k], xs[k:2 * k], xs[2 * k:3 * k],
                            *xs[3 * k:], **opts)

    def twin(*xs):
        return step_control_plain(xs[:k], xs[k:2 * k], xs[2 * k:3 * k],
                                  *xs[3 * k:], **opts)

    return kernels.call(
        launch, twin, (*d, *D, *D_old, Y0, order, n_iter, n_equal_steps,
                       converged, current_jac, h_abs, t, t_new, running,
                       too_small, error_const),
        plain_counter="bdf.ctrl.plain",
        vmap_message="step_control: K6 cannot run under vmap over its "
        "inputs; call step_control_plain instead")


@trace.spanned("bdf.solve")
def bdf_solve(
    f: Callable,
    t_span,
    y0: torch.Tensor,
    t_eval: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    sens_rhs: Optional[Callable] = None,
    s0: Optional[torch.Tensor] = None,
    jac: Optional[Callable] = None,
    events: Optional[common.EventSpec] = None,
    dense_export: bool = False,
) -> IntegrateResult:
    """Integrate ``dy/dt = f(t, y)`` for a batch of members, forward.

    Args:
      f: batched RHS ``f(t, y) -> (B, n)`` with ``t`` (B,), ``y`` (B, n);
        parameters closed over; must follow the dtype of ``y``.
      t_span: ``(t0, t1)`` with ``t1 > t0``; each end a float shared by
        the batch or a (B,) tensor of per-member times.
      y0: initial states (B, n).
      t_eval: sorted output times within ``[t0, t1]``: (T,) shared by the
        batch, or (B, T) per member.
      config: solver configuration.
      sens_rhs: optional ``(t, y, S) -> (B, n, m)`` forward-sensitivity
        RHS; requires ``s0`` (B, n, m).
      jac: optional state Jacobian ``(t, y) -> (B, n, n)``; forward-mode
        AD of ``f`` otherwise.
      events: optional ``common.EventSpec``; fills ``event_t``,
        ``event_y`` and ``event_count``, and a terminal event stops its
        member with ``STATUS_EVENT``.
      dense_export: record each accepted step's interpolant into the
        result's ``seg_*`` buffers (B × max_steps × (MAX_ORDER+1) × n ×
        (1+m) values) for ``solvers.dense.OdeSolution``.

    Returns an ``IntegrateResult`` with ``ys`` (B, T, n) and ``sens``
    (B, T, n, m).
    """
    dtype = y0.dtype
    dev = y0.device
    B, n = y0.shape
    t0, t_bound, t_eval = common.prepare_times(t_span, y0, t_eval)
    T = t_eval.shape[1]
    # windowed dense output, active only when the window is a strict
    # subset of the grid
    dw = int(config.dense_window)
    dw = dw if 0 < dw < T else 0
    t_eval_c = t_eval.contiguous() if dw else None
    kw = dict(dtype=dtype, device=dev)

    if sens_rhs is not None:
        if s0 is None:
            raise ValueError("sens_rhs requires s0 of shape (B, n, m)")
        m = s0.shape[-1]
    else:
        m = 0

    if jac is None:
        def jac(t, y):
            return common.batched_jacobian(lambda yy: f(t, yy), y)

    factor_fn, solve_fn = make_linear_solver(config.linear_solver,
                                             config.jac_bandwidth)

    f32 = torch.float32
    # Mixed-precision hot loop: RHS/Jacobian/solves and the storage of the
    # whole column block in f32, time and step control in f64.
    mp = config.mixed_precision and dtype == torch.float64
    cdt = f32 if mp else dtype
    if mp:
        def jac_c(t, y):
            return jac(t, y.to(cdt)).to(cdt)

        def factor_c(a):
            return factor_fn(a.to(cdt))

        def solve_c(fact, b):
            return solve_fn(fact, b.to(cdt))

        def f_c(t, y):
            return f(t.to(cdt), y.to(cdt))
    else:
        jac_c, factor_c, solve_c, f_c = jac, factor_fn, solve_fn, f

    split = (config.sens_precision == "f32" and m > 0 and not mp
             and dtype == torch.float64 and not config.sens_error_control)
    if split:
        parts = ((1, dtype), (m, f32))
    elif mp:
        parts = ((1 + m, f32),)
    else:
        parts = ((1 + m, dtype),)

    def _fact32(fact):
        if isinstance(fact, tuple):
            return tuple(a.to(f32) if a.is_floating_point() else a
                         for a in fact)
        return fact.to(f32)

    if m == 0:
        def faug_b(t, Yb):
            return (f_c(t, Yb[0][..., 0])[..., None],)
    elif split:
        def faug_b(t, Yb):
            y = Yb[0][..., 0]
            return (f(t, y)[..., None],
                    sens_rhs(t.to(f32), y.to(f32), Yb[1]))
    else:
        def faug_b(t, Yb):
            Y = Yb[0]
            y = Y[..., 0]
            tc = t.to(cdt)   # storage is already f32 under mixed_precision
            return (torch.cat([f(tc, y)[..., None],
                               sens_rhs(tc, y, Y[..., 1:])], dim=-1),)

    gamma, alpha, error_const = _ndf_constants(dtype, dev)
    eps = torch.finfo(dtype).eps
    newton_tol = max(10 * eps / config.rtol,
                     min(0.03, config.rtol ** 0.5))
    rtol, atol = config.rtol, config.atol
    max_step = torch.tensor(float(config.max_step), **kw)
    I_n = torch.eye(n, **kw)
    rows = torch.arange(D_ROWS, device=dev)
    gamma_pad = torch.cat([gamma, torch.zeros(D_ROWS - MAX_ORDER - 1, **kw)])
    one = torch.ones((), **kw)
    inf = torch.tensor(float("inf"), **kw)

    # --- initialization (SciPy BDF __init__) ----------------------------
    if split:
        Y0b = (y0[..., None], s0.to(f32))
    elif m:
        Y0b = (torch.cat([y0[..., None], s0.to(dtype)], dim=-1).to(cdt),)
    else:
        Y0b = (y0[..., None].to(cdt),)
    F0b = faug_b(t0, Y0b)
    f0 = F0b[0][..., 0].to(dtype)
    if config.debug_checks and not bool(torch.isfinite(f0).all()):
        raise FloatingPointError(
            "non-finite RHS at the initial condition")
    if config.first_step is None:
        h0 = common.select_initial_step(
            f, t0, y0, f0, t_bound, config.max_step, rtol, atol, order=1)
    else:
        h0 = torch.full((B,), float(config.first_step), **kw)
    h0 = torch.minimum(h0, torch.abs(t_bound - t0))

    def d_init(Y0p, F0p):
        D = torch.zeros((B, D_ROWS) + Y0p.shape[1:], dtype=Y0p.dtype,
                        device=dev)
        D[:, 0] = Y0p
        D[:, 1] = F0p * bcast(h0.to(Y0p.dtype), F0p)
        return D

    at_t0 = (t_eval == t0[:, None])[:, :, None, None]
    i32 = dict(dtype=torch.int32, device=dev)
    st = dict(
        t=t0, h_abs=h0, order=torch.ones(B, dtype=torch.int64, device=dev),
        D=tuple(d_init(Yp, Fp) for Yp, Fp in zip(Y0b, F0b)),
        J=jac_c(t0, y0), fact=None,
        lu_valid=torch.zeros(B, dtype=torch.bool, device=dev),
        current_jac=torch.zeros(B, dtype=torch.bool, device=dev),
        last_accepted=torch.ones(B, dtype=torch.bool, device=dev),
        n_equal_steps=torch.zeros(B, **i32),
        status=common.status_init(t0, t_bound),
        ys_acc=tuple(torch.where(at_t0, Yp[:, None],
                                 torch.zeros((B, T) + Yp.shape[1:],
                                             dtype=Yp.dtype, device=dev))
                     for Yp in Y0b),
        nsteps=torch.zeros(B, **i32), naccepted=torch.zeros(B, **i32),
        nrejected=torch.zeros(B, **i32),
        nfev=torch.full((B,), 1 + (0 if config.first_step is not None
                                   else 2), **i32),
        njev=torch.ones(B, **i32), nlu=torch.zeros(B, **i32),
        order_hist=torch.zeros((B, MAX_ORDER + 1), **i32),
    )

    # --- event channel ---
    if events is not None:
        g0 = torch.as_tensor(events.fn(t0, y0), **kw)
        if g0.ndim != 2 or g0.shape[0] != B:
            raise ValueError(f"EventSpec.fn must return ({B}, E); got "
                             f"{tuple(g0.shape)}")
        n_ev = g0.shape[1]
        ev_cap = int(events.capacity)
        ev_dir = torch.as_tensor(events.direction or (0,) * n_ev,
                                 dtype=torch.int32, device=dev)
        ev_term = torch.as_tensor(events.terminal or (False,) * n_ev,
                                  dtype=torch.bool, device=dev)
        if ev_dir.shape != (n_ev,) or ev_term.shape != (n_ev,):
            raise ValueError("EventSpec direction/terminal length must "
                             "match the event vector length")
        st.update(g_old=g0, ev_t=torch.full((B, n_ev, ev_cap), inf, **kw),
                  ev_y=torch.zeros((B, n_ev, ev_cap, n), **kw),
                  ev_count=torch.zeros((B, n_ev), **i32))

    # --- dense-export buffers, written in place per accepted step (a
    #     member that is not running or underflows writes its old value) ---
    if dense_export:
        S = int(config.max_steps)
        seg = dict(t=torch.full((B, S), inf, **kw),
                   h=torch.zeros((B, S), **kw),
                   order=torch.zeros((B, S), **i32),
                   D=tuple(torch.zeros((B, S, MAX_ORDER + 1) + Yp.shape[1:],
                                       dtype=Yp.dtype, device=dev)
                           for Yp in Y0b))
    bi_all = torch.arange(B, device=dev)

    def body(st):
        with trace.span("bdf.predict"):
            t, order = st["t"], st["order"]
            h_abs = st["h_abs"]
            D = st["D"]
            lu_valid = st["lu_valid"]
            n_equal_steps = st["n_equal_steps"]
            last_accepted = st["last_accepted"]
            running = st["status"] == STATUS_RUNNING
            if config.debug_checks:
                bad = torch.nonzero(~(h_abs > 0) & running)
                if bad.numel():
                    i = int(bad[0, 0])
                    raise FloatingPointError(
                        f"non-positive step size h={float(h_abs[i])} at "
                        f"t={float(t[i])}")

            # SciPy clamps h into [min_step, max_step] at a fresh step; inside
            # a retry sequence h < min_step is fatal.
            min_step = 10 * eps * torch.abs(t)
            too_small = (h_abs < min_step) & ~last_accepted
            h_clamped = torch.minimum(torch.maximum(h_abs, min_step), max_step)
            pre_clamp = last_accepted & (h_clamped != h_abs)
            pre_factor = torch.where(pre_clamp, h_clamped / h_abs, one)
            n_equal_steps = torch.where(pre_clamp, 0, n_equal_steps)
            h_abs = torch.where(last_accepted, h_clamped, h_abs)

            # clip the final step to t_bound (with dense_window also to the
            # (window-1)-th next t_eval point); the clamp and clip rescalings
            # compose into one change_D
            if dw:
                lo_eval = torch.searchsorted(t_eval_c, t[:, None].contiguous(),
                                             right=True)[:, 0]
                last = torch.clamp(lo_eval + (dw - 1), max=T - 1)
                t_cap = torch.where(
                    lo_eval + (dw - 1) < T,
                    torch.gather(t_eval, 1, last[:, None])[:, 0], inf)
                bound_eff = torch.minimum(t_bound, t_cap)
            else:
                bound_eff = t_bound
            t_new_raw = t + h_abs
            clipped = t_new_raw > bound_eff
            t_new = torch.where(clipped, bound_eff, t_new_raw)
            h = t_new - t
            clip_factor = torch.where(clipped, h / h_abs, one)
            rescale = pre_clamp | clipped
            if trace.read((rescale & running).any(), "bdf.reads"):
                f_tot = pre_factor * clip_factor
                D = tuple(where_members(rescale, _wsum(
                    _padded_transform(f_tot.to(Dp.dtype), order), Dp), Dp)
                    for Dp in D)
            n_equal_steps = torch.where(clipped, 0, n_equal_steps)
            lu_valid = lu_valid & ~clipped
            h_abs = h

            # --- prediction ---
            pred_w = (rows[None, :] <= order[:, None]).to(dtype)
            y_predict = tuple(_wsum(pred_w, Dp) for Dp in D)
            alpha_o = alpha[order]
            psi_w = torch.where((rows[None, :] >= 1)
                                & (rows[None, :] <= order[:, None]),
                                gamma_pad[rows][None, :], 0.0 * one)
            c = h / alpha_o
            psi = tuple(_wsum(psi_w / alpha_o[:, None], Dp) for Dp in D)
            scale_state = atol + rtol * torch.abs(y_predict[0][..., 0])

        # --- factorization (reused while SciPy would reuse it) ---
        with trace.span("bdf.factor"):
            fact = st["fact"]
            if trace.read((running & ~lu_valid).any(), "bdf.reads"):
                new = factor_c(I_n - c[:, None, None] * st["J"].to(dtype))
                fact = (new if fact is None
                        else where_members(lu_valid, fact, new))
            nlu = st["nlu"] + (~lu_valid).to(torch.int32)
            fact32 = _fact32(fact) if split else None

        # --- modified Newton, masked; the batch union of trips ---
        with trace.span("bdf.newton"):
            c_b = tuple(c.to(dt) for _, dt in parts)
            Y = y_predict
            d = tuple(torch.zeros_like(yp) for yp in y_predict)
            dy_norm_old = torch.zeros(B, **kw)
            n_iter = torch.zeros(B, **i32)
            converged = torch.zeros(B, dtype=torch.bool, device=dev)
            failed = ~running   # members not running take no trips
            it = torch.zeros(B, **i32)
            while True:
                go = (it < NEWTON_MAXITER) & ~(converged | failed)
                if not trace.read(go.any(), "bdf.reads"):
                    break
                with trace.span("bdf.rhs"):
                    Fv = faug_b(t_new, Y)
                nonfinite = ~torch.stack(
                    [torch.isfinite(Fp).reshape(B, -1).all(1) for Fp in Fv]
                ).all(0)
                resid = tuple(bcast(cb, Fp) * Fp - pp - dp
                              for cb, Fp, pp, dp in zip(c_b, Fv, psi, d))
                with trace.span("bdf.lsolve"):
                    if split:
                        dy = (solve_c(fact, resid[0]),
                              solve_fn(fact32, resid[1]))
                    else:
                        dy = (solve_c(fact, resid[0]),)
                dy_norm = rms_norm(dy[0][..., 0] / scale_state)
                rate = dy_norm / torch.where(dy_norm_old > 0, dy_norm_old, one)
                have_rate = it > 0
                diverged = have_rate & (
                    (rate >= 1.0)
                    | (rate ** (NEWTON_MAXITER - it).to(dtype) / (1.0 - rate)
                       * dy_norm > newton_tol))
                ok = go & ~nonfinite & ~diverged
                Y = tuple(where_members(ok, Yp + dyp, Yp)
                          for Yp, dyp in zip(Y, dy))
                d = tuple(where_members(ok, dp + dyp, dp)
                          for dp, dyp in zip(d, dy))
                conv_now = ok & ((dy_norm == 0.0)
                                 | (have_rate & (rate / (1.0 - rate) * dy_norm
                                                 < newton_tol)))
                converged = converged | conv_now
                failed = failed | (go & (nonfinite | diverged))
                n_iter = n_iter + go.to(torch.int32)
                dy_norm_old = torch.where(ok, dy_norm, dy_norm_old)
                it = it + go.to(torch.int32)
            Y_new = Y
            nfev = st["nfev"] + n_iter

        # --- outcome classification ---
        with trace.span("bdf.jac"):
            # B: Newton failed with a stale J -> refresh J, retry at same h.
            case_B = ~converged & ~st["current_jac"]
            # C: Newton failed with fresh J -> halve the step.
            case_C = ~converged & st["current_jac"]
            J = st["J"]
            if trace.read((case_B & running).any(), "bdf.reads"):
                J = where_members(case_B,
                                  jac_c(t_new, y_predict[0][..., 0]), J)
            njev = st["njev"] + case_B.to(torch.int32)

        with trace.span("bdf.control"):
            out = step_control(
                d, D, st["D"], Y_new[0], order, n_iter, n_equal_steps,
                converged, st["current_jac"], h_abs, t, t_new, running,
                too_small, error_const, rtol=rtol, atol=atol,
                safety=config.safety, min_factor=config.min_factor,
                max_factor=config.max_factor,
                sens_error_control=bool(config.sens_error_control and m
                                        and not split))
            D_new = out[:len(D)]
            (accept, reject, order_new, h_new, t_next, n_equal_new,
             lu_valid_new, current_jac_new) = out[len(D):]

        # --- dense export: this step's interpolant, pre-event-rewrite ---
        if dense_export:
            with trace.span("bdf.dense"):
                write = accept & running & ~too_small
                slot = torch.clamp(st["naccepted"], max=S - 1).to(torch.int64)
                for key, val in (("t", t_new), ("h", h_new),
                                 ("order", order_new.to(torch.int32))):
                    buf = seg[key]
                    buf[bi_all, slot] = torch.where(write, val,
                                                    buf[bi_all, slot])
                for Dp, buf in zip(D_new, seg["D"]):
                    buf[bi_all, slot] = torch.where(
                        bcast(write, Dp[:, :MAX_ORDER + 1]),
                        Dp[:, :MAX_ORDER + 1], buf[bi_all, slot])

        # --- state-dependent events ---
        ev_new = {}
        has_term = None
        t_fill_hi = t_new
        D_fill = D_new
        if events is not None:
            with trace.span("bdf.events"):
                def y_at(tv):
                    # state column of this step's interpolant at tv (B, E)
                    return interp_part(D_new[0], tv, t_new, h_new,
                                       order_new, config.dense_f32
                                       )[..., 0].to(dtype)

                g_old = st["g_old"]
                g_new = torch.as_tensor(events.fn(t_new, Y_new[0][..., 0]
                                                  .to(dtype)), **kw)
                up = (g_old <= 0) & (g_new >= 0)
                down = (g_old >= 0) & (g_new <= 0)
                trig = torch.where(ev_dir > 0, up,
                                   torch.where(ev_dir < 0, down, up | down))
                fired = accept[:, None] & trig
                hi = t_new[:, None].expand(B, n_ev)
                if trace.read((fired & running[:, None]).any(),
                              "bdf.reads"):
                    # bisection on the step's polynomial; fn is evaluated once
                    # per event at that event's mids, keeping member order
                    lo, glo = t[:, None].expand(B, n_ev), g_old
                    for _ in range(int(events.bisect_iters)):
                        mid = 0.5 * (lo + hi)
                        ys_mid = y_at(mid)
                        g_mid = torch.stack(
                            [torch.as_tensor(events.fn(mid[:, e],
                                                       ys_mid[:, e]),
                                             **kw)[:, e]
                             for e in range(n_ev)], dim=1)
                        same = ((torch.sign(g_mid) == torch.sign(glo))
                                & (g_mid != 0.0))
                        lo = torch.where(same, mid, lo)
                        hi = torch.where(same, hi, mid)
                        glo = torch.where(same, g_mid, glo)
                t_root = torch.where(fired, hi, inf)
                # the earliest terminal root ends the member there; later
                # occurrences of any event are discarded
                t_term = torch.amin(torch.where(fired & ev_term, t_root, inf),
                                    dim=1)
                has_term = torch.isfinite(t_term)
                rec = fired & (t_root <= t_term[:, None])
                count = st["ev_count"]
                slot_e = torch.clamp(count, max=ev_cap - 1).to(torch.int64)
                can_store = rec & (count < ev_cap)
                ys_root = y_at(torch.where(torch.isfinite(t_root), t_root,
                                           t_new[:, None]))
                ev_t = st["ev_t"].clone()
                ev_y = st["ev_y"].clone()
                old_t = torch.gather(ev_t, 2, slot_e[..., None])[..., 0]
                ev_t.scatter_(2, slot_e[..., None],
                              torch.where(can_store, t_root, old_t)[..., None])
                idx_y = slot_e[..., None, None].expand(B, n_ev, 1, n)
                old_y = torch.gather(ev_y, 2, idx_y)[:, :, 0]
                ev_y.scatter_(2, idx_y,
                              torch.where(can_store[..., None], ys_root,
                                          old_y)[:, :, None])
                t_term_safe = torch.where(has_term, t_term, t_new)
                ev_new = dict(g_old=torch.where(accept[:, None], g_new, g_old),
                              ev_t=ev_t, ev_y=ev_y,
                              ev_count=count + rec.to(torch.int32))
                # t_eval is filled from the step's own polynomial up to the
                # event time; the anchor row then moves to the event state
                t_fill_hi = t_term_safe
                Y_term = tuple(interp_part(Dp, t_term_safe[:, None], t_new,
                                           h_new, order_new,
                                           config.dense_f32)[:, 0]
                               for Dp in D_new)
                # gated as step_control gates D_new: a frozen member's D
                # keeps its bits
                moved = has_term & running & ~too_small
                D_new = tuple(torch.cat([torch.where(bcast(moved, Yt), Yt,
                                                     Dp[:, 0])[:, None],
                                         Dp[:, 1:]], dim=1)
                              for Dp, Yt in zip(D_new, Y_term))

        # --- dense output at t_eval from the post-update D/order/h, gated
        #     as settle gates the rest of the state ---
        with trace.span("bdf.dense"):
            ys_acc = dense_fold(st["ys_acc"], D_fill, t_eval, t, t_fill_hi,
                                t_new, h_new, order_new, accept, running,
                                too_small, config.dense_f32,
                                window=(lo_eval, dw) if dw else None)

        with trace.span("bdf.control"):
            nsteps = st["nsteps"] + 1
            done, status = common.step_status(accept, t_new, t_bound, nsteps,
                                              config.max_steps)
            if has_term is not None:
                status = torch.where(has_term, STATUS_EVENT, status).to(
                    torch.int32)
                t_next = torch.where(has_term, t_term_safe, t_next)

            acc32 = accept.to(torch.int32)
            new_st = dict(
                t=t_next, h_abs=h_new, order=order_new, J=J,
                fact=fact, lu_valid=lu_valid_new, current_jac=current_jac_new,
                last_accepted=accept, n_equal_steps=n_equal_new, status=status,
                nsteps=nsteps,
                naccepted=st["naccepted"] + acc32,
                nrejected=st["nrejected"] + (reject | case_C).to(torch.int32),
                nfev=nfev, njev=njev, nlu=nlu,
                order_hist=st["order_hist"]
                + torch.nn.functional.one_hot(order, MAX_ORDER + 1)
                .to(torch.int32) * acc32[:, None], **ev_new)
            # ys_acc (dense_fold) and D (step_control) come gated already
            rest = {k: v for k, v in st.items() if k not in ("ys_acc", "D")}
            return dict(common.settle(dict(rest, fact=fact), new_st,
                                      too_small, running),
                        D=D_new, ys_acc=ys_acc)

    running = trace.read((st["status"] == STATUS_RUNNING).any(),
                         "bdf.reads")
    while running:
        trace.count("bdf.trips")
        with trace.span("bdf.trip"):
            st = body(st)
            running = trace.read(
                (st["status"] == STATUS_RUNNING).any(), "bdf.reads")

    ys = st["ys_acc"][0][..., 0]
    sens = (st["ys_acc"][1].to(dtype) if split
            else st["ys_acc"][0][..., 1:])
    y_final = torch.cat([Dp[:, 0].to(dtype) for Dp in st["D"]], dim=-1)
    extra = {}
    if events is not None:
        extra.update(event_t=st["ev_t"], event_y=st["ev_y"],
                     event_count=st["ev_count"])
    if dense_export:
        extra.update(seg_t=seg["t"], seg_h=seg["h"], seg_order=seg["order"],
                     seg_D=seg["D"])
    return IntegrateResult(
        ys=ys, sens=sens, status=st["status"], nsteps=st["nsteps"],
        naccepted=st["naccepted"], nrejected=st["nrejected"],
        nfev=st["nfev"], njev=st["njev"], nlu=st["nlu"],
        order_hist=st["order_hist"], t_final=st["t"], y_final=y_final,
        **extra)
