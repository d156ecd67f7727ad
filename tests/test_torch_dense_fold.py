"""K5, the BDF stepper's dense-output fold (``linalg/csrc/dense_fold.cu``),
and its dispatch in ``tpusysbio_torch/solvers/bdf.py``.

On the CPU: ``bdf.dense_fold`` (the plain twin there) against the
composition it replaces inside the stepper, bit for bit: the interpolant
over the whole grid (or the ``dense_window`` slice), the accumulator's
``where``, then the two ``where``s of ``common.settle``. On a card (marker
``cuda``, skipped without one): the kernel against the twin, bit for bit,
on the same cases and on whole ``bdf_solve`` runs, one launch a trip, and
under autograd and ``torch.func.jvp``, where the twin gives only the
derivatives. The kernel's refusals need no card. This
file imports neither jax nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_dense_fold.py
"""

import numpy as np
import pytest
import torch

from tpusysbio_torch import SolverConfig, trace
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import bdf, common

F32, F64 = torch.float32, torch.float64
B, N, M, T = 8, 3, 2, 11
# each member's (t_old, h, t_hi - t_new, order) on the grid 0, 1, ..., 10:
# no point, one, three (t_old on a point), rejected, done, underflowed, an
# event's t_hi short of t_new, the last point at t_hi exactly
STEPS = [(2.2, 0.5, 0.0, 1), (2.5, 0.9, 0.0, 2), (3.0, 3.5, 0.0, 3),
         (1.0, 2.0, 0.0, 4), (4.1, 1.5, 0.0, 5), (5.5, 1.0, 0.0, 1),
         (6.2, 3.0, -1.7, 2), (8.0, 2.0, 0.0, 3)]
ACCEPT = [1, 1, 1, 0, 1, 1, 1, 1]
RUNNING = [1, 1, 1, 1, 0, 1, 1, 1]
TOO_SMALL = [0, 0, 0, 0, 0, 1, 0, 0]
# points each member's fold writes (shared grid)
WRITES = [0, 1, 3, 0, 0, 0, 1, 2]
LAYOUTS = {"split": ((1, F64), (M, F32)), "mixed": ((1 + M, F32),),
           "plain": ((1 + M, F64),)}
CASES = [(layout, dense_f32, grid, window)
         for layout in LAYOUTS for dense_f32 in (True, False)
         for grid in ("shared", "member") for window in (None, 3)]


def _case(layout, grid, device, seed=0):
    """The fold's inputs: parts of D (random, with an infinity that a
    zeroed weight meets) and of the accumulator, the members' steps."""
    g = torch.Generator().manual_seed(seed)
    t_eval = torch.arange(T, dtype=F64)
    if grid == "member":
        # offsets of 1/8: the boundary cases stay exact
        t_eval = t_eval[None, :] + 0.125 * torch.arange(B, dtype=F64)[:, None]
    shift = t_eval[:, 0] if grid == "member" else torch.zeros(B, dtype=F64)
    t_old, h, hi_off, order = (torch.tensor(c, dtype=F64)
                               for c in zip(*STEPS))
    t_old = t_old + shift
    t_new = t_old + h
    D, acc = [], []
    for k, dt in LAYOUTS[layout]:
        Dp = torch.randn((B, bdf.D_ROWS, N, k), generator=g, dtype=F64)
        Dp[1, 4, 0, 0] = float("inf")   # member 1 is at order 2: 0 * inf
        D.append(Dp.to(dt).to(device))
        acc.append(torch.randn((B, T, N, k), generator=g, dtype=F64)
                   .to(dt).to(device))

    def flags(v):
        return torch.tensor(v, dtype=torch.bool, device=device)

    return dict(ys_acc=tuple(acc), D=tuple(D), t_eval=t_eval.to(device),
                t_old=t_old.to(device), t_hi=(t_new + hi_off).to(device),
                t_new=t_new.to(device), h_new=h.to(device),
                order_new=order.to(torch.int64).to(device),
                accept=flags(ACCEPT), running=flags(RUNNING),
                too_small=flags(TOO_SMALL))


def _window(x, dw):
    if dw is None:
        return None
    te = x["t_eval"]
    te = te if te.ndim == 2 else te[None, :].expand(B, -1)
    lo = torch.searchsorted(te.contiguous(), x["t_old"][:, None].contiguous(),
                            right=True)[:, 0]
    return lo, dw


def _replaced(x, dense_f32, window):
    """The stepper's composition before the fold: ``interp_accumulate``
    (or its windowed form, gated by the accept flag) from ``t_old``, or
    +inf for a rejected step, then ``common.settle`` on the accumulator."""
    t_old_fill = torch.where(x["accept"], x["t_old"], torch.inf)
    t_eval = x["t_eval"]
    t_eval = t_eval if t_eval.ndim == 2 else t_eval[None, :].expand(B, -1)
    out = []
    for Dp, acc in zip(x["D"], x["ys_acc"]):
        def interp(tv, Dp=Dp):
            return bdf.interp_part(Dp, tv, x["t_new"], x["h_new"],
                                   x["order_new"], dense_f32)

        if window is None:
            out.append(common.interp_accumulate(
                t_eval, t_old_fill, x["t_hi"], interp, acc))
        else:
            out.append(common.interp_accumulate_windowed(
                t_eval, window[0], t_old_fill, x["t_hi"], interp, acc,
                window[1], gate=x["accept"]))
    status = torch.zeros(B, dtype=torch.int32, device=x["t_old"].device)
    return common.settle(dict(ys_acc=x["ys_acc"], status=status),
                         dict(ys_acc=tuple(out), status=status),
                         x["too_small"], x["running"])["ys_acc"]


def _bits(a):
    return a.view(torch.int64 if a.dtype == F64 else torch.int32)


def _same_bits(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("layout,dense_f32,grid,window", CASES)
def test_twin_is_the_replaced_composition(layout, dense_f32, grid, window):
    """Bit for bit, and only the covered points of the gated members
    change (one of them to NaN: a zeroed weight times an infinity)."""
    x = _case(layout, grid, "cpu")
    before = tuple(a.clone() for a in x["ys_acc"])
    win = _window(x, window)
    ref = _replaced(x, dense_f32, win)
    trace.reset()
    got = bdf.dense_fold(**x, dense_f32=dense_f32, window=win)
    assert trace.counters() == {}
    _same_bits(got, ref)
    _same_bits(x["ys_acc"], before)
    changed = (_bits(got[-1]) != _bits(before[-1])).any(-1).any(-1)
    assert changed.sum(1).tolist() == WRITES
    assert bool(torch.isnan(got[-1][1]).any())


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _fold_counts():
    c = trace.counters()
    return c.get("bdf.fold", 0), c.get("bdf.fold.plain", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,dense_f32,grid,window", CASES)
def test_kernel_is_the_twin(cuda_device, layout, dense_f32, grid, window):
    x = _case(layout, grid, cuda_device)
    win = _window(x, window)
    ref = bdf.dense_fold_plain(**x, dense_f32=dense_f32, window=win)
    trace.reset()
    got = bdf.dense_fold(**x, dense_f32=dense_f32, window=win)
    torch.cuda.synchronize()
    assert _fold_counts() == (1, 0)
    _same_bits(got, ref)


@pytest.mark.cuda
def test_gradient_takes_the_twin(cuda_device):
    """Under autograd K5 still gives the value, into a copy of the
    accumulator; the gradient is the twin's, one plain use counted."""
    x = _case("split", "shared", cuda_device)
    before = tuple(a.clone() for a in x["ys_acc"])
    D0 = x["D"][0]
    ref_x = dict(x, D=(D0.clone().requires_grad_(True), x["D"][1]))
    ref = bdf.dense_fold_plain(**ref_x, dense_f32=True)
    x["D"] = (D0.requires_grad_(True), x["D"][1])
    trace.reset()
    got = bdf.dense_fold(**x, dense_f32=True)
    torch.cuda.synchronize()
    assert _fold_counts() == (1, 0)
    _same_bits(tuple(a.detach() for a in got),
               tuple(a.detach() for a in ref))
    _same_bits(x["ys_acc"], before)
    w = torch.randn_like(before[0])
    g, = torch.autograd.grad((got[0] * w).sum(), x["D"][0])
    g_ref, = torch.autograd.grad((ref[0] * w).sum(), ref_x["D"][0])
    assert _fold_counts() == (1, 1)
    _same_bits((g,), (g_ref,))


@pytest.mark.cuda
def test_tangent_takes_the_twin(cuda_device):
    """Inside ``torch.func.jvp`` K5 gives the value and the twin the
    tangent, bit for bit as the twin's own jvp, with tangents on the
    accumulator, ``D`` and the times."""
    x = _case("split", "member", cuda_device)
    times = ("t_eval", "t_old", "t_hi", "t_new", "h_new")
    primals = (*x["ys_acc"], *x["D"], *(x[k] for k in times))
    tangents = tuple(torch.randn_like(p) for p in primals)
    before = tuple(a.clone() for a in x["ys_acc"])

    def fold(fn):
        def f(*p):
            return fn(**dict(x, ys_acc=p[:2], D=p[2:4],
                             **dict(zip(times, p[4:]))), dense_f32=True)
        return f

    ref = torch.func.jvp(fold(bdf.dense_fold_plain), primals, tangents)
    trace.reset()
    got = torch.func.jvp(fold(bdf.dense_fold), primals, tangents)
    torch.cuda.synchronize()
    assert _fold_counts() == (1, 1)
    _same_bits(got[0], ref[0])
    _same_bits(got[1], ref[1])
    _same_bits(x["ys_acc"], before)


@pytest.mark.parametrize("fault", ["half", "three_parts", "time_dtype"])
def test_kernel_refuses_what_it_has_no_code_for(fault):
    """K5's checks come before anything touches a card, so they run on
    the CPU: a part in another dtype, a third part, or times of two
    dtypes raise, where the plain twin would quietly run instead."""
    x = _case("split", "shared", "cpu")
    if fault == "half":
        x["D"] = (x["D"][0], x["D"][1].half())
        x["ys_acc"] = (x["ys_acc"][0], x["ys_acc"][1].half())
    elif fault == "three_parts":
        x["D"] += x["D"][1:]
        x["ys_acc"] += x["ys_acc"][1:]
    else:
        x["h_new"] = x["h_new"].float()
    trace.reset()
    with pytest.raises(ValueError if fault == "three_parts" else TypeError,
                       match="dense_fold: K5 takes"):
        bdf._fold_launch(**x, dense_f32=True)
    assert trace.counters() == {}


def _twin_only(monkeypatch):
    monkeypatch.setattr(bdf, "dense_fold", bdf.dense_fold_plain)


def _mapk(B_, device, seed):
    model = library.mapk_huang_ferrell(device=device)
    k = library.mapk_true_params(device=device)
    rng = np.random.default_rng(seed)
    ps = k * torch.exp(torch.as_tensor(
        0.1 * rng.standard_normal((B_, k.shape[0])), device=device))
    return model, ps


@pytest.mark.cuda
@pytest.mark.parametrize("B_,grid,window", [(256, "shared", 0),
                                            (256, "member", 0),
                                            (256, "shared", 4),
                                            (10_000, "shared", 0)])
def test_mapk22_runs_equal_the_twins(cuda_device, monkeypatch, B_, grid,
                                     window):
    """Whole integrations of the cells' path (f64 state column, f32
    sensitivities, dense_f32, 41 points), one launch a trip and no twin;
    the same run through the twin gives the same bits."""
    model, ps = _mapk(B_, cuda_device, B_)
    t_eval = torch.linspace(0.0, 100.0, 41, dtype=F64, device=cuda_device)
    if grid == "member":
        t_eval = t_eval[None, :] * (1.0 - 0.001 * torch.rand(
            (B_, 1), dtype=F64, device=cuda_device))
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=1024,
                       linear_solver="pallas", sens_precision="f32",
                       dense_f32=True, dense_window=window)

    def run():
        return model.simulate_sensitivities(ps, (0.0, 100.0), t_eval,
                                            config=cfg, device=cuda_device)

    trace.reset()
    got = run()
    torch.cuda.synchronize()
    trips = trace.counters()["bdf.trips"]
    assert _fold_counts() == (trips, 0)
    _twin_only(monkeypatch)
    trace.reset()
    ref = run()
    assert _fold_counts() == (0, 0)
    assert trace.counters()["bdf.trips"] == trips
    assert torch.equal(got.nsteps, ref.nsteps)
    assert float((got.ys - ref.ys).abs().max()) == 0.0
    assert float((got.sens - ref.sens).abs().max()) == 0.0
    _same_bits((got.ys, got.sens), (ref.ys, ref.sens))


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
def test_jakstat_runs_equal_the_twins(cuda_device, monkeypatch, mixed):
    """n = 4 with AD derivatives: f64 with f32 sensitivities, and the f32
    screening stepper (one f32 part, f64 times)."""
    model = library.jak_stat(device=cuda_device)
    rng = np.random.default_rng(4)
    ps = torch.as_tensor(library.JAKSTAT_TRUE_PARAMS * np.exp(
        0.2 * rng.standard_normal((64, 6))), device=cuda_device)
    t_eval = torch.linspace(0.0, 60.0, 12, dtype=F64, device=cuda_device)
    cfg = (SolverConfig(rtol=1e-3, atol=1e-6, max_steps=128,
                        linear_solver="pallas", mixed_precision=True)
           if mixed else
           SolverConfig(rtol=1e-6, atol=1e-9, max_steps=512,
                        linear_solver="pallas", sens_precision="f32"))

    def run():
        return model.simulate_sensitivities(ps, (0.0, 60.0), t_eval,
                                            config=cfg, device=cuda_device)

    trace.reset()
    got = run()
    torch.cuda.synchronize()
    trips = trace.counters()["bdf.trips"]
    assert _fold_counts() == (trips, 0)
    _twin_only(monkeypatch)
    ref = run()
    _same_bits((got.ys, got.sens), (ref.ys, ref.sens))
