"""K6, the BDF stepper's step controller (``linalg/csrc/step_control.cu``),
and its dispatch in ``tpusysbio_torch/solvers/bdf.py``.

On the CPU: ``bdf.step_control`` takes the plain twin there and counts no
launch; the twin against SciPy's step logic done one member at a time
(the error test, the order and step choice, the accept update of D and
``change_D``), on every part layout the stepper builds; the gate (a member
that is not running or whose step underflowed keeps the rows it began the
attempt with); the route of ``linalg/kernels.py``'s ``call`` with the
launch stood in for (autograd and ``torch.func.jvp`` take the twin's
derivatives, ``vmap`` is refused); and what the launch refuses. On a card
(marker ``cuda``, skipped without one): the kernel against the twin on
every trip's inputs of whole solves (split parts, the f32 screen, one f64
part, no sensitivities, error control over all columns, JAK-STAT, the
99-species EGFR network), whole solves against the twin's, one launch a
trip, and the derivatives. This file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_step_control.py
"""

import math

import numpy as np
import pytest
import torch

from tpusysbio_torch import SolverConfig, trace
from tpusysbio_torch.linalg import kernels
from tpusysbio_torch.model import library
from tpusysbio_torch.solvers import bdf

F32, F64 = torch.float32, torch.float64
B, N, M = 8, 3, 2
RTOL, ATOL = 1e-3, 1e-6
OPTS = dict(rtol=RTOL, atol=ATOL, safety=0.9, min_factor=0.2,
            max_factor=10.0)
# per member: order, size of d (its error norm is ~ec·size/RTOL), converged,
# current_jac, n_equal_steps, running, too_small. Members 0-5 run: an
# accepted step that adapts, one that does not, an error-test rejection, a
# Newton failure with a stale and with a fresh Jacobian, a NaN in d (a
# rejection); member 6 is not running, member 7's step underflowed.
MEMBERS = [(3, 2e-5, 1, 0, 5, 1, 0), (1, 1e-4, 1, 1, 0, 1, 0),
           (2, 5e-2, 1, 0, 4, 1, 0), (5, 1e-4, 0, 0, 7, 1, 0),
           (4, 1e-4, 0, 1, 2, 1, 0), (2, 1e-4, 1, 0, 3, 1, 0),
           (3, 1e-4, 1, 0, 6, 0, 0), (1, 1e-4, 1, 0, 6, 1, 1)]
# (control dtype, parts (columns, dtype)) of every layout bdf_solve builds
LAYOUTS = {"split": (F64, ((1, F64), (M, F32))),
           "mixed": (F64, ((1 + M, F32),)),
           "plain": (F64, ((1 + M, F64),)),
           "state": (F64, ((1, F64),)),
           "single": (F32, ((1 + M, F32),))}
CASES = [(layout, full) for layout in LAYOUTS for full in (False, True)
         if not (full and layout in ("split", "state"))]


def _case(layout, device="cpu", seed=0):
    """step_control's inputs (a dict) for the members of ``MEMBERS``: D
    with rows that shrink with their index as a stepper's do, and D_old
    equal to D but for members 6 and 7, whose rows were rescaled."""
    ct, parts = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    order, size, conv, cur, neq, run, small = (np.array(c)
                                               for c in zip(*MEMBERS))
    y = 1.0 + rng.random((B, N))
    D, D_old, d = [], [], []
    for k, dt in parts:
        Dp = rng.standard_normal((B, bdf.D_ROWS, N, k))
        Dp *= 1e-2 ** np.arange(bdf.D_ROWS)[None, :, None, None]
        Dp[:, 0, :, 0] = y
        dp = size[:, None, None] * rng.standard_normal((B, N, k))
        dp[5, 1, 0] = np.nan
        Do = Dp.copy()
        Do[6:] *= 3.0
        for lst, a in ((D, Dp), (D_old, Do), (d, dp)):
            lst.append(torch.as_tensor(a).to(dt).to(device))
    Y0 = D[0][:, 0] + d[0]
    _, _, error_const = bdf._ndf_constants(ct, device)

    def t(a, dtype):
        return torch.as_tensor(a).to(dtype).to(device)

    h = t(0.1 + 0.01 * np.arange(B), ct)
    t0 = t(np.linspace(1.0, 2.0, B), ct)
    return dict(d=tuple(d), D=tuple(D), D_old=tuple(D_old), Y0=Y0,
                order=t(order, torch.int64), n_iter=t(1 + np.arange(B) % 4,
                                                      torch.int32),
                n_equal_steps=t(neq, torch.int32),
                converged=t(conv, torch.bool), current_jac=t(cur, torch.bool),
                h_abs=h, t=t0, t_new=t0 + h, running=t(run, torch.bool),
                too_small=t(small, torch.bool), error_const=error_const)


def _flat(x):
    return (*x["d"], *x["D"], *x["D_old"], *(x[k] for k in (
        "Y0", "order", "n_iter", "n_equal_steps", "converged", "current_jac",
        "h_abs", "t", "t_new", "running", "too_small", "error_const")))


def _unflat(fn, k, full):
    return lambda *v: fn(v[:k], v[k:2 * k], v[2 * k:3 * k], *v[3 * k:],
                         **OPTS, sens_error_control=full)


def _call(fn, x, full):
    return _unflat(fn, len(x["D"]), full)(*_flat(x))


def _bits(a):
    if not a.is_floating_point():
        return a
    return a.view(torch.int64 if a.dtype == F64 else torch.int32)


def _same_bits(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))


# --------------------------------------------------------------------------
# SciPy's step logic, one member at a time, in numpy f64
# --------------------------------------------------------------------------

def _R(order, factor):
    """SciPy bdf.py compute_R."""
    i = np.arange(1, order + 1)[:, None]
    j = np.arange(1, order + 1)
    m = np.zeros((order + 1, order + 1))
    m[1:, 1:] = (i - 1 - factor * j) / i
    m[0] = 1
    return np.cumprod(m, axis=0)


def _scipy_member(x, b, full):
    """SciPy's end of a step attempt (bdf.py _step_impl after the Newton
    solve) for member ``b``: the decisions, the step and the new D."""
    o = int(x["order"][b])
    conv, cur = bool(x["converged"][b]), bool(x["current_jac"][b])
    n_iter = int(x["n_iter"][b])
    ec = x["error_const"].double().numpy()
    Y = x["Y0"][b].double().numpy()
    d0 = x["d"][0][b].double().numpy()
    D0 = x["D"][0][b].double().numpy()
    cols = slice(None) if full else slice(0, 1)
    scale = ATOL + RTOL * np.abs(Y[:, cols])

    def norm(err):
        return float(np.sqrt(np.mean((err[:, cols] / scale) ** 2)))

    safety = 0.9 * (2 * 4 + 1) / (2 * 4 + n_iter)
    err = norm(ec[o] * d0)
    if not np.isfinite(err):
        err = 2.0
    accept = conv and err <= 1.0
    reject = conv and not accept
    n_equal = int(x["n_equal_steps"][b]) + 1
    adapt = accept and n_equal >= o + 1
    order_new, factor = o, 1.0
    if not conv:
        factor = 0.5 if cur else 1.0
    elif reject:
        factor = max(safety * err ** (-1 / (o + 1)), 0.2)
    elif adapt:
        norms = [norm(ec[o - 1] * (D0[o] + d0)) if o > 1 else np.inf, err,
                 norm(ec[o + 1] * (d0 - D0[o + 1])) if o < 5 else np.inf]
        f = [max(e, np.finfo(float).eps) ** (-1 / (o + k))
             if np.isfinite(e) else 0.0 for k, e in enumerate(norms)]
        order_new = min(max(o + int(np.argmax(f)) - 1, 1), 5)
        factor = min(safety * max(f), 10.0)
    D_new = []
    for Dp, dp in zip(x["D"], x["d"]):
        Dm, dm = Dp[b].double().numpy().copy(), dp[b].double().numpy()
        if accept:
            Dm[o + 2] = dm - Dm[o + 1]
            Dm[o + 1] = dm
            for i in reversed(range(o + 1)):
                Dm[i] += Dm[i + 1]
        if factor != 1.0:
            RU = _R(order_new, factor) @ _R(order_new, 1.0)
            Dm[:order_new + 1] = np.einsum(
                "ji,j...->i...", RU, Dm[:order_new + 1])
        # the port adds v d to every row, v = 0 where no d is appended: a
        # NaN of d reaches every row there
        D_new.append(Dm + 0.0 * dm[None])
    return dict(accept=accept, reject=reject, order_new=order_new,
                factor=factor, n_equal_new=n_equal if accept and not adapt
                else 0, lu_valid_new=conv and not adapt,
                current_jac_new=True if not conv else (
                    False if accept else cur), D_new=D_new)


@pytest.mark.parametrize("layout,full", CASES)
def test_plain_path_is_scipys_step(layout, full):
    """On the CPU ``step_control`` is the twin, with no launch counted; its
    decisions are SciPy's, its step SciPy's to the rounding of the factor,
    its D SciPy's update to the rounding of the parts' dtypes, and the
    members that are not running or underflowed keep ``D_old`` bit for
    bit."""
    x = _case(layout)
    trace.reset()
    out = _call(bdf.step_control, x, full)
    assert trace.counters() == {}
    _same_bits(out, _call(bdf.step_control_plain, x, full))
    k = len(x["D"])
    D_new = out[:k]
    accept, reject, order_new, h_new, t_next, n_equal_new, lu_valid, \
        cur_jac = out[k:]
    for b in range(B):
        ref = _scipy_member(x, b, full)
        assert bool(accept[b]) == ref["accept"], b
        assert bool(reject[b]) == ref["reject"], b
        assert int(order_new[b]) == ref["order_new"], b
        assert int(n_equal_new[b]) == ref["n_equal_new"], b
        assert bool(lu_valid[b]) == ref["lu_valid_new"], b
        assert bool(cur_jac[b]) == ref["current_jac_new"], b
        h = float(x["h_abs"][b])
        # the norms are taken in part 0's dtype
        f32_norms = x["D"][0].dtype == F32
        tol = 1e-6 if f32_norms else 1e-13
        assert math.isclose(float(h_new[b]), h * ref["factor"], rel_tol=tol)
        assert float(t_next[b]) == float(
            x["t_new"][b] if ref["accept"] else x["t"][b])
        gated = not bool(x["running"][b]) or bool(x["too_small"][b])
        for p, (Dn, Dr) in enumerate(zip(D_new, ref["D_new"])):
            if gated:
                _same_bits((Dn[b],), (x["D_old"][p][b],))
                continue
            tol = 1e-5 if Dn.dtype == F32 or f32_norms else 1e-12
            got = Dn[b].double().numpy()
            fin = np.isfinite(Dr)
            assert (np.isfinite(got) == fin).all(), (b, p)
            scale = np.abs(np.where(fin, Dr, 0)).reshape(bdf.D_ROWS, -1).max(1)
            err = np.abs(np.where(fin, got - Dr, 0)).reshape(
                bdf.D_ROWS, -1).max(1)
            assert (err <= tol * np.maximum(scale, 1e-300)).all(), (b, p)
    # every branch is taken: an adaptation, a plain accept, the rejections
    # and both Newton failures
    assert bool(accept[0]) and not bool(lu_valid[0])
    assert bool(accept[1]) and int(n_equal_new[1]) == 1
    assert bool(reject[2]) and bool(reject[5])
    assert not bool(lu_valid[3]) and not bool(lu_valid[4])
    assert not bool(torch.isfinite(D_new[0][5]).all())


@pytest.mark.parametrize("fault", ["half", "three_parts", "f64_part",
                                   "rows", "time_dtype"])
def test_launch_refuses_what_it_has_no_code_for(fault):
    """K6's checks come before anything touches a card, so they run on the
    CPU: a part in another dtype, a third part, an f64 part under an f32
    control, D with other than 8 rows, or times of another dtype than the
    step raise, where the plain twin would quietly run instead."""
    x = _case("single" if fault == "f64_part" else "split")
    if fault == "half":
        for key in ("D", "D_old", "d"):
            x[key] = (x[key][0], x[key][1].half())
    elif fault == "three_parts":
        for key in ("D", "D_old", "d"):
            x[key] += x[key][1:]
    elif fault == "f64_part":
        for key in ("D", "D_old", "d"):
            x[key] = (x[key][0].double(),)
        x["Y0"] = x["Y0"].double()
    elif fault == "rows":
        for key in ("D", "D_old"):
            x[key] = tuple(Dp[:, :6] for Dp in x[key])
    else:
        x["t_new"] = x["t_new"].float()
    trace.reset()
    with pytest.raises(ValueError if fault in ("three_parts", "rows")
                       else TypeError, match="step_control: K6 takes"):
        _call(bdf._ctrl_launch, x, False)
    assert trace.counters() == {}


def _members(layout, batch, seed):
    """step_control's inputs for ``batch`` members drawn at random: orders
    1-5, corrections from far below to well above the tolerance, one
    member in five whose Newton loop failed, counts that adapt or not."""
    ct, parts = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    size = RTOL * 10.0 ** rng.uniform(-3.0, 1.2, (batch, 1, 1))
    D, d = [], []
    for k, dt in parts:
        Dp = rng.standard_normal((batch, bdf.D_ROWS, N, k))
        Dp *= 1e-2 ** np.arange(bdf.D_ROWS)[None, :, None, None]
        Dp[:, 0] = 1.0 + rng.random((batch, N, k))
        D.append(torch.as_tensor(Dp).to(dt))
        d.append(torch.as_tensor(
            size * rng.standard_normal((batch, N, k))).to(dt))
    _, _, error_const = bdf._ndf_constants(ct, "cpu")

    def t(a, dtype):
        return torch.as_tensor(a).to(dtype)

    h = t(10.0 ** rng.uniform(-3.0, 0.5, batch), ct)
    t0 = t(rng.uniform(0.0, 90.0, batch), ct)
    return dict(d=tuple(d), D=tuple(D), D_old=tuple(D),
                Y0=D[0][:, 0] + d[0],
                order=t(rng.integers(1, 6, batch), torch.int64),
                n_iter=t(rng.integers(1, 5, batch), torch.int32),
                n_equal_steps=t(rng.integers(0, 7, batch), torch.int32),
                converged=t(rng.random(batch) < 0.8, torch.bool),
                current_jac=t(rng.random(batch) < 0.3, torch.bool),
                h_abs=h, t=t0, t_new=t0 + h,
                running=torch.ones(batch, dtype=torch.bool),
                too_small=torch.zeros(batch, dtype=torch.bool),
                error_const=error_const)


@pytest.mark.parametrize("layout", ["split", "single"])
@pytest.mark.parametrize("batch", [1, 7, 256, 1024])
def test_ordered_products_are_the_cpus_matmul(monkeypatch, layout, batch):
    """The twin's three small products (P = R(h) R(1), 6 x 6; W = T M,
    8 x 8; v = T u, 8 x 1), summed in order by ``_ordered_bmm``, are the
    CPU's ``torch.matmul`` bit for bit on the operands the controller
    forms, so the CPU's steps are what they were with ``matmul``: the twin
    gives the same bits with either, in every output."""
    x = _members(layout, batch, seed=batch)
    ordered = _call(bdf.step_control_plain, x, False)
    accept, reject, order_new = ordered[len(x["D"]):][:3]
    # the rescaling runs in most members: a rejection, a halving or an
    # adaptation to another order
    assert bool(accept.any()) or batch == 1
    assert batch < 256 or (bool(reject.any())
                           and bool((order_new != x["order"]).any()))
    monkeypatch.setattr(bdf, "_ordered_bmm", torch.matmul)
    _same_bits(ordered, _call(bdf.step_control_plain, x, False))
    dt = LAYOUTS[layout][0]
    h = torch.as_tensor(np.random.default_rng(batch).uniform(
        0.2, 10.0, batch)).to(dt)
    Rf, R1 = bdf._compute_R(h), bdf._compute_R(torch.ones_like(h))
    monkeypatch.undo()
    _same_bits((bdf._ordered_bmm(Rf, R1),), (torch.matmul(Rf, R1),))


def _stand_in(launched):
    """A stand-in for ``bdf._ctrl_launch`` on the CPU: the twin's value, in
    new tensors, on inputs no transform wraps, with no graph."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor

    def launch(d, D, D_old, *rest, **opts):
        launched.append("ctrl")
        assert not any(wrapped(v) for v in (*d, *D, *D_old, *rest))
        with torch.no_grad():
            out = bdf.step_control_plain(d, D, D_old, *rest, **opts)
        return tuple(o.clone() for o in out)

    return launch


def _bridged(monkeypatch, launched):
    monkeypatch.setattr(kernels, "_on_card", lambda x: True)
    monkeypatch.setattr(bdf, "_ctrl_launch", _stand_in(launched))
    x = _case("split")
    return (_unflat(bdf.step_control, 2, False),
            _unflat(bdf.step_control_plain, 2, False), _flat(x))


def test_tangent_takes_the_twin(monkeypatch):
    """Inside ``torch.func.jvp`` the launch gives the value and the twin
    the tangent, with every floating input dual (D_old and the step's
    scalars held at zero), counted once as ``bdf.ctrl.plain``; ``vmap``
    over the inputs is refused before any launch."""
    launched = []
    fn, twin, xs = _bridged(monkeypatch, launched)
    at = [0, 1, 2, 3]    # the parts of d and D
    tangents = [torch.randn_like(xs[i]) for i in at]

    def varied(f):
        def g(*v):
            w = list(xs)
            for i, vi in zip(at, v):
                w[i] = vi
            return f(*w)
        return g

    trace.reset()
    out, tangent = torch.func.jvp(varied(fn), tuple(xs[i] for i in at),
                                  tuple(tangents))
    assert launched == ["ctrl"]
    assert trace.counters() == {"bdf.ctrl.plain": 1}
    ref, ref_tangent = torch.func.jvp(varied(twin), tuple(xs[i] for i in at),
                                      tuple(tangents))
    _same_bits(out, ref)
    for a, b in zip(tangent[:2], ref_tangent[:2]):
        _same_bits((a,), (b,))
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(lambda v: fn(v, *xs[1:]))(xs[0][None])
    assert launched == ["ctrl"]


def test_gradient_takes_the_twin(monkeypatch):
    """Where autograd has to differentiate the call, the launch gives the
    value and the twin's graph the gradient of D_new with respect to D,
    one plain use counted."""
    launched = []
    fn, twin, xs = _bridged(monkeypatch, launched)
    args = [x.clone().requires_grad_(i in (2, 3)) for i, x in enumerate(xs)]
    trace.reset()
    got = fn(*args)
    assert launched == ["ctrl"]
    ref = twin(*args)
    _same_bits(got, ref)
    ws = [torch.randn_like(o) for o in got[:2]]
    leaves = args[2:4]
    g_got = torch.autograd.grad(sum((o * w).sum()
                                    for o, w in zip(got[:2], ws)), leaves)
    g_ref = torch.autograd.grad(sum((o * w).sum()
                                    for o, w in zip(ref[:2], ws)), leaves)
    _same_bits(g_got, g_ref)
    assert trace.counters() == {"bdf.ctrl.plain": 1}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _ctrl_counts():
    c = trace.counters()
    return c.get("bdf.ctrl", 0), c.get("bdf.ctrl.plain", 0)


def _ulps_apart(got, ref):
    """|got - ref| in units of ref's spacing (inf where one is not finite
    and they differ)."""
    spacing = (torch.nextafter(ref.abs(), torch.full_like(ref, math.inf))
               - ref.abs())
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    return torch.where(same, 0.0, (got - ref).abs() / spacing)


class _Compare:
    """Stands in for ``bdf.step_control`` in a solve: K6 and the twin on
    each trip's inputs, the worst departures kept, K6's outputs used."""

    def __init__(self):
        self.real = bdf.step_control
        self.trips = 0
        self.decisions = 0     # trips whose decisions differ
        self.h_ulps = 0.0
        self.D_ulps = 0.0
        self.gated = 0         # trips whose gated members moved

    def __call__(self, d, D, D_old, *rest, **opts):
        got = self.real(d, D, D_old, *rest, **opts)
        ref = bdf.step_control_plain(d, D, D_old, *rest, **opts)
        k = len(D)
        self.trips += 1
        # accept, reject, order_new, n_equal_new, lu_valid, current_jac
        if not all(torch.equal(got[k + i], ref[k + i])
                   for i in (0, 1, 2, 5, 6, 7)):
            self.decisions += 1
        self.h_ulps = max(self.h_ulps, float(torch.max(
            _ulps_apart(got[k + 3], ref[k + 3]))),
            float(torch.max(_ulps_apart(got[k + 4], ref[k + 4]))))
        running, too_small = rest[9], rest[10]
        gate = running & ~too_small
        for Dn, Dr, Do in zip(got[:k], ref[:k], D_old):
            if not torch.equal(_bits(Dn[~gate]), _bits(Do[~gate])):
                self.gated += 1
            a, r = Dn[gate].flatten(2), Dr[gate].flatten(2)
            fin = torch.isfinite(r)
            if not torch.equal(fin, torch.isfinite(a)):
                self.D_ulps = math.inf
                continue
            top = torch.where(fin, r.abs(), 0).amax(2, keepdim=True)
            spacing = torch.nextafter(top, torch.full_like(top, math.inf)) \
                - top
            err = torch.where(fin, (a - r).abs(), 0)
            if err.numel():
                self.D_ulps = max(self.D_ulps, float((err / spacing).max()))
        return got


def _mapk(B_, device, seed=0):
    model = library.mapk_huang_ferrell(device=device)
    k = library.mapk_true_params(device=device)
    rng = np.random.default_rng(seed)
    ps = k * torch.exp(torch.as_tensor(
        0.1 * rng.standard_normal((B_, k.shape[0])), device=device))
    return model, ps


def _run(case, device):
    """One solve of ``case`` on the card."""
    sens = dict(rtol=1e-6, atol=1e-9, max_steps=1024, linear_solver="pallas")
    if case == "jakstat":
        model = library.jak_stat(device=device)
        rng = np.random.default_rng(4)
        ps = torch.as_tensor(library.JAKSTAT_TRUE_PARAMS * np.exp(
            0.2 * rng.standard_normal((64, 6))), device=device)
        t_end, n_t = 60.0, 12
        cfg = SolverConfig(**sens, sens_precision="f32")
    elif case == "egfr99":
        model = library.egfr_like(12, device=device)
        rng = np.random.default_rng(0)
        p = library.egfr_true_params(12, device=device)
        ps = p * torch.exp(torch.as_tensor(
            0.1 * rng.standard_normal((16, p.shape[0])), device=device))
        t_end, n_t = 10.0, 9
        cfg = SolverConfig(**sens, sens_precision="f32")
    else:
        model, ps = _mapk(256, device)
        t_end, n_t = 100.0, 41
        cfg = dict(
            split=dict(sens_precision="f32", dense_f32=True),
            mixed=dict(rtol=1e-3, atol=1e-6, max_steps=256,
                       mixed_precision=True),
            f64={}, m0={}, sec=dict(sens_error_control=True))[case]
        cfg = SolverConfig(**{**sens, **cfg})
    t_eval = torch.linspace(0.0, t_end, n_t, dtype=F64, device=device)
    if case == "m0":
        return model.simulate(ps, (0.0, t_end), t_eval, config=cfg,
                              device=device)
    return model.simulate_sensitivities(ps, (0.0, t_end), t_eval, config=cfg,
                                        device=device)


SOLVES = ["split", "mixed", "f64", "m0", "sec", "jakstat", "egfr99"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SOLVES)
def test_kernel_is_the_twin_on_every_trip(cuda_device, monkeypatch, case):
    """Every trip's controller inputs of a whole solve through K6 and the
    twin: the same decisions, the step and time within 4 ulps, D_new
    within 4 ulps of each row's largest entry in its part's dtype, the
    gated members' rows bit for bit; one launch a trip, no twin."""
    cmp = _Compare()
    monkeypatch.setattr(bdf, "step_control", cmp)
    trace.reset()
    res = _run(case, cuda_device)
    torch.cuda.synchronize()
    trips = trace.counters()["bdf.trips"]
    assert _ctrl_counts() == (trips, 0)
    assert cmp.trips == trips > 0
    assert bool((res.status == 1).all())
    assert cmp.decisions == 0
    assert cmp.h_ulps <= 4.0, cmp.h_ulps
    assert cmp.D_ulps <= 4.0, cmp.D_ulps
    assert cmp.gated == 0


def _scaled_err(got, ref, axes):
    """The benchmark's ``traj_err`` measure: the largest error over each
    species' own size."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    scale = np.max(np.abs(ref), axis=axes, keepdims=True)
    scale = np.maximum(scale, 1e-12 * np.max(np.abs(ref)) + 1e-300)
    return float(np.max(np.abs(got - ref) / scale))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split", "mixed"])
def test_solves_equal_the_twins(cuda_device, monkeypatch, case):
    """The 256-member MAPK-22 solve through K6 and through the twin: the
    same steps in all members but at most one, and trajectories and
    sensitivities within the cell's traj_err limit (2e-3)."""
    trace.reset()
    got = _run(case, cuda_device)
    torch.cuda.synchronize()
    assert _ctrl_counts() == (trace.counters()["bdf.trips"], 0)
    monkeypatch.setattr(bdf, "step_control", bdf.step_control_plain)
    trace.reset()
    ref = _run(case, cuda_device)
    assert _ctrl_counts() == (0, 0)
    assert int((got.nsteps != ref.nsteps).sum()) <= 1
    err = max(_scaled_err(got.ys, ref.ys, (1,)),
              _scaled_err(got.sens, ref.sens, (1, 3)))
    assert err <= 2e-3, err


@pytest.mark.cuda
def test_kernel_derivatives_are_the_twins(cuda_device):
    """On the card, under autograd and inside ``torch.func.jvp``, K6 gives
    the value and the twin the derivatives, each counted as
    ``bdf.ctrl.plain``."""
    x = _case("split", cuda_device)
    fn = _unflat(bdf.step_control, 2, False)
    twin = _unflat(bdf.step_control_plain, 2, False)
    xs = _flat(x)
    args = [v.clone().requires_grad_(i == 2) for i, v in enumerate(xs)]
    trace.reset()
    got = fn(*args)
    torch.cuda.synchronize()
    assert _ctrl_counts() == (1, 0)
    ref = twin(*args)
    w = torch.randn_like(got[0])
    g, = torch.autograd.grad((got[0] * w).sum(), args[2])
    g_ref, = torch.autograd.grad((ref[0] * w).sum(), args[2])
    assert _ctrl_counts() == (1, 1)
    _same_bits((g,), (g_ref,))
    tangent = torch.randn_like(xs[2])

    def vary(f):
        return lambda D0: f(*xs[:2], D0, *xs[3:])

    _, t_got = torch.func.jvp(vary(fn), (xs[2],), (tangent,))
    _, t_ref = torch.func.jvp(vary(twin), (xs[2],), (tangent,))
    assert _ctrl_counts() == (2, 2)
    _same_bits(t_got[:2], t_ref[:2])
