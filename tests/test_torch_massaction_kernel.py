"""K4, the mass-action derivative kernel (``linalg/csrc/massaction.cu``),
and its dispatch in ``tpusysbio_torch/model/massaction.py``.

On the CPU: the kernel's tables, the dispatch rule (CPU tensors take the
plain twins bit for bit and count no launch), and the route of
``linalg/kernels.py``'s ``call`` that K4 and K5 (the BDF stepper's dense
fold) share: under a ``torch.func`` transform or autograd the launch gives
the value, on unwrapped tensors and into a copy of what it writes, the
twin the tangent or gradient, and ``vmap`` is refused; there each launch
is stood in for by its twin, and the CPU is taken for the card. On a card
(marker ``cuda``, skipped without one): the kernel itself against the
plain twin, MAPK-22 and the 99-species EGFR network, and what it refuses.
This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_massaction_kernel.py
"""

import numpy as np
import pytest
import torch

from tpusysbio_torch import trace
from tpusysbio_torch.linalg import kernels
from tpusysbio_torch.model import library, massaction
from tpusysbio_torch.solvers import bdf

import test_torch_dense_fold as fold_cases

EPILOGUES = massaction.EPILOGUES
BRIDGED = EPILOGUES + ("fold",)   # the kernels behind kernels.call
# (epilogue, where a non-finite value is planted): the inputs each reads
PLANTED = [(e, w) for e in EPILOGUES
           for w in ("y", "y0inf", "p", "sens", "C")
           if not (w == "sens" and e == "jac")
           and not (w == "C" and e != "sens_dir")]
NETWORKS = {
    "mapk22": lambda device: library._mapk_network(device=device),
    "egfr19": lambda device: library._egfr_network(2, device=device),
    "egfr99": lambda device: library._egfr_network(12, device=device),
}
G_DIR = 12   # directions of the reduced sensitivity RHS (the fit's θ)


def _inputs(net, B, dtype, device, seed, G=G_DIR):
    """Members of ``net``: y in [0, 1), p around 1, Sens and C normal;
    Sens has m = rx columns for 'sens' and G for 'sens_dir'."""
    rng = np.random.default_rng(seed)
    n, rx = net.n_species, net.n_reactions

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return dict(y=t(rng.random((B, n))),
                p=t(np.exp(0.5 * rng.standard_normal((B, rx)))),
                sens=t(rng.standard_normal((B, n, rx))),
                sens_g=t(rng.standard_normal((B, n, G))),
                C=t(rng.standard_normal((B, rx, G))))


def _args(epilogue, x):
    """The arguments after ``t`` of ``epilogue``'s function: ``(y, p)``,
    ``(y, Sens, p)`` or ``(y, Sens, p, C)``."""
    if epilogue == "jac":
        return x["y"], x["p"]
    if epilogue == "sens":
        return x["y"], x["sens"], x["p"]
    return x["y"], x["sens_g"], x["p"], x["C"]


def _call(fns, epilogue, x):
    return dict(zip(EPILOGUES, fns))[epilogue](None, *_args(epilogue, x))


def _unwrapped(*xs):
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return not any(v is not None and wrapped(v) for v in xs)


def _stand_in(launched):
    """A stand-in for ``MassActionNetwork._launch`` on the CPU: it handles
    its inputs as the launch does (contiguous copies, their data
    pointers, an output it allocates) and fills the output from the plain
    twin, with no graph."""

    def launch(self, epilogue, y, *xs):
        launched.append(epilogue)
        assert _unwrapped(y, *xs)
        args = [v.to(y.dtype).contiguous() for v in (y, *xs)]
        assert all(v.data_ptr() for v in args)
        twin = dict(zip(EPILOGUES, _plain(self)))[epilogue]
        with torch.no_grad():
            ref = twin(None, *args)
        out = torch.empty(ref.shape, dtype=y.dtype)
        assert out.data_ptr()
        return out.copy_(ref)

    return launch


def _fold_stand_in(launched):
    """A stand-in for ``bdf._fold_launch`` on the CPU: it writes the plain
    twin's value into the accumulator it is given, in place, as K5 does."""

    def launch(ys_acc, D, *rest):
        launched.append("fold")
        assert _unwrapped(*ys_acc, *D, *rest[:-1])
        with torch.no_grad():
            ref = bdf.dense_fold_plain(ys_acc, D, *rest)
        return tuple(acc.copy_(r) for acc, r in zip(ys_acc, ref))

    return launch


def _bridged(monkeypatch, kernel, launched):
    """``kernel``'s dispatched function and plain twin over flat inputs,
    and those inputs, with the CPU taken for the card and the launch
    stood in for: a K4 epilogue on EGFR-19, or K5 on the split parts of
    ``tests/test_torch_dense_fold.py``'s case (member 1 meets an
    infinity of D in a zeroed weight), dense output in f32."""
    monkeypatch.setattr(kernels, "_on_card", lambda x: True)
    if kernel == "fold":
        monkeypatch.setattr(bdf, "_fold_launch", _fold_stand_in(launched))
        x = fold_cases._case("split", "shared", "cpu")
        xs = (*x["ys_acc"], *x["D"], *(x[k] for k in (
            "t_eval", "t_old", "t_hi", "t_new", "h_new", "order_new",
            "accept", "running", "too_small")))

        def flat(fn):
            return lambda *v: fn(v[:2], v[2:4], *v[4:], dense_f32=True)

        return flat(bdf.dense_fold), flat(bdf.dense_fold_plain), xs
    monkeypatch.setattr(massaction.MassActionNetwork, "_launch",
                        _stand_in(launched))
    net = NETWORKS["egfr19"]("cpu")
    x = _inputs(net, 3, torch.float64, "cpu", 3)
    fn = dict(zip(EPILOGUES, _dispatched(net)))[kernel]
    twin = dict(zip(EPILOGUES, _plain(net)))[kernel]
    return (lambda *v: fn(None, *v), lambda *v: twin(None, *v),
            _args(kernel, x))


def _parts(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _same_bits(got, ref):
    """Equal parts, bit for bit (NaN included)."""
    got, ref = _parts(got), _parts(ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.detach(), b.detach()
        if a.is_floating_point():
            bits = torch.int64 if a.dtype == torch.float64 else torch.int32
            a, b = a.view(bits), b.view(bits)
        assert torch.equal(a, b)


def _plain_uses(kernel):
    return trace.counters().get(
        "bdf.fold.plain" if kernel == "fold" else "massaction.plain", 0)


def _dispatched(net):
    return net.jac(), net.sens_rhs(), net.sens_rhs_dir()


def _plain(net):
    return net.jac_plain(), net.sens_rhs_plain(), net.sens_rhs_dir_plain()


def _launches():
    counts = trace.counters()
    return {k: counts.get("massaction." + k, 0)
            for k in EPILOGUES + ("plain",)}


def _sections(words):
    n, rx, nnz_r, nnz_s = (int(v) for v in words[:4])
    sizes = [("rptr", rx + 1), ("rent", nnz_r), ("cptr", n + 1),
             ("cj", nnz_r), ("ce", nnz_r), ("sptr", n + 1), ("sj", nnz_s),
             ("sv", nnz_s), ("qptr", rx + 1), ("qk", nnz_s), ("qv", nnz_s)]
    out, at = dict(n=n, rx=rx), 4
    for name, size in sizes:
        out[name] = [int(v) for v in words[at:at + size]]
        at += size
    assert at == len(words)
    return out


def _chain(n_species):
    """A first-order chain S0 -> S1 -> ... with one more reaction than
    species: too large for one member's tiles in a block of the card."""
    b = massaction.NetworkBuilder()
    for i in range(n_species - 1):
        b.reaction(f"r{i}", [f"S{i}"], [f"S{i + 1}"])
    b.reaction("back", [f"S{n_species - 1}", "S0"], ["S0"])
    b.reaction("out", [f"S{n_species - 1}"], [])
    return b


def _plant(x, where, seed):
    """Put a non-finite value into the members' inputs: member 1 gets it in
    ``where`` ('y', 'y0inf': a zero and an inf in one reaction, 'p',
    'sens', 'C'); members 0 and 2 stay as they were."""
    x = {k: v.clone() for k, v in x.items()}
    rng = np.random.default_rng(seed)
    bad = [float("nan"), float("inf"), -float("inf")][seed % 3]
    n = x["y"].shape[1]
    if where == "y":
        x["y"][1, rng.integers(n)] = bad
    elif where == "y0inf":
        x["y"][1, 0] = 0.0
        x["y"][1, 1] = float("inf")
    elif where == "p":
        x["p"][1, rng.integers(x["p"].shape[1])] = bad
    elif where == "sens":
        i, c = rng.integers(n), rng.integers(x["sens_g"].shape[2])
        x["sens"][1, i, c] = bad
        x["sens_g"][1, i, c] = bad
    else:
        x["C"][1, rng.integers(x["C"].shape[1]),
               rng.integers(x["C"].shape[2])] = bad
    return x


def _close(got, ref, dtype):
    """Entries agree where the twin's are finite, to the sums' rounding
    relative to the member's largest entry."""
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    fin = torch.isfinite(ref)
    scale = torch.where(fin, ref.abs(), 0).flatten(1).amax(1)
    err = torch.where(fin, (got - ref).abs(), 0).flatten(1).amax(1)
    assert bool((err <= tol * torch.clamp(scale, min=1e-300)).all()), (
        float((err / scale).max()))


# --------------------------------------------------------------------------
# CPU tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_plan_tables_rebuild_the_network(name):
    net = NETWORKS[name]("cpu")
    words, n_words, nnz_r, nnz_s = net._plan_on(torch.device("cpu"))
    P = _sections(words.numpy())
    R = np.zeros((net.n_reactions, net.n_species), dtype=np.int64)
    for j in range(P["rx"]):
        for ent in P["rent"][P["rptr"][j]:P["rptr"][j + 1]]:
            R[j, ent >> 2] = ent & 3
    S = np.zeros((net.n_species, net.n_reactions), dtype=np.int64)
    for k in range(P["n"]):
        for q in range(P["sptr"][k], P["sptr"][k + 1]):
            S[k, P["sj"][q]] = P["sv"][q]
    S_by_col = np.zeros_like(S)
    for j in range(P["rx"]):
        for q in range(P["qptr"][j], P["qptr"][j + 1]):
            S_by_col[P["qk"][q], j] = P["qv"][q]
    np.testing.assert_array_equal(R, net.reactants.numpy())
    np.testing.assert_array_equal(S, net.stoich.numpy())
    np.testing.assert_array_equal(S_by_col, net.stoich.numpy())
    # species i's entries list, by reaction, the entries of column i
    for i in range(P["n"]):
        qs = range(P["cptr"][i], P["cptr"][i + 1])
        assert [P["cj"][q] for q in qs] == list(np.nonzero(R[:, i])[0])
        for q in qs:
            e = P["ce"][q]
            assert P["rent"][e] >> 2 == i
            assert P["rptr"][P["cj"][q]] <= e < P["rptr"][P["cj"][q] + 1]
    assert (n_words, nnz_r, nnz_s) == (len(words), np.count_nonzero(R),
                                       np.count_nonzero(S))


def test_plan_takes_any_reaction_of_order_three_or_less():
    """The kernel holds no per-reaction register table: a reaction with
    many reactant species has a plan; an order above 3 has none."""
    b = massaction.NetworkBuilder()
    b.reaction("r", [f"S{i}" for i in range(12)], ["P"])
    words = b.build(device="cpu")._plan_on(torch.device("cpu"))[0]
    assert _sections(words.numpy())["rptr"] == [0, 12]
    b = massaction.NetworkBuilder()
    b.reaction("r", ["A", "A", "A", "A"], ["B"])
    with pytest.raises(ValueError, match="order > 3"):
        b.build(device="cpu")._plan_on(torch.device("cpu"))


@pytest.mark.parametrize("name", ["mapk22", "egfr19", "egfr99", "chain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_path_on_the_cpu_is_the_twin(name, dtype):
    """On the CPU ``jac``/``sens_rhs``/``sens_rhs_dir`` are their plain
    twins bit for bit, for every network (one too large for the card's
    tiles included), and no launch of any epilogue is counted."""
    net = (_chain(300).build(device="cpu") if name == "chain"
           else NETWORKS[name]("cpu"))
    x = _inputs(net, 3 if name == "chain" else 5, dtype, "cpu", 1)
    trace.reset()
    for epilogue in EPILOGUES:
        got = _call(_dispatched(net), epilogue, x)
        ref = _call(_plain(net), epilogue, x)
        assert got.dtype == dtype
        assert torch.equal(got, ref)
    assert _launches() == dict.fromkeys(EPILOGUES + ("plain",), 0)


@pytest.mark.parametrize("kernel", BRIDGED)
def test_transforms_take_the_launch_and_the_twins_tangent(monkeypatch,
                                                          kernel):
    """Rosenbrock's time partial is a jvp in t over the augmented
    right-hand side, which slices the inputs out of a captured block: the
    launch takes the call on unwrapped tensors and the output's tangent is
    zero. A jvp in the inputs takes the value from the launch, into a
    copy of what it writes, and the tangent from the twin with every
    floating input dual, those not varied at zero: K5's D is varied and
    its times are not, so member 1 meets the infinity of D in a zeroed
    weight as NaN, where a twin with the times held fixed reads 0. vmap
    over the inputs is refused before any launch."""
    launched = []
    fn, twin, xs = _bridged(monkeypatch, kernel, launched)
    before = [v.clone() for v in xs]
    ref = twin(*xs)
    s = torch.zeros(3, dtype=torch.float64)
    trace.reset()

    def sliced(ss):
        v = [x[:] for x in xs]
        assert not _unwrapped(*v)
        return fn(*v)

    out, dt = torch.func.jvp(sliced, (s,), (torch.ones_like(s),))
    assert launched == [kernel] and _plain_uses(kernel) == 0
    assert not any(bool(d.any()) for d in _parts(dt))
    _same_bits(out, ref)
    # vary y (K4) or the parts of D (K5)
    at = [0] if kernel != "fold" else [2, 3]
    tangents = [torch.randn_like(xs[i]) for i in at]

    def varied(fn):
        def f(*v):
            w = list(xs)
            for i, vi in zip(at, v):
                w[i] = vi
            return fn(*w)
        return f

    out, tangent = torch.func.jvp(varied(fn), tuple(xs[i] for i in at),
                                  tuple(tangents))
    assert launched == [kernel] * 2 and _plain_uses(kernel) == 1
    dual = [i for i, x in enumerate(xs) if x.is_floating_point()]
    ref_tangent = torch.func.jvp(
        lambda *v: twin(*(v[dual.index(i)] if i in dual else x
                          for i, x in enumerate(xs))),
        tuple(xs[i] for i in dual),
        tuple(tangents[at.index(i)] if i in at else torch.zeros_like(xs[i])
              for i in dual))[1]
    _same_bits(out, ref)
    _same_bits(tangent, ref_tangent)
    _same_bits(xs, before)
    if kernel == "fold":
        held = torch.func.jvp(varied(twin), tuple(xs[i] for i in at),
                              tuple(tangents))[1]
        assert bool(torch.isnan(tangent[1][1]).any())
        assert not bool(torch.isnan(held[1][1]).any())
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(lambda v: fn(v, *xs[1:]))(xs[0][None])
    assert launched == [kernel] * 2


@pytest.mark.parametrize("kernel", BRIDGED)
def test_autograd_takes_the_value_of_the_launch_and_the_twins_gradient(
        monkeypatch, kernel):
    """Where autograd has to differentiate a call, the launch gives the
    value, into a copy of what it writes, and the plain twin's graph the
    gradient (one use counted as ``massaction.plain`` or
    ``bdf.fold.plain``). K4's inputs all need a gradient; of K5's only the
    first part of D, so its second part has none."""
    launched = []
    fn, twin, xs = _bridged(monkeypatch, kernel, launched)
    grad_at = [2] if kernel == "fold" else range(len(xs))
    args = [x.clone().requires_grad_(i in grad_at)
            for i, x in enumerate(xs)]
    leaves = [args[i] for i in grad_at]
    trace.reset()
    got = fn(*args)
    assert launched == [kernel]
    assert all(o.requires_grad for o in _parts(got))
    ref = twin(*args)
    _same_bits(got, ref)
    _same_bits(args, xs)
    ws = [torch.randn_like(o) for o in _parts(got)]
    g_got = torch.autograd.grad(
        sum((o * w).sum() for o, w in zip(_parts(got), ws)), leaves)
    g_ref = torch.autograd.grad(
        sum((o * w).sum() for o, w in zip(_parts(ref), ws)), leaves)
    _same_bits(g_got, g_ref)
    assert _plain_uses(kernel) == 1


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(net, epilogue, x, chunk=1024):
    """The dispatched call and the plain twin on the card (the twin in
    chunks of members: at 10,000 members of the 99-species network its
    (B, 146, 99) scans would take ~10 GB), with the launches the
    dispatched call counted."""
    before = _launches()
    got = _call(_dispatched(net), epilogue, x)
    torch.cuda.synchronize()
    after = _launches()
    B = x["y"].shape[0]
    ref = torch.cat([
        _call(_plain(net), epilogue,
              {k: v[b:b + chunk] for k, v in x.items()})
        for b in range(0, B, chunk)])
    return got, ref, {k: after[k] - before[k] for k in after}


def _one(epilogue):
    return {**dict.fromkeys(EPILOGUES + ("plain",), 0), epilogue: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mapk22", "egfr99"])
@pytest.mark.parametrize("B", [1, 256, 10_000])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_twin(cuda_device, name, B, epilogue, dtype):
    net = NETWORKS[name](cuda_device)
    x = _inputs(net, B, dtype, cuda_device, B)
    got, ref, launched = _on_card(net, epilogue, x)
    assert got.dtype == dtype and got.shape == ref.shape
    assert launched == _one(epilogue)
    assert bool(torch.isfinite(got).all())
    _close(got.cpu(), ref.cpu(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256, 10_000])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_exact_at_zero_concentrations(cuda_device, B, epilogue,
                                             dtype):
    net = NETWORKS["mapk22"](cuda_device)
    x = _inputs(net, B, dtype, cuda_device, 5)
    x["y"][:, ::2] = 0.0
    x["y"][0] = 0.0
    got, ref, launched = _on_card(net, epilogue, x)
    assert launched == _one(epilogue)
    assert bool(torch.isfinite(got).all())
    _close(got.cpu(), ref.cpu(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", [("mapk22", 3), ("mapk22", 256),
                                    ("mapk22", 10_000), ("egfr99", 3),
                                    ("egfr99", 256)])
@pytest.mark.parametrize("epilogue,where", PLANTED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_nonfinite_where_the_twin_is(cuda_device, name, B, epilogue,
                                            where, dtype):
    net = NETWORKS[name](cuda_device)
    for seed in range(3):
        x = _plant(_inputs(net, B, dtype, cuda_device, 6), where, seed)
        got, ref, launched = _on_card(net, epilogue, x)
        assert launched == _one(epilogue)
        assert not bool(torch.isfinite(ref[1]).all())
        assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
        _close(got.cpu(), ref.cpu(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_kernel_gradient_is_the_twins(cuda_device, epilogue):
    """Under autograd the launch gives the value and the twin's graph the
    gradient."""
    net = NETWORKS["mapk22"](cuda_device)
    x = _inputs(net, 64, torch.float64, cuda_device, 8)
    leaves = [v.clone().requires_grad_(True) for v in _args(epilogue, x)]
    trace.reset()
    got = dict(zip(EPILOGUES, _dispatched(net)))[epilogue](None, *leaves)
    ref = dict(zip(EPILOGUES, _plain(net)))[epilogue](None, *leaves)
    w = torch.randn_like(got)
    g_got = torch.autograd.grad((got * w).sum(), leaves)
    g_ref = torch.autograd.grad((ref * w).sum(), leaves)
    assert _launches() == {**_one(epilogue), "plain": 1}
    _close(got.detach().cpu(), ref.detach().cpu(), torch.float64)
    for a, b in zip(g_got, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    """A card tensor never takes the twin: a network whose member tiles do
    not fit a block, a half-precision state and vmap over the inputs
    raise."""
    net = _chain(3000).build(device=cuda_device)
    x = _inputs(net, 2, torch.float64, cuda_device, 9, G=40)
    trace.reset()
    for epilogue in ("jac", "sens_dir"):
        with pytest.raises(RuntimeError, match="do not fit"):
            _call(_dispatched(net), epilogue, x)
    small = NETWORKS["mapk22"](cuda_device)
    x = _inputs(small, 4, torch.float16, cuda_device, 9)
    with pytest.raises(TypeError, match="float32 or float64"):
        _call(_dispatched(small), "jac", x)
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(lambda yy: small.jac()(None, yy, x["p"][:1].float())
                        )(x["y"].float()[:, None])
    assert _launches() == dict.fromkeys(EPILOGUES + ("plain",), 0)


@pytest.mark.cuda
def test_kernel_launches_are_counted(cuda_device):
    """One count a launch, by epilogue: under autograd (its gradient counts
    ``massaction.plain``) and in Rosenbrock's jvp in t over the
    sensitivity RHS of a sliced block, where the output's tangent is
    zero."""
    net = NETWORKS["mapk22"](cuda_device)
    x = _inputs(net, 64, torch.float32, cuda_device, 7)
    trace.reset()
    for k, epilogue in enumerate(EPILOGUES):
        for _ in range(k + 1):
            _call(_dispatched(net), epilogue, x)
    y = x["y"].clone().requires_grad_(True)
    J = net.jac()(None, y, x["p"])
    assert J.requires_grad
    J.sum().backward()
    Y = torch.cat([x["y"][..., None], x["sens"]], dim=-1)
    t = torch.zeros(64, dtype=torch.float32, device=cuda_device)
    _, dt = torch.func.jvp(
        lambda tt: net.sens_rhs()(tt, Y[..., 0], Y[..., 1:], x["p"]), (t,),
        (torch.ones_like(t),))
    assert not bool(dt.any())
    torch.cuda.synchronize()
    assert _launches() == {"jac": 2, "sens": 3, "sens_dir": 3, "plain": 1}
