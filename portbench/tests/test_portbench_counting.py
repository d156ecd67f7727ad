"""The work counts behind the rooflines and the MFU, against hand counts
at small n and B."""

import pytest

from portbench import trace
from portbench.metrics import _counting as cnt
from portbench.metrics import _layers

# A + B -> C (k1), C -> A + B (k2): n = 3, m = 2
SPEC = {"species": ["A", "B", "C"],
        "reactions": [["bind", ["A", "B"], ["C"]],
                      ["unbind", ["C"], ["A", "B"]]],
        "rates": [1.0, 2.0], "y0": [1.0, 1.0, 0.0], "observables": ["C"]}


def call(**kw):
    c = dict(wall=1.0, B=4, n=3, K=2, mixed=False, split=True,
             linear_solver="pallas", initial_fev=3, max_nsteps=10,
             nsteps=40, naccepted=36, nrejected=4, nfev=4 * 3 + 50, njev=8,
             nlu=12)
    c.update(kw)
    return c


def test_shapes_by_hand():
    s = cnt.Shapes(SPEC)
    assert (s.n, s.m) == (3, 2)
    assert s.nnz_S == 6
    # dA/dt, dB/dt, dC/dt each depend on A, B (bind) and C (unbind)
    assert s.nnz_J == 9
    # monomials and rates: (2 + 1) + (1 + 1) products, 2 flops a nonzero
    assert s.rhs_flops == 5 + 12
    # (reactant, species changed) pairs: bind 2 x 3, unbind 1 x 3
    assert s.jac_flops == 2 * (6 + 3)


def test_lu_work_by_hand():
    assert cnt.lu_blocks(22) == (22,)
    assert cnt.lu_blocks(99) == (64, 35)
    flops, nbytes = cnt.lu_work(call(n=3, nlu=12))
    assert flops == pytest.approx(12 * 2 / 3 * 27)
    assert nbytes == 12 * 8 * 9
    flops, nbytes = cnt.lu_work(call(n=99, nlu=2))
    assert flops == pytest.approx(2 * 2 / 3 * (64 ** 3 + 35 ** 3))
    assert nbytes == 2 * 8 * (64 ** 2 + 35 ** 2)


def test_state_solves_count_newton_iterations():
    c = call(n=3, B=4, nfev=62, initial_fev=3)
    assert cnt.newton_iterations(c) == 50
    assert cnt.state_solve_work(c) == (50 * 2 * 9, 50 * (4 * 9 + 16 * 3))
    assert cnt.state_solve_work(call(mixed=True)) == (0.0, 0.0)


def test_least_seconds_is_the_larger_bound():
    assert cnt.least_seconds(67e12, 0.0, cnt.F32_FLOPS) == pytest.approx(1)
    assert cnt.least_seconds(0.0, 3.35e12, cnt.F32_FLOPS) == pytest.approx(1)


def test_step_flops_by_hand():
    s = cnt.Shapes(SPEC)
    c = call(n=3, K=2, nfev=62, njev=8, nlu=12)
    f64, f32 = cnt.step_flops(c, s)
    iters = 50
    assert f64 == pytest.approx(62 * 17 + 8 * 18 + iters * 2 * 9)
    assert f32 == pytest.approx(62 * (2 * 9 * 2 + 6) + 12 * 2 / 3 * 27
                                + iters * 2 * 9 * 2)
    f64m, f32m = cnt.step_flops(dict(c, mixed=True), s)
    assert f64m == 0 and f32m == pytest.approx(f64 + f32)


def test_newton_iterations_leave_out_each_members_first_evaluations():
    """Each member's counter starts at its initial evaluations (3 without
    a given first step): a member that took no step adds no iteration."""
    assert cnt.newton_iterations(call(B=4, nfev=12)) == 0
    assert cnt.newton_iterations(call(B=8, nfev=24 + 10)) == 10


class FakeTrace:
    def __init__(self, calls, by_kernel, cfg):
        self.cfg = cfg
        self.units = [dict(profiled=True, calls=calls, wall=2.0, spans=[],
                           counts={}, info={}),
                      dict(profiled=False, calls=calls, wall=2.0, spans=[],
                           counts={}, info={})]
        self.profile = {"by_kernel": by_kernel, "busy_s": 0.5,
                        "window_s": 2.0}

    measured = trace.Recorder.measured
    profiled = trace.Recorder.profiled
    kernel_seconds = trace.Recorder.kernel_seconds


def test_readers_on_a_hand_trace():
    c = call(n=3, nlu=12, nfev=62)
    t = FakeTrace([c], {"void gj_inverse_f32_kernel<32, 1>(...)": 1e-6,
                        "refine_solve_rows_kernel<32>": 2e-6,
                        "other": 5.0}, {"network": SPEC})
    lu_least = cnt.least_seconds(*cnt.lu_work(c), cnt.F32_FLOPS)
    assert _layers.lu_roofline(t) == pytest.approx(100 * lu_least / 1e-6)
    sv_least = cnt.least_seconds(*cnt.state_solve_work(c), cnt.F64_FLOPS)
    assert _layers.solve_roofline(t) == pytest.approx(100 * sv_least / 2e-6)
    assert _layers.idle_pct(t) == pytest.approx(75.0)
    assert _layers.ms_per_trip(t) == pytest.approx(1e3 * 1.0 / 10)
    assert _layers.reject_pct(t) == pytest.approx(10.0)
    # K = 2 directions over m = 2 rate constants: all of them
    f64, f32 = cnt.step_flops(c, cnt.Shapes(SPEC))
    want = 100 * (f64 / cnt.F64_FLOPS + f32 / cnt.F32_FLOPS) / 2.0
    assert _layers.step_mfu(t) == pytest.approx(want)


def test_readers_find_nothing_without_their_kernels():
    t = FakeTrace([call()], {"other": 1.0}, {"network": SPEC})
    assert _layers.lu_roofline(t) is None
    assert _layers.solve_roofline(t) is None
