"""The port's EGFR-scale path (99 species, 146 rate constants, 11 free)
against the JAX reference and the golden fixture.

This is the problem of ``bench/egfr_bench.py``: ``egfr_like()`` with the
receptor module and the layer-0 kinase and phosphatase constants free, BDF
with the 11 θ-direction sensitivity columns, rtol=1e-6, atol=1e-9,
``linear_solver='pallas'``, ``sens_precision='f32'``, ``dense_f32``. At
n = 99 the Newton matrix is inverted by one level of block-Schur
elimination (a 64 block and a 35 block through the Gauss-Jordan kernel) and
the f64 state solve takes the plain refinement rounds. Both packages run on
the CPU: the reference with its Pallas kernels in interpret mode, the port
with its kernels' plain versions. Every input is made with numpy from a
seed and handed to both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import data as jdata
from tpusysbio import project as jproject
from tpusysbio import solvers as jsolvers
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio_torch import SolverConfig, convert, trace
from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
from tpusysbio_torch.linalg import gpu_lu
from tpusysbio_torch.model import library
from tpusysbio_torch.project import ParameterMap, Project
from tpusysbio_torch.solvers import STATUS_DONE, bdf_solve

torch.set_num_threads(1)

FREE_PREFIXES = ("L+Rec", "LR+A0_0", "LR+A0_1", "P0+A0_1")
EGFR_KW = dict(rtol=1e-6, atol=1e-9, max_steps=768, linear_solver="pallas",
               sens_precision="f32", dense_f32=True)
COUNTERS = ("nsteps", "naccepted", "nrejected", "nfev", "njev", "nlu")


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _free(names):
    return [n for n in names if n.startswith(FREE_PREFIXES)]


# --------------------------------------------------------------------------
# (a) the model's fields
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,n,m", [(12, 99, 146), (2, 19, 26)])
def test_egfr_fields_match_reference(n_layers, n, m):
    jm = jlibrary.egfr_like(n_layers)
    tm = library.egfr_like(n_layers, device="cpu")
    assert (tm.n_states, tm.n_params, tm.n_obs) == (n, m, n_layers)
    assert (jm.n_states, jm.n_params, jm.n_obs) == (n, m, n_layers)
    assert tm.name == jm.name
    assert tm.param_names == jm.param_names
    assert tm.state_names == jm.state_names
    assert len(_free(tm.param_names)) == 11
    jnet = jlibrary._egfr_network(n_layers)[0]
    net = library._egfr_network(n_layers, device="cpu")
    carried = convert.network_from_numpy(
        jnet.species, jnet.reaction_names, np.asarray(jnet.reactants),
        np.asarray(jnet.stoich), device="cpu")
    assert torch.equal(net.reactants, carried.reactants)
    assert torch.equal(net.stoich, carried.stoich)


@pytest.mark.parametrize("n_layers,seed", [(12, 0), (12, 3), (2, 0)])
def test_egfr_true_params_and_y0_equal_reference_to_the_bit(n_layers, seed):
    """numpy's ``default_rng(seed)`` draws the same constants in both
    packages: 0 ulp."""
    p = library.egfr_true_params(n_layers, seed, device="cpu")
    ref = jlibrary.egfr_true_params(n_layers, seed)
    assert p.dtype == torch.float64
    np.testing.assert_array_equal(p.numpy(), ref)
    tm = library.egfr_like(n_layers, device="cpu")
    jm = jlibrary.egfr_like(n_layers)
    np.testing.assert_array_equal(tm.y0(p[None])[0].numpy(),
                                  np.asarray(jm.y0(jnp.asarray(ref))))
    y = torch.as_tensor(np.arange(tm.n_states, dtype=np.float64))[None]
    np.testing.assert_array_equal(
        tm.observables(y, p[None])[0].numpy(),
        np.asarray(jm.observables(jnp.asarray(y[0].numpy()),
                                  jnp.asarray(ref))))
    s0 = tm.y0_sensitivity(p[None])
    assert tuple(s0.shape) == (1, tm.n_states, tm.n_params)
    assert not bool(s0.any())


# --------------------------------------------------------------------------
# (b) RHS, Jacobian and direction sensitivities at full width
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width_inputs():
    """4 random (y, p, S, C) around the 99-species operating point."""
    rng = np.random.default_rng(0)
    y = rng.uniform(0.0, 1.0, size=(4, 99))
    y[0, :7] = 0.0   # exact zeros: 0^0 = 1 and the exclusive product
    p = jlibrary.egfr_true_params()[None] * np.exp(
        rng.normal(scale=0.3, size=(4, 146)))
    S = rng.standard_normal((4, 99, 11))
    C = rng.standard_normal((4, 146, 11))
    return y, p, S, C


def test_egfr_rhs_jac_sens_dir_match_reference(full_width_inputs):
    """One evaluation, no integration, f64 on both sides: 1e-12 relative
    (sums over up to 146 reactions in another order)."""
    y, p, S, C = full_width_inputs
    jm = jlibrary.egfr_like()
    tm = library.egfr_like(device="cpu")
    t = jnp.zeros(())
    ref_f = jax.vmap(lambda yy, pp: jm.rhs(t, yy, pp))(y, p)
    ref_j = jax.vmap(lambda yy, pp: jm.rhs_jac(t, yy, pp))(y, p)
    ref_s = jax.vmap(lambda yy, ss, pp, cc: jm.rhs_sens_dir(
        t, yy, ss, pp, cc))(y, S, p, C)
    tt = torch.zeros(4, dtype=torch.float64)
    yt, pt, St, Ct = map(torch.as_tensor, (y, p, S, C))
    got_f = tm.rhs(tt, yt, pt).numpy()
    got_j = tm.rhs_jac(tt, yt, pt).numpy()
    got_s = tm.rhs_sens_dir(tt, yt, St, pt, Ct).numpy()
    assert got_f.shape == (4, 99) and got_j.shape == (4, 99, 99)
    assert got_s.shape == (4, 99, 11)
    assert _rel(got_f, np.asarray(ref_f)) <= 1e-12
    assert _rel(got_j, np.asarray(ref_j)) <= 1e-12
    assert _rel(got_s, np.asarray(ref_s)) <= 1e-12


def test_egfr_sens_dir_is_the_full_sensitivity_rhs_projected(
        full_width_inputs):
    """``rhs_sens_dir`` with S = S_full C equals ``rhs_sens(S_full) C``:
    the 11-column block is the 146-column one along the directions."""
    y, p, _, C = full_width_inputs
    tm = library.egfr_like(device="cpu")
    rng = np.random.default_rng(1)
    S_full = torch.as_tensor(rng.standard_normal((4, 99, 146)))
    tt = torch.zeros(4, dtype=torch.float64)
    yt, pt, Ct = map(torch.as_tensor, (y, p, C))
    full = tm.rhs_sens(tt, yt, S_full, pt) @ Ct
    red = tm.rhs_sens_dir(tt, yt, S_full @ Ct, pt, Ct)
    assert _rel(red.numpy(), full.numpy()) <= 1e-12


# --------------------------------------------------------------------------
# (c) the stepper with 11 direction columns
# --------------------------------------------------------------------------

def _direction_problem(n_layers, B):
    """θ-mode inputs as ``Project`` forms them: per member the rate
    constants p (the true set spread log-normally, seed 0) and the chain
    C = dp/dθ, whose column g holds p_j at the g-th free constant j."""
    jm = jlibrary.egfr_like(n_layers)
    rng = np.random.default_rng(0)
    p = jlibrary.egfr_true_params(n_layers)[None] * np.exp(
        rng.normal(scale=0.1, size=(B, jm.n_params)))
    free = [jm.param_names.index(n) for n in _free(jm.param_names)]
    C = np.zeros((B, jm.n_params, len(free)))
    for g, j in enumerate(free):
        C[:, j, g] = p[:, j]
    return p, C


def _reference_directions(n_layers, p, C, t_span, t_eval):
    jm = jlibrary.egfr_like(n_layers)
    cfg = JSolverConfig(**EGFR_KW)

    def integrate(pp, cc):
        res = jsolvers.bdf_solve(
            lambda t, y: jm.rhs(t, y, pp.astype(y.dtype)), t_span,
            jm.y0(pp), jnp.asarray(t_eval), config=cfg,
            sens_rhs=lambda t, y, S: jm.rhs_sens_dir(t, y, S, pp, cc),
            s0=jnp.zeros((jm.n_states, cc.shape[-1]), pp.dtype),
            jac=lambda t, y: jm.rhs_jac(t, y, pp.astype(y.dtype)))
        return res._replace(order_hist=None, t_final=None, y_final=None)

    out = jax.jit(jax.vmap(integrate))(jnp.asarray(p), jnp.asarray(C))
    return jax.tree.map(np.asarray, out)


def _port_directions(n_layers, p, C, t_span, t_eval):
    tm = library.egfr_like(n_layers, device="cpu")
    pt, Ct = torch.as_tensor(p), torch.as_tensor(C)
    return bdf_solve(
        lambda t, y: tm.rhs(t, y, pt.to(y.dtype)), t_span, tm.y0(pt),
        torch.as_tensor(t_eval), config=SolverConfig(**EGFR_KW),
        sens_rhs=lambda t, y, S: tm.rhs_sens_dir(t, y, S, pt, Ct),
        s0=torch.zeros((p.shape[0], tm.n_states, C.shape[-1]),
                       dtype=torch.float64),
        jac=lambda t, y: tm.rhs_jac(t, y, pt.to(y.dtype)))


# (layers, t_end, points): the 19-species model over the whole horizon of
# the fit problem (n <= 64: one Gauss-Jordan launch and the fused refined
# solve per factorization), and the 99-species model over a short one
# (about 15 steps; n > 64: block-Schur and the plain refinement rounds)
DIRECTION_RUNS = {"19 species, whole horizon": (2, 10.0, 9),
                  "99 species, short horizon": (12, 2e-3, 3)}


@pytest.fixture(scope="module", params=sorted(DIRECTION_RUNS))
def direction_run(request):
    n_layers, t_end, n_t = DIRECTION_RUNS[request.param]
    p, C = _direction_problem(n_layers, 2)
    t_eval = np.linspace(t_end / n_t, t_end, n_t)
    span = (0.0, t_end)
    trace.reset()
    got = _port_directions(n_layers, p, C, span, t_eval)
    assert not any(k.startswith("gpu_lu.") for k in trace.counters())
    return n_layers, got, _reference_directions(n_layers, p, C, span, t_eval)


def test_direction_columns_all_members_done(direction_run):
    n_layers, got, ref = direction_run
    assert got.status.tolist() == [STATUS_DONE] * 2
    assert ref.status.tolist() == [STATUS_DONE] * 2
    if n_layers == 12:
        assert 8 <= int(got.nsteps.max()) <= 40


@pytest.mark.parametrize("counter", COUNTERS)
def test_direction_columns_step_counters_identical(direction_run, counter):
    """Same algorithm, CPU f64 state column on both sides: the same step
    sequence, factorizations and Jacobian refreshes."""
    _, got, ref = direction_run
    np.testing.assert_array_equal(getattr(got, counter).numpy(),
                                  getattr(ref, counter))


def test_direction_columns_trajectories_agree(direction_run):
    """f64 state column: 1e-7 relative (the Newton iterates stop at the
    same trip on both sides, so what differs is the rounding of the f32
    inverse and of the refinement rounds)."""
    _, got, ref = direction_run
    assert got.ys.shape == ref.ys.shape
    assert _rel(got.ys.numpy(), ref.ys) <= 1e-7


def test_direction_columns_sensitivities_agree(direction_run):
    """The 11 sensitivity columns live in f32 on both sides; the port
    updates its difference arrays elementwise where the reference takes a
    dot for parts above 1,024 elements (99 x 11 = 1,089): another f32
    summation order. 1e-4 relative."""
    n_layers, got, ref = direction_run
    n = 3 + 8 * n_layers
    assert got.sens.shape == ref.sens.shape == (2, got.ys.shape[1], n, 11)
    assert _rel(got.sens.numpy(), ref.sens) <= 1e-4


# --------------------------------------------------------------------------
# (d) Project.evaluate on the fit problem cut to 3 time points
# --------------------------------------------------------------------------

def _fit_problem(meas_cls, exp_cls, from_experiments, create, names, t,
                 data, sigma, p_true, **kw):
    meas = tuple(meas_cls(obs_index=i, times=t, values=data[:, i],
                          sigmas=np.full(len(t), sigma))
                 for i in range(data.shape[1]))
    batch = from_experiments([exp_cls("egf", meas)], **kw)
    free = _free(names)
    fixed = {n: p_true[names.index(n)] for n in names if n not in free}
    pmap = create(names, 1, shared=tuple(free), fixed=fixed, **kw)
    theta_true = pmap.pack({n: p_true[names.index(n)] for n in free})
    return batch, pmap, theta_true


@pytest.fixture(scope="module")
def cut_problem():
    """``bench/egfr_bench.py::build_problem`` with the first 3 of its 9
    measurement times. The data are simulated once, by the port, and both
    packages get the same numpy arrays."""
    tm = library.egfr_like(device="cpu")
    jm = jlibrary.egfr_like()
    p_true = jlibrary.egfr_true_params()
    t = np.linspace(0.5, 10.0, 9)[:3]
    sim = tm.simulate(p_true[None], (0.0, float(t[-1])), t,
                      config=SolverConfig(rtol=1e-8, atol=1e-11,
                                          max_steps=4096), device="cpu")
    assert int(sim.status[0]) == STATUS_DONE
    obs = tm.observables(sim.ys[0], torch.as_tensor(p_true)[None].expand(
        3, -1)).numpy()
    rng = np.random.default_rng(0)
    sigma = 0.02 * float(np.max(obs))
    data = obs + rng.normal(scale=sigma, size=obs.shape)
    names = tm.param_names
    batch, pmap, theta_true = _fit_problem(
        Measurement, Experiment, ExperimentBatch.from_experiments,
        ParameterMap.create, names, t, data, sigma, p_true, device="cpu")
    proj = Project(model=tm, pmap=pmap, batch=batch,
                   config=SolverConfig(**EGFR_KW))
    jbatch, jpmap, jtheta = _fit_problem(
        jdata.Measurement, jdata.Experiment,
        jdata.ExperimentBatch.from_experiments,
        jproject.ParameterMap.create, names, t, data, sigma, p_true)
    jproj = jproject.Project(model=jm, pmap=jpmap, batch=jbatch,
                             config=JSolverConfig(**EGFR_KW))
    np.testing.assert_array_equal(theta_true.numpy(), np.asarray(jtheta))
    thetas = theta_true.numpy()[None] + np.random.default_rng(0).normal(
        scale=0.1, size=(2, 11))
    ref = jax.jit(jax.vmap(lambda th: jproj.evaluate(th, with_jac=True)))(
        jnp.asarray(thetas))
    got = proj.evaluate(torch.as_tensor(thetas), with_jac=True)
    return proj, jproj, got, jax.tree.map(np.asarray, ref), theta_true


def test_cut_problem_is_the_11_parameter_theta_mode_one(cut_problem):
    proj, jproj, got, _, _ = cut_problem
    assert proj.n_theta == jproj.n_theta == 11
    assert proj.n_residuals == jproj.n_residuals == 36
    assert proj._theta_sens and jproj._theta_sens
    assert int((proj.pmap.map_idx < 0).sum()) == 135   # fixed constants
    for f in dataclasses.fields(proj.pmap):
        v = getattr(proj.pmap, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(getattr(jproj.pmap, f.name)),
                err_msg=f.name)
    assert tuple(got.jacobian.shape) == (2, 36, 11)


def test_cut_problem_residuals_status_and_steps_agree(cut_problem):
    """f64 state column carried through the observables and 1/σ: 1e-7
    relative; identical statuses and step counts."""
    _, _, got, ref, _ = cut_problem
    assert got.status.tolist() == [[STATUS_DONE]] * 2
    np.testing.assert_array_equal(got.status.numpy(), ref.status)
    np.testing.assert_array_equal(got.nsteps.numpy(), ref.nsteps)
    assert _rel(got.residuals.numpy(), ref.residuals) <= 1e-7
    np.testing.assert_allclose(got.cost.numpy(), ref.cost, rtol=1e-7)


def test_cut_problem_jacobian_agrees(cut_problem):
    """The sensitivity columns live in f32 on both sides: 1e-4 relative."""
    _, _, got, ref, _ = cut_problem
    assert _rel(got.jacobian.numpy(), ref.jacobian) <= 1e-4


def test_cut_problem_factorizations_go_through_block_schur(cut_problem,
                                                           monkeypatch):
    """One more short evaluation with the wrapper watched: every
    factorization of the 99 x 99 Newton matrix hands the Gauss-Jordan
    wrapper a 64 block and then a 35 block, under either layout, and the
    f64 state solve never takes the fused refined solve (n > 64)."""
    proj, theta_true = cut_problem[0], cut_problem[4]
    short = dataclasses.replace(
        proj, batch=dataclasses.replace(
            proj.batch, t_end=torch.full_like(proj.batch.t_end, 1e-3),
            t_eval=torch.full_like(proj.batch.t_eval, 1e-3)))
    sizes, refined = [], []
    real = gpu_lu.gj_inverse_f32
    monkeypatch.setattr(gpu_lu, "gj_inverse_f32",
                        lambda a: sizes.append(a.shape[-1]) or real(a))
    monkeypatch.setattr(gpu_lu, "refine_solve",
                        lambda *args: refined.append(1))
    costs = []
    for layout in ("minor", "major"):
        monkeypatch.setattr(gpu_lu, "_LAYOUT", layout)
        costs.append(short.evaluate(theta_true[None], with_jac=True).cost)
    assert sizes and len(sizes) % 4 == 0
    assert sizes == [64, 35] * (len(sizes) // 2)
    assert not refined
    assert torch.equal(costs[0], costs[1])


def test_single_theta_jacobian_of_a_single_experiment(cut_problem):
    """One θ, one experiment, several times: the flattened stepper batch
    has one member, and the observables' forward-mode derivative must get
    copies of that member's parameters, not views that share memory."""
    proj, theta_true = cut_problem[0], cut_problem[4]
    short = dataclasses.replace(
        proj, batch=dataclasses.replace(
            proj.batch, t_end=torch.full_like(proj.batch.t_end, 1e-3),
            t_eval=proj.batch.t_eval * (1e-3 / proj.batch.t_eval.max())))
    one = short.evaluate(theta_true, with_jac=True)
    assert tuple(one.residuals.shape) == (36,)
    assert tuple(one.jacobian.shape) == (36, 11)
    two = short.evaluate(theta_true[None].repeat(2, 1), with_jac=True)
    assert torch.equal(two.jacobian[1], one.jacobian)
    assert bool(one.jacobian.any())


# --------------------------------------------------------------------------
# (e) the golden trajectory through the port alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("linear_solver", ["lu", "pallas"])
def test_egfr_golden_trajectory(golden, linear_solver):
    """The bound of ``tests/test_models.py::test_egfr_golden`` (err < 1e-3
    against the SciPy fixture), with the reference's default solver kind
    and with the block-Schur path."""
    g = golden("egfr")
    tm = library.egfr_like(device="cpu")
    res = tm.simulate(g["p"][None], tuple(g["t_span"]), g["t_eval"],
                      config=SolverConfig(rtol=1e-6, atol=1e-9,
                                          max_steps=4096,
                                          linear_solver=linear_solver),
                      device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    err = np.max(np.abs(res.ys[0].numpy() - g["ys"])
                 / (1e-6 + np.max(np.abs(g["ys"]))))
    assert err < 1e-3
    assert 300 <= int(res.nsteps[0]) <= 380
