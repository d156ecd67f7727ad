"""The port's jvp-derived sensitivities and the four small library models
against the JAX reference.

``make_sens_rhs``/``make_sens_rhs_dir`` column by column, the models'
callables, the golden SciPy fixtures through ``simulate_sensitivities``
with the reference's own bounds, the stepper's counters at B=1, and the
``Project`` objective of MM-3 (``sens_mode='params'``) and JAK-STAT
(``'theta'``), whose columns now come from ``sens/forward.py``. Inputs are
made with numpy from a seed and handed to both packages.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import cli as jcli
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.project import Project as JProject
from tpusysbio.sens import make_sens_rhs as jmake_sens_rhs
from tpusysbio.sens import make_sens_rhs_dir as jmake_sens_rhs_dir
from tpusysbio_torch import SolverConfig, cli, convert
from tpusysbio_torch.model import library
from tpusysbio_torch.project import Project
from tpusysbio_torch.sens import make_sens_rhs, make_sens_rhs_dir
from tpusysbio_torch.solvers import STATUS_DONE, STATUS_MAX_STEPS

torch.set_num_threads(1)

MODELS = {
    "mm3": (jlibrary.michaelis_menten, library.michaelis_menten,
            library.MM_TRUE_PARAMS),
    "lotka": (jlibrary.lotka_volterra, library.lotka_volterra,
              library.LV_TRUE_PARAMS),
    "repressilator": (jlibrary.repressilator, library.repressilator,
                      library.REPRESSILATOR_TRUE_PARAMS),
    "jakstat": (jlibrary.jak_stat, library.jak_stat,
                library.JAKSTAT_TRUE_PARAMS),
}
NAMES = sorted(MODELS)
B = 5


def _models(name):
    jbuild, build, p_true = MODELS[name]
    return jbuild(), build(device="cpu"), p_true


def _inputs(name, m_dirs=3, seed=0):
    """Random members around the model's operating point: t (B,), y (B, n),
    p (B, m), S (B, n, m), C (B, m, G), Sd (B, n, G)."""
    jm, tm, p_true = _models(name)
    rng = np.random.default_rng(seed)
    n, m = tm.n_states, tm.n_params
    t = rng.uniform(0.5, 20.0, B)
    y = rng.uniform(0.05, 1.5, (B, n))
    p = p_true[None] * np.exp(rng.normal(scale=0.2, size=(B, m)))
    S = rng.standard_normal((B, n, m))
    C = rng.standard_normal((B, m, m_dirs))
    Sd = rng.standard_normal((B, n, m_dirs))
    return jm, tm, (t, y, p, S, C, Sd)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / np.max(np.abs(np.asarray(b))))


@functools.partial(jax.jit, static_argnums=0)
def _ref_cols(jm, t, y, p, S, C, Sd):
    full = jax.vmap(lambda tt, yy, pp, ss: jmake_sens_rhs(jm.rhs, pp)(
        tt, yy, ss))(t, y, p, S)
    red = jax.vmap(lambda tt, yy, pp, ss, cc: jmake_sens_rhs_dir(
        jm.rhs, pp, cc)(tt, yy, ss))(t, y, p, Sd, C)
    return full, red


@pytest.mark.parametrize("name", NAMES)
def test_sens_rhs_matches_reference(name):
    """Full and reduced jvp columns: f64 within 1e-12, f32 within 1e-5."""
    jm, tm, arrays = _inputs(name)
    for dtype, jdt, bound in ((torch.float64, jnp.float64, 1e-12),
                              (torch.float32, jnp.float32, 1e-5)):
        t, y, p, S, C, Sd = arrays
        ref_full, ref_red = _ref_cols(
            jm, *(jnp.asarray(a, dtype=jdt) for a in (t, y)),
            jnp.asarray(p), *(jnp.asarray(a, dtype=jdt) for a in (S,)),
            jnp.asarray(C), jnp.asarray(Sd, dtype=jdt))
        tt, yt, St, Sdt = (torch.as_tensor(a, dtype=dtype)
                           for a in (t, y, S, Sd))
        pt, Ct = torch.as_tensor(p), torch.as_tensor(C)
        full = make_sens_rhs(tm.rhs, pt)(tt, yt, St)
        red = make_sens_rhs_dir(tm.rhs, pt, Ct)(tt, yt, Sdt)
        assert full.dtype == dtype and red.dtype == dtype
        ref_full, ref_red = np.asarray(ref_full), np.asarray(ref_red)
        assert _rel(full.numpy(), ref_full) <= bound, (name, dtype)
        assert _rel(red.numpy(), ref_red) <= bound, (name, dtype)


def test_jvp_columns_match_mapk_closed_form():
    """On MAPK-22 the jvp columns equal the closed-form mass-action
    ``rhs_sens``/``rhs_sens_dir``."""
    tm = library.mapk_huang_ferrell(device="cpu")
    rng = np.random.default_rng(1)
    y = torch.as_tensor(rng.uniform(0.0, 1.2, (B, 22)))
    p = torch.as_tensor(library.mapk_true_params(device="cpu").numpy()[None]
                        * np.exp(rng.normal(scale=0.3, size=(B, 30))))
    S = torch.as_tensor(rng.standard_normal((B, 22, 30)))
    C = torch.as_tensor(rng.standard_normal((B, 30, 7)))
    Sd = torch.as_tensor(rng.standard_normal((B, 22, 7)))
    t = torch.zeros(B, dtype=torch.float64)
    assert _rel(make_sens_rhs(tm.rhs, p)(t, y, S).numpy(),
                tm.rhs_sens(t, y, S, p).numpy()) <= 1e-10
    assert _rel(make_sens_rhs_dir(tm.rhs, p, C)(t, y, Sd).numpy(),
                tm.rhs_sens_dir(t, y, Sd, p, C).numpy()) <= 1e-10


@pytest.mark.parametrize("name", NAMES)
def test_model_callables_match_reference(name):
    """rhs, y0, observables, y0_sensitivity and jacobian within 1e-12."""
    jm, tm, (t, y, p, _, _, _) = _inputs(name, seed=2)
    assert (tm.n_states, tm.n_params, tm.n_obs) == (
        jm.n_states, jm.n_params, jm.n_obs)
    assert tm.param_names == jm.param_names
    assert tm.state_names == jm.state_names
    tt, yt, pt = map(torch.as_tensor, (t, y, p))
    checks = {
        "rhs": (tm.rhs(tt, yt, pt),
                jax.vmap(jm.rhs)(t, y, p)),
        "y0": (tm.y0(pt), jax.vmap(jm.y0)(p)),
        "observables": (tm.observables(yt, pt),
                        jax.vmap(jm.observables)(y, p)),
        "y0_sensitivity": (tm.y0_sensitivity(pt),
                           jax.vmap(jax.jacfwd(jm.y0))(p)),
        "jacobian": (tm.jacobian(tt, yt, pt), jax.vmap(jm.jacobian)(t, y, p)),
    }
    for what, (got, ref) in checks.items():
        ref = np.asarray(ref)
        assert got.shape == ref.shape, (name, what)
        err = np.max(np.abs(got.numpy() - ref)) / (1e-300 + np.max(
            np.abs(ref))) if np.any(ref) else np.max(np.abs(got.numpy()))
        assert err <= 1e-12, (name, what, err)
    np.testing.assert_array_equal(MODELS[name][2],
                                  getattr(jlibrary, {
                                      "mm3": "MM_TRUE_PARAMS",
                                      "lotka": "LV_TRUE_PARAMS",
                                      "repressilator":
                                          "REPRESSILATOR_TRUE_PARAMS",
                                      "jakstat": "JAKSTAT_TRUE_PARAMS"}[name]))


# --------------------------------------------------------------------------
# Golden fixtures and step counters through simulate_sensitivities
# --------------------------------------------------------------------------

GOLDEN_CFG = dict(rtol=1e-8, atol=1e-11)   # tests/test_sens.py's CFG
COUNTERS = ("status", "nsteps", "naccepted", "nrejected", "nfev", "njev",
            "nlu")


@pytest.mark.parametrize("name", NAMES)
def test_golden_sensitivities_and_counters(golden, name):
    """ys and dy/dp against the SciPy augmented-system fixture within the
    reference's bound (max error over 1e-6 + max |ref| below 1e-5), and
    every step counter equal to the reference's on the same member."""
    g = golden(name)
    jm, tm, _ = _models(name)
    res = tm.simulate_sensitivities(g["p"][None], tuple(g["t_span"]),
                                    g["t_eval"],
                                    config=SolverConfig(**GOLDEN_CFG),
                                    device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    for key in ("ys", "sens"):
        got, ref = getattr(res, key)[0].numpy(), g[key]
        err = np.max(np.abs(got - ref)) / (1e-6 + np.max(np.abs(ref)))
        assert err < 1e-5, (name, key, err)
    ref = jm.simulate_sensitivities(jnp.asarray(g["p"]), tuple(g["t_span"]),
                                    jnp.asarray(g["t_eval"]),
                                    config=JSolverConfig(**GOLDEN_CFG))
    for k in COUNTERS:
        assert int(getattr(res, k)[0]) == int(getattr(ref, k)), (name, k)
    assert _rel(res.sens[0].numpy(), ref.sens) <= 1e-7


@pytest.mark.parametrize("name", ["mm3_tight", "lotka_tight"])
def test_sens_parity_at_the_1e6_bar(golden, name):
    """tests/test_sens.py's 1e-6 bar: an rtol=1e-10 solve against the
    rtol=1e-11 fixtures, norm-scaled and floored per element."""
    g = golden(name)
    tm = (library.michaelis_menten if name.startswith("mm3")
          else library.lotka_volterra)(device="cpu")
    res = tm.simulate_sensitivities(
        g["p"][None], tuple(g["t_span"]), g["t_eval"],
        config=SolverConfig(rtol=1e-10, atol=1e-13), device="cpu")
    assert int(res.status[0]) == STATUS_DONE
    sens, ref = res.sens[0].numpy(), g["sens"]
    norm_err = np.max(np.abs(sens - ref)) / np.max(np.abs(ref))
    rel_err = np.max(np.abs(sens - ref)
                     / (np.abs(ref) + 1e-3 * np.max(np.abs(ref))))
    assert norm_err < 1e-6 and rel_err < 1e-6, (name, norm_err, rel_err)


def test_jakstat_screening_counters_match_reference():
    """JAK-STAT's RHS reads t, which the f32 screening stepper hands over
    in f32 (the Jacobian gets the f64 time): over a short horizon the
    per-member counters of the mixed-precision stepper equal the
    reference's, so no dtype slips between the packages."""
    jm, tm, p_true = _models("jakstat")
    rng = np.random.default_rng(3)
    p = p_true[None] * np.exp(rng.normal(scale=0.3, size=(1, 6)))
    kw = dict(rtol=1e-3, atol=1e-6, max_steps=128, mixed_precision=True,
              linear_solver="inv32")
    t_eval = np.linspace(1.0, 8.0, 4)
    res = tm.simulate_sensitivities(p, (0.0, 8.0), t_eval,
                                    config=SolverConfig(**kw), device="cpu")
    ref = jm.simulate_sensitivities(jnp.asarray(p[0]), (0.0, 8.0),
                                    jnp.asarray(t_eval),
                                    config=JSolverConfig(**kw))
    for k in COUNTERS:
        assert int(getattr(res, k)[0]) == int(getattr(ref, k)), k
    assert _rel(res.ys[0].numpy(), ref.ys) <= 1e-5


def test_repressilator_nonfinite_member_fails_alone():
    """A member whose Hill term goes NaN never finishes (its error norm is
    NaN, so every step is rejected until the step budget runs out); the
    others finish with the results they have in a batch without it."""
    tm = library.repressilator(device="cpu")
    p = np.tile(library.REPRESSILATOR_TRUE_PARAMS, (3, 1))
    p[1, 3] = np.nan
    t_eval = np.linspace(0.5, 4.0, 4)
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=256)
    res = tm.simulate_sensitivities(p, (0.0, 4.0), t_eval, config=cfg,
                                    device="cpu")
    alone = tm.simulate_sensitivities(p[[0, 2]], (0.0, 4.0), t_eval,
                                      config=cfg, device="cpu")
    assert res.status.tolist() == [STATUS_DONE, STATUS_MAX_STEPS,
                                   STATUS_DONE]
    for key in ("ys", "sens"):
        got = getattr(res, key)[[0, 2]].numpy()
        assert np.isfinite(got).all()
        assert _rel(got, getattr(alone, key).numpy()) <= 1e-12, key
    assert res.nsteps[[0, 2]].tolist() == alone.nsteps.tolist()


# --------------------------------------------------------------------------
# Project on models without closed-form sensitivities
# --------------------------------------------------------------------------

def _fields(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


@pytest.mark.parametrize("name,mode", [("mm3", "params"),
                                       ("jakstat", "theta")])
def test_project_matches_reference(name, mode):
    """The CLI's synthetic problem of each config, evaluated at 3 θ around
    the truth: residuals within 1e-7 and Jacobian within 1e-4 (f32
    sensitivity columns, as the configs set) relative to the reference."""
    args = argparse.Namespace(model=name, t_end={"mm3": 10.0,
                                                 "jakstat": 60.0}[name],
                              n_times=6, noise=0.02, seed=0)
    model, batch, pmap, free, theta_true = jcli._synth_problem(args)
    # the configs' tolerances and f32 columns; the 'inv' solver keeps the
    # reference's Pallas kernels (interpret mode here) out of the way
    cfg = dict(rtol=1e-6, atol=1e-9, max_steps=512, linear_solver="inv",
               sens_precision="f32")
    jproj = JProject(model=model, pmap=pmap, batch=batch,
                     config=JSolverConfig(**cfg))
    rng = np.random.default_rng(5)
    thetas = np.asarray(theta_true)[None] + rng.normal(
        scale=0.2, size=(3, len(free)))
    ref = jax.vmap(lambda th: jproj.evaluate(th, with_jac=True))(
        jnp.asarray(thetas))
    proj = Project(model=MODELS[name][1](device="cpu"),
                   pmap=convert.pmap_from_reference(_fields(pmap),
                                                    device="cpu"),
                   batch=convert.batch_from_reference(_fields(batch),
                                                      device="cpu"),
                   config=SolverConfig(**cfg))
    assert proj._theta_sens == (mode == "theta")
    ev = proj.evaluate(torch.as_tensor(thetas), with_jac=True)
    np.testing.assert_array_equal(ev.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(ev.nsteps.numpy(), np.asarray(ref.nsteps))
    assert _rel(ev.residuals.numpy(), ref.residuals) <= 1e-7
    assert _rel(ev.jacobian.numpy(), ref.jacobian) <= 1e-4
    assert cli._FREE_PARAMS[name] == jcli._FREE_PARAMS[name]
