"""The port's PEtab import (``tpusysbio_torch/petab_import.py``) against
the JAX package's ``from_petab`` on ``tests/test_petab.py``'s problems
(the MM-3 two-condition problem with a prior, and the widened one with an
estimated scaling placeholder, a log10 observable, noise placeholders and
a species override).

Tolerances: ``theta0``/``lb``/``ub``/``x_ids``/``obs_labels`` and the
batch equal; residuals at ``theta0`` within 1e-9 of the reference
``Project``'s (both at rtol 1e-7); 2 TRF iterations from ``theta0``
within 1e-9 relative of the reference's ``trf_fit``; the problem files read by
``config.parse_yaml`` equal to ``yaml.safe_load``'s; the same
``PetabError``s, and a non-numeric condition override raises
``PetabError`` where the reference raises a bare ``ValueError``.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_petab as ref
from tpusysbio.config import FitConfig as JFitConfig
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.optim.trf import trf_fit as jtrf_fit
from tpusysbio.petab_import import PetabError as JPetabError
from tpusysbio.petab_import import from_petab as jfrom_petab
from tpusysbio_torch import FitConfig, SolverConfig
from tpusysbio_torch.config import parse_yaml
from tpusysbio_torch.optim import trf_fit
from tpusysbio_torch.petab_import import PetabError, from_petab

torch.set_num_threads(1)

TOL = dict(rtol=1e-7, atol=1e-9)


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """Problem files written once: the plain problem (with and without the
    prior) and the widened one."""
    out = {}
    for name, make in (("prior", lambda d: ref._make_problem(d)),
                       ("plain", lambda d: ref._make_problem(
                           d, prior_line=False)),
                       ("widened", ref._make_widened_problem)):
        out[name] = make(tmp_path_factory.mktemp(name))
    return out


@pytest.mark.parametrize("name", ["prior", "widened"])
def test_problem_matches_reference(problems, name):
    path = problems[name]
    prob = from_petab(path, config=SolverConfig(**TOL), device="cpu")
    jprob = jfrom_petab(path, config=JSolverConfig(**TOL))
    assert prob.x_ids == jprob.x_ids
    assert prob.obs_labels == jprob.obs_labels
    for field in ("theta0", "lb", "ub"):
        np.testing.assert_array_equal(getattr(prob, field),
                                      getattr(jprob, field))
    assert prob.model.param_names == jprob.model.param_names
    assert prob.model.n_params == jprob.model.n_params
    assert (prob.priors is None) == (jprob.priors is None)
    for field in ("t_eval", "values", "sigmas", "mask", "m_obs", "m_is_ss"):
        np.testing.assert_array_equal(
            getattr(prob.batch, field).numpy(),
            np.asarray(getattr(jprob.batch, field)), err_msg=field)
    np.testing.assert_array_equal(prob.pmap.fixed.numpy(),
                                  np.asarray(jprob.pmap.fixed))
    r = prob.project.residuals(torch.as_tensor(prob.theta0)).numpy()
    rj = np.asarray(jax.jit(jprob.project.residuals)(
        jnp.asarray(jprob.theta0)))
    assert r.shape == rj.shape == (prob.project.n_residuals,)
    np.testing.assert_allclose(r, rj, rtol=0, atol=1e-9)


def test_problem_files_parse_as_safe_load(problems):
    for path in problems.values():
        with open(path) as fh:
            text = fh.read()
        assert parse_yaml(text) == yaml.safe_load(text)


def test_short_bounded_fit_and_startpoints(problems):
    """2 TRF iterations from θ0 in the problem's box against the JAX
    package's ``trf_fit`` on its ``from_petab`` project from the same
    start: equal status and counters, θ, cost and cost trace within 1e-9
    relative; then 4 ``sample_startpoints`` inside the box."""
    prob = from_petab(problems["plain"], config=SolverConfig(**TOL),
                      device="cpu")
    jprob = jfrom_petab(problems["plain"], config=JSolverConfig(**TOL))
    lb, ub = torch.as_tensor(prob.lb), torch.as_tensor(prob.ub)
    theta0 = torch.as_tensor(prob.theta0)[None]
    fit = trf_fit(prob.project.residuals, prob.project.residuals_and_jacobian,
                  theta0, lb, ub, FitConfig(max_iter=2))
    ref_fit = jax.tree.map(np.asarray, jax.jit(lambda th: jtrf_fit(
        jprob.project.residuals, jprob.project.residuals_and_jacobian, th,
        jnp.asarray(jprob.lb), jnp.asarray(jprob.ub),
        JFitConfig(max_iter=2)))(jnp.asarray(jprob.theta0)))
    for f in ("status", "n_iter", "nfev", "njev"):
        assert int(getattr(fit, f)[0]) == int(getattr(ref_fit, f)), f
    for f in ("theta", "cost", "cost_trace"):
        np.testing.assert_allclose(getattr(fit, f).numpy()[0],
                                   getattr(ref_fit, f), rtol=1e-9, atol=0,
                                   err_msg=f)
    assert float(fit.cost[0]) < float(fit.cost_trace[0, 0])
    assert bool(((fit.theta > lb) & (fit.theta < ub)).all())
    starts = prob.sample_startpoints(torch.Generator().manual_seed(1), 4)
    assert starts.shape == (4, 3)
    assert bool(((starts >= lb) & (starts <= ub)).all())


def _edit(path, old, new):
    text = open(path).read()
    assert old in text, old
    open(path, "w").write(text.replace(old, new))
    return text


def _cases():
    return {
        "unknown symbol": ("observables.tsv", "S + C", "S + nope", None),
        "laplace noise": (
            "observables.tsv", "observableFormula\tnoiseFormula",
            "observableFormula\tnoiseDistribution\tnoiseFormula", [
                ("P\t0.01", "P\tlaplace\t0.01"),
                ("S + C\t0.01", "S + C\tnormal\t0.01")]),
        "estimated override": ("conditions.tsv", "E0", "k1", None),
        "parameter-id override": ("conditions.tsv", "c_hi\t0.6",
                                  "c_hi\tkm1", None),
        "estimated noise": ("observables.tsv", "P\t0.01", "P\tsigma_p", [
            ("PARAMS", "sigma_p\tlog10\t0.001\t1\t0.01\t1\t\t\n")]),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_validation_errors(problems, case):
    path = problems["prior"]
    base = os.path.dirname(path)
    table, old, new, more = _cases()[case]
    saved = {}
    tpath = os.path.join(base, table)
    saved[tpath] = _edit(tpath, old, new)
    for a, b in more or ():
        if a == "PARAMS":
            ppath = os.path.join(base, "parameters.tsv")
            saved[ppath] = open(ppath).read()
            open(ppath, "w").write(saved[ppath] + b)
        else:
            _edit(tpath, a, b)
    try:
        with pytest.raises(PetabError):
            from_petab(path, device="cpu")
        # the reference raises its PetabError, or for a parameter-id
        # override a bare ValueError from float() (its fault at
        # tpusysbio/petab_import.py:381; ROADMAP Queue 3)
        want = ValueError if case == "parameter-id override" else \
            JPetabError
        with pytest.raises(want):
            jfrom_petab(path)
    finally:
        for p, text in saved.items():
            open(p, "w").write(text)


def test_non_numeric_species_override_raises_petab_error(problems):
    """The reference's :381 case: a species override that is a parameter
    id raises ``PetabError`` naming the unsupported subset."""
    path = problems["widened"]
    cpath = os.path.join(os.path.dirname(path), "conditions.tsv")
    saved = _edit(cpath, "c_b\t0.6\t0.5", "c_b\t0.6\tE0")
    try:
        with pytest.raises(PetabError, match="only numeric"):
            from_petab(path, device="cpu")
        with pytest.raises(ValueError):
            jfrom_petab(path)
    finally:
        open(cpath, "w").write(saved)


def test_widened_truth_and_validation(problems):
    """The widened problem at its truth: cost below 1e-6 as in the
    reference's test; its placeholder-count, log10 and condition-column
    errors."""
    path = problems["widened"]
    prob = from_petab(path, config=SolverConfig(rtol=1e-9, atol=1e-11),
                      device="cpu")
    theta_true = torch.log(torch.as_tensor([30.0, 10.0, 5.0,
                                            ref.SCALE_TRUE]))
    assert float(prob.project.cost(theta_true)) < 1e-6
    assert bool(prob.batch.has_y0_over)
    base = os.path.dirname(path)
    meas = os.path.join(base, "measurements.tsv")
    cond = os.path.join(base, "conditions.tsv")
    for p, old, new in (
            (meas, f"scale_p;{ref.OFFSET}", "scale_p"),
            (meas, "obs_tot\tc_a\t", "obs_tot\tc_a\t-"),
            (cond, "\tS\n", "\tcompartmentX\n")):
        saved = _edit(p, old, new)
        try:
            with pytest.raises(PetabError):
                from_petab(path, device="cpu")
        finally:
            open(p, "w").write(saved)
    assert math.isfinite(float(prob.project.cost(
        torch.as_tensor(prob.theta0))))
