"""The port's SBML import and export (``tpusysbio_torch/model/
sbml_import.py``, ``sbml_export.py``) against the JAX package's, on every
document of ``tests/test_sbml.py``.

Tolerances: RHS within 1e-13 relative of the reference's; ``p0``, names
and lowered event records equal; the same exception types; ``to_sbml``'s
text equal character for character; the lowered-event model through the
port's ``Project`` within 1e-6 of the SciPy piecewise oracle.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_sbml as ref
from tpusysbio.model import library as jlibrary
from tpusysbio.model.massaction import NetworkBuilder as JNetworkBuilder
from tpusysbio.model import sbml_import as jsbml_import
from tpusysbio.model.sbml_export import to_sbml as jto_sbml
from tpusysbio.model.sbml_import import from_sbml as jfrom_sbml
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import NetworkBuilder, library
from tpusysbio_torch.model.sbml_export import to_sbml
from tpusysbio_torch.model.sbml_import import (SbmlError,
                                               SbmlUnsupportedError,
                                               from_sbml)

torch.set_num_threads(1)

REPRESSILATOR = os.path.join(os.path.dirname(__file__), "..", "examples",
                             "repressilator.sbml.xml")


def _rhs_pair(model, jmodel, p0, seed, n_members=4):
    """Both models' RHS at random states and parameters near ``p0``."""
    rng = np.random.default_rng(seed)
    n = model.n_states
    y = rng.uniform(0.05, 1.5, size=(n_members, n))
    p = np.asarray(p0)[None] * rng.uniform(0.5, 1.5,
                                           size=(n_members, len(p0)))
    t = rng.uniform(0.0, 3.0, size=n_members)
    got = model.rhs(torch.as_tensor(t), torch.as_tensor(y),
                    torch.as_tensor(p)).numpy()
    want = np.stack([np.asarray(jmodel.rhs(t[i], jnp.asarray(y[i]),
                                           jnp.asarray(p[i])))
                     for i in range(n_members)])
    return got, want


@pytest.mark.parametrize("doc", ["MM_SBML", "LOCAL_FD_SBML", "VOLUME_SBML",
                                 "RULES_SBML", "REPRESSILATOR"])
def test_import_matches_reference(doc):
    source = REPRESSILATOR if doc == "REPRESSILATOR" else getattr(ref, doc)
    model, p0 = from_sbml(source)
    jmodel, jp0 = jfrom_sbml(source)
    assert model.param_names == jmodel.param_names
    assert model.state_names == jmodel.state_names
    assert p0 == jp0
    np.testing.assert_array_equal(
        model.y0(torch.as_tensor(np.asarray(p0))[None])[0].numpy(),
        np.asarray(jmodel.y0(jnp.asarray(p0))))
    got, want = _rhs_pair(model, jmodel, p0, seed=len(doc))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-300)


def test_repressilator_example_matches_library():
    """examples/repressilator.sbml.xml is the port's library model."""
    model, p0 = from_sbml(REPRESSILATOR)
    lib = library.repressilator(device="cpu")
    assert model.param_names == lib.param_names
    assert model.state_names == lib.state_names
    np.testing.assert_allclose(p0, library.REPRESSILATOR_TRUE_PARAMS)
    p = torch.as_tensor(library.REPRESSILATOR_TRUE_PARAMS)[None]
    y = torch.as_tensor([[0.2, 0.15, 0.3, 0.12, 0.44, 0.53]],
                        dtype=torch.float64)
    t = torch.zeros(1, dtype=torch.float64)
    np.testing.assert_allclose(model.rhs(t, y, p).numpy(),
                               lib.rhs(t, y, p).numpy(), rtol=1e-14)
    cfg = SolverConfig(rtol=1e-8, atol=1e-10)
    t_eval = np.linspace(0.0, 10.0, 6)
    a = model.simulate(p, (0.0, 10.0), t_eval, config=cfg, device="cpu")
    b = lib.simulate(p, (0.0, 10.0), t_eval, config=cfg, device="cpu")
    assert a.status.tolist() == b.status.tolist() == [1]
    np.testing.assert_allclose(a.ys.numpy(), b.ys.numpy(), rtol=1e-9,
                               atol=1e-12)


def _error_cases():
    events = ref.MM_SBML.replace(
        "<listOfReactions>",
        "<listOfEvents><event id='e'/></listOfEvents><listOfReactions>")
    algebraic = ref.RULES_SBML.replace(
        "<rateRule variable=\"drive\">", "<algebraicRule>").replace(
        "</rateRule>", "</algebraicRule>")
    constant = ref.RULES_SBML.replace(
        '<parameter id="drive" value="1.5" constant="false"/>',
        '<parameter id="drive" value="1.5" constant="true"/>')
    state_trigger = ref.EVENT_SBML.replace(ref._T_CSYM, "<ci>A</ci>", 1)
    nonconst = ref.EVENT_SBML.replace(
        '<math xmlns="http://www.w3.org/1998/Math/MathML"><cn>4</cn></math>',
        '<math xmlns="http://www.w3.org/1998/Math/MathML"><ci>kdeg</ci>'
        '</math>')
    return {
        "events": (events, {}, SbmlUnsupportedError),
        "algebraic": (algebraic, {}, SbmlUnsupportedError),
        "not sbml": ("<notsbml/>", {}, SbmlError),
        "unknown symbol": (ref.MM_SBML.replace("<ci>km1</ci>",
                                               "<ci>typo</ci>"), {},
                           SbmlError),
        "rule on constant": (constant, {}, SbmlError),
        "events default": (ref.EVENT_SBML, {}, SbmlUnsupportedError),
        "state trigger": (state_trigger, {"events": "lower"},
                          SbmlUnsupportedError),
        "nonconstant assignment": (nonconst, {"events": "lower"},
                                   SbmlUnsupportedError),
        "events keyword": (ref.MM_SBML, {"events": "drop"}, ValueError),
    }


@pytest.mark.parametrize("case", list(_error_cases()))
def test_errors_match_reference(case):
    text, kw, exc = _error_cases()[case]
    with pytest.raises(exc) as got:
        from_sbml(text, **kw)
    # the reference's class of the same name
    with pytest.raises(getattr(jsbml_import, exc.__name__, exc)) as want:
        jfrom_sbml(text, **kw)
    assert type(got.value).__name__ == type(want.value).__name__
    # equal messages, each naming its own package
    assert str(got.value).replace("tpusysbio_torch", "tpusysbio") == str(
        want.value)


def test_event_lowering_records_match_reference():
    model, p0, lowered = from_sbml(ref.EVENT_SBML, events="lower")
    jmodel, jp0, jlowered = jfrom_sbml(ref.EVENT_SBML, events="lower")
    assert (model.param_names, model.state_names, p0, lowered) == (
        jmodel.param_names, jmodel.state_names, jp0, jlowered)
    assert lowered == (("state", 2.0, "A", 4.0),
                       ("param", 1.5, "inflow", 1.5))


def test_smoke_event_document_is_the_reference_tests():
    """``chip_smoke.py`` keeps its own copy of the event-lowering document
    (it imports no test module): the copy equals ``tests/test_sbml.py``'s
    and lowers to the same records."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.EVENT_SBML == ref.EVENT_SBML
    assert from_sbml(smoke.EVENT_SBML, events="lower")[2] == from_sbml(
        ref.EVENT_SBML, events="lower")[2]


def test_event_lowering_simulates_to_scipy_parity():
    """The dosing and feed events lowered onto ``Experiment.inputs`` /
    ``input_states`` through the port's ``Project``: residuals against
    the SciPy piecewise oracle below 1e-6 (``tests/test_sbml.py``'s
    oracle and bound)."""
    from scipy.integrate import solve_ivp

    from tpusysbio_torch.data import (Experiment, ExperimentBatch,
                                      Measurement)
    from tpusysbio_torch.project import ParameterMap, Project

    model, p0, lowered = from_sbml(ref.EVENT_SBML, events="lower")
    inputs = tuple((t, tgt, v) for kind, t, tgt, v in lowered
                   if kind == "param")
    input_states = tuple((t, tgt, v) for kind, t, tgt, v in lowered
                         if kind == "state")
    t = np.linspace(0.5, 6.0, 8)
    ys = np.zeros(8)
    y = np.array([1.0])
    for t_lo, t_hi, infl, dose in [(0.0, 1.5, 0.0, None),
                                   (1.5, 2.0, 1.5, None),
                                   (2.0, 6.0, 1.5, 4.0)]:
        if dose is not None:
            y = np.array([dose])
        pts = sorted({float(x) for x in t if t_lo < x <= t_hi} | {t_hi})
        sol = solve_ivp(lambda tt, yy: [infl - 0.3 * yy[0]],
                        (t_lo, t_hi), y, method="BDF", t_eval=pts,
                        rtol=1e-10, atol=1e-13)
        assert sol.success
        for k, tk in enumerate(t):
            if t_lo < tk <= t_hi:
                ys[k] = sol.y[0, pts.index(float(tk))]
        y = sol.y[:, -1]

    meas = (Measurement(obs_index=0, times=t, values=ys,
                        sigmas=np.ones(8)),)
    exps = [Experiment("dosed", meas, inputs=inputs,
                       input_states=input_states)]
    batch = ExperimentBatch.from_experiments(
        exps, param_names=model.param_names,
        state_names=model.state_names, device="cpu")
    pmap = ParameterMap.create(model.param_names, 1, shared=("kdeg",),
                               fixed={"inflow": [0.0]}, device="cpu")
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-9, atol=1e-12))
    r = proj.residuals(pmap.pack({"kdeg": 0.3})).numpy()
    assert np.max(np.abs(r)) < 1e-6


def _cascade(builder, *args):
    b = builder()
    b.catalytic("E1", "A", "Ap")          # names with ':' and '.' inside
    b.reaction("dimerize", ["Ap", "Ap"], ["D"])
    b.reaction("decay", ["D"], [])
    return b.build(*args)


def test_export_text_equals_reference_and_round_trips():
    """to_sbml's document equals the reference's for the same network
    and values; from_sbml(to_sbml(net)) reproduces the port's network
    RHS."""
    net = _cascade(NetworkBuilder, "cpu")
    jnet = _cascade(JNetworkBuilder)
    rng = np.random.default_rng(0)
    y0 = rng.uniform(0.1, 1.0, net.n_species)
    p = rng.uniform(0.5, 3.0, net.n_reactions)
    doc = to_sbml(net, y0, p, name="cascade")
    assert doc == jto_sbml(jnet, y0, p, name="cascade")
    assert to_sbml(net, {"A": 0.5}) == jto_sbml(jnet, {"A": 0.5})
    model, p0 = from_sbml(doc)
    np.testing.assert_allclose(p0, p)
    y = torch.as_tensor(rng.uniform(0.05, 0.9, (3, net.n_species)))
    pt = torch.as_tensor(np.tile(p, (3, 1)))
    t = torch.zeros(3, dtype=torch.float64)
    np.testing.assert_allclose(model.rhs(t, y, pt).numpy(),
                               net.rhs()(t, y, pt).numpy(), rtol=1e-14)


def test_mapk_export_round_trip_matches_library():
    """The MAPK-22 network exported and re-imported: the RHS equals the
    library model's to 1e-13 and the document equals the reference's."""
    net = library._mapk_network(device="cpu")
    p_true = library.mapk_true_params(device="cpu").numpy()
    lib = library.mapk_huang_ferrell(device="cpu")
    y0 = lib.y0(torch.as_tensor(p_true)[None])[0].numpy()
    doc = to_sbml(net, y0, p_true, name="mapk22")
    jnet = jlibrary._mapk_network()
    assert doc == jto_sbml(jnet, y0, p_true, name="mapk22")
    model, p0 = from_sbml(doc)
    np.testing.assert_array_equal(p0, p_true)
    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.uniform(0.0, 1.2, (16, 22)))
    pt = torch.as_tensor(p_true)[None].expand(16, -1)
    t = torch.zeros(16, dtype=torch.float64)
    got, want = model.rhs(t, y, pt), lib.rhs(t, y, pt)
    scale = want.abs().max()
    assert float(((got - want).abs() / scale).max()) <= 1e-13


def test_export_validation_matches_reference():
    b = NetworkBuilder()
    b.reaction("r1", ["A"], ["B"])
    net = b.build("cpu")
    for args, kw in ((([1.0],), {}), (({"A": 1.0, "nope": 2.0},), {}),
                     (([1.0, 0.0],), {"p": [1.0, 2.0]})):
        with pytest.raises(ValueError):
            to_sbml(net, *args, **kw)
