"""The port's front end against the reference: the run-file loader and its
YAML reader, the CLI's synthetic problems, the two-phase fit and the
profile likelihood from the same numpy inputs, and the CLI itself with
``--cpu`` (the reference's ``tests/test_cli.py`` invocations)."""

import argparse
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tpusysbio import cli as jcli
from tpusysbio import config as jconfig
from tpusysbio.config import FitConfig as JFitConfig
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.fit import multistart as jms
from tpusysbio.fit import profile as jprofile
from tpusysbio.project import Project as JProject
from tpusysbio_torch import FitConfig, SolverConfig, cli, config, utils
from tpusysbio_torch.fit import (confidence_intervals, multistart_two_phase,
                                 profile_likelihood)
from tpusysbio_torch.project import Project

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                 if f.endswith(".yaml"))


# --------------------------------------------------------------------------
# Run files
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["SolverConfig", "FitConfig", "MeshConfig",
                                 "RunSpec"])
def test_config_fields_match_reference(cls):
    ref = [(f.name, f.default, f.default_factory)
           for f in dataclasses.fields(getattr(jconfig, cls))]
    got = [(f.name, f.default, f.default_factory)
           for f in dataclasses.fields(getattr(config, cls))]
    # the defaults are the packages' own (equal) dataclasses
    assert [(n, repr(d), f) for n, d, f in got] == [
        (n, repr(d), f) for n, d, f in ref]


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_matches_reference(name):
    """Every canonical run file, field by field."""
    path = os.path.join(REPO, "configs", name)
    ref, got = jconfig.load_config(path), config.load_config(path)
    assert got.model == ref.model and got.run == ref.run
    for section in ("solver", "screen_solver", "fit", "screen_fit", "mesh"):
        r, g = getattr(ref, section), getattr(got, section)
        if r is None:
            assert g is None, section
        else:
            assert dataclasses.asdict(g) == dataclasses.asdict(r), section
    hash(got.solver), hash(got.fit)


YAML_SNIPPETS = [
    "a: 1.0e-6\nb: 7\nc: [x, 2, 3.5, -1]\nd: {p: 1, q: true}\n",
    "# head\ne: hi  # a comment\nf:\ng: ~\nh: null\n",
    "s:\n  k: []\n  j: -3\n  l: +2.0\n  m: {}\nt: .5\n",
    "mesh: {axis_names: [starts], axis_sizes: [4]}\n"
    "x: {k: [1, 2], j: c, l: [], m: false}\n",
]


@pytest.mark.parametrize("i", range(len(YAML_SNIPPETS)))
def test_yaml_reader_matches_safe_load(i):
    text = YAML_SNIPPETS[i]
    got, ref = config.parse_yaml(text), yaml.safe_load(text)
    assert json.dumps(got, sort_keys=True, default=repr) == json.dumps(
        ref, sort_keys=True, default=repr)


def test_yaml_reader_reads_every_run_file_as_safe_load():
    for name in CONFIGS:
        with open(os.path.join(REPO, "configs", name)) as fh:
            text = fh.read()
        assert config.parse_yaml(text) == yaml.safe_load(text), name


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a:\n  b:\n    c: 1\n", "a: &x 1\n", "a: 1\na: 2\n",
    "  a: 1\n", "a: [1, 2\n", "a: |\n",
    # scalars that YAML 1.1 reads otherwise than as a word or a number
    "a: 'q'\n", "a: yes\n", "a: .inf\n", "a: 1e-6\n", "a: 1_000\n",
    # nesting inside a flow collection beyond a mapping's lists
    "a: [[1], 2]\n", "a: {b: {c: 1}}\n", "a:\n\tb: 1\n"])
def test_yaml_reader_refuses_what_it_does_not_cover(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)


def test_load_config_errors_match_reference(tmp_path):
    for raw, match in (({"model": "mm3", "solver": {"rtoll": 1e-4}},
                        "unknown SolverConfig keys"),
                       ({"model": "mm3", "solvers": {}},
                        "unknown config sections"),
                       ({"solver": {}}, "requires a 'model'")):
        for mod in (jconfig, config):
            with pytest.raises(ValueError, match=match):
                mod.load_config(raw)
    raw = {"model": "mm3", "mesh": {"axis_names": ["starts"],
                                    "axis_sizes": [4]}, "run": {"starts": 8}}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(raw))
    spec = config.load_config(str(path))
    assert spec == config.load_config(raw)
    assert spec.mesh == config.MeshConfig(axis_names=("starts",),
                                          axis_sizes=(4,))


# --------------------------------------------------------------------------
# The CLI's synthetic problems
# --------------------------------------------------------------------------

def _fields(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


@pytest.mark.parametrize("name", ["mm3", "repressilator", "jakstat"])
def test_synth_problem_matches_reference(name):
    """The data (an rtol=1e-9 simulation plus seeded noise) within 1e-8
    relative, and the same free set, map and θ_true, at the run file's
    horizon and 6 times."""
    run = config.load_config(os.path.join(REPO, "configs",
                                          f"{name}.yaml")).run
    args = argparse.Namespace(model=name, t_end=run["t_end"], n_times=6,
                              noise=run["noise"], seed=run["seed"])
    jmodel, jbatch, jpmap, jfree, jtheta = jcli._synth_problem(args)
    model, batch, pmap, free, theta = cli._synth_problem(
        args, torch.device("cpu"))
    assert free == jfree and model.name == jmodel.name
    ref = _fields(jbatch)
    vals = batch.values.numpy()
    assert np.max(np.abs(vals - ref["values"])) <= 1e-8 * np.max(
        np.abs(ref["values"]))
    np.testing.assert_allclose(batch.sigmas.numpy(), ref["sigmas"],
                               rtol=1e-8)
    for k in ("map_idx", "fixed"):
        np.testing.assert_array_equal(getattr(pmap, k).numpy(),
                                      _fields(jpmap)[k])
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))


def _mm3_problem(sens_precision="f32"):
    args = argparse.Namespace(model="mm3", t_end=10.0, n_times=6,
                              noise=0.02, seed=0)
    jmodel, jbatch, jpmap, _, jtheta = jcli._synth_problem(args)
    kw = dict(rtol=1e-6, atol=1e-9, max_steps=512, linear_solver="inv32",
              sens_precision=sens_precision)
    jproj = JProject(model=jmodel, pmap=jpmap, batch=jbatch,
                     config=JSolverConfig(**kw))
    model, batch, pmap, _, theta = cli._synth_problem(args,
                                                      torch.device("cpu"))
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(**kw))
    return jproj, proj, np.array(jtheta)


def test_two_phase_fit_matches_reference():
    """MM-3 (all four parameters free, ``sens_mode='params'``) from the
    same 4 numpy starts: 2 screening iterations on the f32 stepper, the
    best 2 polished by 3; polished costs within 1e-6."""
    jproj, proj, theta_true = _mm3_problem()
    screen_kw = dict(rtol=1e-3, atol=1e-6, max_steps=128,
                     linear_solver="inv32", mixed_precision=True)
    jscreen = dataclasses.replace(jproj, config=JSolverConfig(**screen_kw))
    screen = dataclasses.replace(proj, config=SolverConfig(**screen_kw))
    rng = np.random.default_rng(7)
    starts = theta_true[None] + rng.uniform(-0.5, 0.5, (4, 4))
    s_kw = dict(max_iter=2, ftol=1e-4, xtol=1e-4, eval_mode="lockstep")
    p_kw = dict(max_iter=3, eval_mode="lockstep")
    ref, ref_screen = jms.multistart_two_phase(
        (jscreen.residuals, jscreen.residuals_and_jacobian),
        (jproj.residuals, jproj.residuals_and_jacobian),
        jnp.asarray(starts), JFitConfig(**s_kw), JFitConfig(**p_kw), 2)
    got, got_screen = multistart_two_phase(
        (screen.residuals, screen.residuals_and_jacobian),
        (proj.residuals, proj.residuals_and_jacobian),
        torch.as_tensor(starts), FitConfig(**s_kw), FitConfig(**p_kw), 2)
    np.testing.assert_array_equal(got_screen.status.numpy(),
                                  np.asarray(ref_screen.status))
    np.testing.assert_allclose(got_screen.cost.numpy(),
                               np.asarray(ref_screen.cost), rtol=3e-2)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-6)


def test_profile_likelihood_matches_reference():
    """MM-3 profiled around the truth at ``n_points=2``: grid costs within
    1e-6 relative and likelihood-ratio intervals within 1e-4 (log space;
    an unbounded side on both or neither). The sensitivity columns are
    f64 here: k1 and km1 are only identified together, and along that
    flat valley f32 columns move the LM iterates apart at 1e-5."""
    jproj, proj, theta_true = _mm3_problem(sens_precision="full")
    cfg = dict(max_iter=5, eval_mode="lockstep")
    ref = jprofile.profile_likelihood(
        jproj.residuals, jproj.residuals_and_jacobian,
        jnp.asarray(theta_true), n_points=2, span=0.5,
        config=JFitConfig(**cfg))
    got = profile_likelihood(proj.residuals, proj.residuals_and_jacobian,
                             torch.as_tensor(theta_true), n_points=2,
                             span=0.5, config=FitConfig(**cfg))
    assert tuple(got.costs.shape) == (4, 5)
    np.testing.assert_array_equal(got.idx, ref.idx)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(float(got.cost_opt), float(ref.cost_opt),
                               rtol=1e-9)
    ci, ci_ref = confidence_intervals(got), jprofile.confidence_intervals(ref)
    np.testing.assert_array_equal(np.isfinite(ci), np.isfinite(ci_ref))
    fin = np.isfinite(ci_ref)
    np.testing.assert_allclose(ci[fin], ci_ref[fin], rtol=0, atol=1e-4)
    # mesh= is ported since (tests/test_torch_mesh.py): a mesh size that
    # does not divide the 2·P chains raises before any chain runs
    with pytest.raises(ValueError, match="does not divide"):
        profile_likelihood(proj.residuals, proj.residuals_and_jacobian,
                           torch.as_tensor(theta_true), mesh=utils.Mesh(
                               ("starts",), 3, 0, torch.device("cpu")))


# --------------------------------------------------------------------------
# The CLI with --cpu
# --------------------------------------------------------------------------

MULTISTART_KEYS = {"model", "free_params", "starts", "top_k", "wall_seconds",
                   "screen_finished", "best_cost", "cost_at_truth",
                   "top_costs"}
PROFILE_KEYS = {"model", "free_params", "grid_points", "wall_seconds",
                "fit_cost", "unconverged_points", "level"}
REPORT_KEYS = {"status", "nsteps", "naccepted", "nrejected", "nfev", "njev",
               "nlu"}


def test_cli_simulate_and_sens(tmp_path, capsys):
    out = str(tmp_path / "traj.npz")
    cli.main(["--cpu", "simulate", "--model", "mm3", "--t-end", "5",
              "--n-times", "6", "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == REPORT_KEYS and rec["status"] == 1
    assert np.load(out)["ys"].shape == (6, 3)
    cli.main(["--cpu", "sens", "--model", "lotka", "--t-end", "3",
              "--n-times", "4", "--solver", "bdf"])
    text = capsys.readouterr().out
    rec = json.loads(text.strip().splitlines()[0])
    assert rec["status"] == 1 and rec["nlu"] > 0
    assert "sens shape (4, 2, 6)" in text


def test_cli_profile_flag_writes_a_trace(tmp_path, capsys):
    """``--profile DIR`` writes a torch.profiler trace to DIR/trace.json."""
    cli.main(["--cpu", "simulate", "--model", "mm3", "--t-end", "0.5",
              "--n-times", "2", "--profile", str(tmp_path / "trace")])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["status"] == 1
    with open(tmp_path / "trace" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


def test_cli_multistart_pipeline(tmp_path, capsys):
    """tests/test_cli.py's tiny multistart, without ``--plot``."""
    out = str(tmp_path / "fits.npz")
    res = cli.main(["--cpu", "multistart", "--model", "mm3", "--starts",
                    "4", "--top-k", "2", "--screen-iters", "2",
                    "--polish-iters", "4", "--iter-chunk", "4", "--t-end",
                    "10", "--n-times", "6", "--spread", "0.3",
                    "--linear-solver", "inv32", "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert set(rec) == MULTISTART_KEYS
    assert rec["model"] == "mm3" and rec["top_k"] == 2
    assert rec["free_params"] == 4 and np.isfinite(rec["best_cost"])
    assert rec["best_cost"] == float(res["polish"].ranked().cost[0])
    data = np.load(out)
    assert data["theta"].shape == (2, 4)
    assert data["param_sigma"].shape == (2, 4)
    assert np.all(np.isfinite(data["cost"]))


def test_cli_multistart_with_config_file(tmp_path, capsys):
    """tests/test_config.py's tiny run file, as YAML: its sections reach
    the pipeline; a mesh of one device runs unsharded and says so."""
    path = tmp_path / "tiny.yaml"
    path.write_text(
        "model: mm3\n"
        "solver: {rtol: 1.0e-6, atol: 1.0e-9, max_steps: 512, "
        "linear_solver: inv32, sens_precision: f32}\n"
        "screen_solver:\n"
        "  rtol: 1.0e-3\n"
        "  atol: 1.0e-6\n"
        "  max_steps: 128\n"
        "  linear_solver: inv32\n"
        "  mixed_precision: true\n"
        "fit: {max_iter: 4, eval_mode: lockstep}\n"
        "screen_fit: {max_iter: 2, eval_mode: lockstep, ftol: 1.0e-4, "
        "xtol: 1.0e-4}\n"
        "mesh: {axis_names: [starts]}\n"
        "run: {starts: 4, top_k: 2, iter_chunk: 4, spread: 0.3, "
        "t_end: 10.0, n_times: 6}\n")
    res = cli.main(["--cpu", "multistart", "--config", str(path)])
    captured = capsys.readouterr()
    rec = json.loads(captured.out.strip().splitlines()[0])
    assert set(rec) == MULTISTART_KEYS
    assert rec["model"] == "mm3" and rec["starts"] == 4
    assert np.isfinite(rec["best_cost"])
    assert "unsharded" in captured.err
    assert res["polish_config"] == FitConfig(max_iter=4,
                                             eval_mode="lockstep")
    assert res["project"].config.linear_solver == "inv32"


def test_cli_config_rejects_unknown_run_key_and_wide_mesh(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"model": "mm3", "run": {"startz": 4}}))
    with pytest.raises(SystemExit, match="startz"):
        cli.main(["--cpu", "multistart", "--config", str(path)])
    # without a process group a config mesh resolves to one rank
    assert cli._config_mesh(config.MeshConfig(axis_sizes=(4,)),
                            torch.device("cpu")) == (None, False)
    with pytest.raises(ValueError, match="1-D"):
        cli._config_mesh(config.MeshConfig(axis_names=("a", "b")),
                         torch.device("cpu"))


def test_cli_profile_reports_cis(tmp_path, capsys):
    """tests/test_cli.py's tiny profile at a smaller depth (one grid point
    a side, 3 LM iterations: on this CPU each sensitivity integration of
    MM-3 takes ~1.5 s), without ``--plot``: the same keys and shapes."""
    out = str(tmp_path / "prof.npz")
    res = cli.main(["--cpu", "profile", "--model", "mm3", "--n-points",
                    "1", "--span", "0.5", "--t-end", "10", "--n-times",
                    "6", "--fit-iters", "3", "--linear-solver", "inv32",
                    "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert set(rec) == PROFILE_KEYS
    assert rec["model"] == "mm3" and rec["grid_points"] == 3
    assert np.isfinite(rec["fit_cost"])
    data = np.load(out)
    assert data["costs"].shape == (4, 3) and data["ci"].shape == (4, 2)
    assert data["thetas"].shape == (4, 3, 4)
    assert np.all(np.isfinite(data["costs"]))
    # the center column is the fit itself
    np.testing.assert_array_equal(data["costs"][:, 1], rec["fit_cost"])
    np.testing.assert_array_equal(res["ci"], data["ci"])


def test_cli_fit_example_at_a_cut_depth(capsys):
    """``fit --example mm3 --max-iter 1``: the example's fit, capped."""
    res = cli.main(["--cpu", "fit", "--example", "mm3", "--max-iter", "1"])
    text = capsys.readouterr().out
    assert text.startswith(f"status={res['status']}  iters=")
    assert int(text.split("iters=")[1].split()[0]) <= 1
    assert np.isfinite(res["cost"]) and res["theta"].shape == (4,)


@pytest.mark.parametrize("argv,item", [
    (["simulate", "--solver", "dopri5"], "12"),
    (["sens", "--solver", "radau"], "12"),
    (["multistart", "--model", "mm3", "--starts", "4", "--top-k", "2",
      "--screen-iters", "1", "--polish-iters", "1", "--plot", "x"], "14"),
    (["profile", "--model", "mm3", "--n-points", "1", "--fit-iters", "1",
      "--plot", "x"], "14"),
    (["simulate", "--solver", "rosenbrock"], "12"),
    (["bench"], "15"),
])
def test_cli_unported_paths_raise(argv, item, tmp_path):
    """``bench`` (item 15) still raises. The steppers of item 12 are
    ported since: their cases run to status 1
    (tests/test_torch_cli_solvers.py holds them against the JAX CLI).
    ``--plot`` (item 14's surfaces) is ported since: at the smallest depth
    its cases write the reference's PNG files, non-empty
    (tests/test_torch_viz.py holds the plotted data against the JAX
    package's)."""
    if item == "12":
        out = cli.main(["--cpu"] + argv)
        assert out["record"]["status"] == 1
        assert np.isfinite(out["ys"]).all()
        return
    if item == "14":
        prefix = str(tmp_path / "x")
        cli.main(["--cpu"] + argv[:-1] + [prefix])
        names = (["_waterfall.png", "_fit.png"] if argv[0] == "multistart"
                 else ["_profiles.png"])
        for name in names:
            assert os.path.getsize(prefix + name) > 0, name
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        cli.main(["--cpu"] + argv)
