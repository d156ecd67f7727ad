"""Each entry through the harness's own driver code on the CPU with a tiny
cell: the result line's keys, the control and the planted faults that
must make ``correct`` false, the import guard, and the command's refusal
without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import _tiny

KINDS = ["integrate", "fit"]
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("kind", KINDS)
def test_entry_runs_and_is_correct(kind, tmp_path):
    line = _tiny.run(kind, tmp_path)
    assert LINE_KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    assert len(line["metrics"]) == 2
    dev = line["device"]
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(line)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_control_is_not_correct(kind, tmp_path):
    """The reference with its sensitivity columns in bfloat16 in the
    program's place."""
    line = _tiny.run(kind, tmp_path, control="bf16")
    assert not line["correct"], line["checks"]


def test_traced_run_reports_layer_metrics(tmp_path):
    line = _tiny.run("integrate", tmp_path, traced=True)
    assert line["correct"]
    names = set(line["metrics"])
    assert {"bdf.ms_per_trip.sens", "bdf.reject_pct.sens",
            "step_mfu.sens"} <= names
    assert "setup_s" not in names
    for name, m in line["metrics"].items():
        assert m["value"] > 0 or name == "bdf.reject_pct.sens"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


# -- faults planted under the timed path -----------------------------------

def _faulty(fault):
    """A stepper that breaks its result as ``fault`` says."""
    from tpusysbio_torch import solvers

    real = solvers.SOLVERS["bdf"]

    def solve(*args, **kwargs):
        res = real(*args, **kwargs)
        ys, sens = res.ys, res.sens
        if fault == "unchanged":
            # every output time holds the initial state, no sensitivity
            ys = args[2][:, None, :].expand_as(ys).clone()
            sens = torch.zeros_like(sens) if sens is not None else None
        elif fault == "half":
            # the second half of the batch is left out: it gets the mean
            # of the first half
            h = ys.shape[0] // 2
            ys = ys.clone()
            ys[h:] = ys[:h].mean(0)
            if sens is not None:
                sens = sens.clone()
                sens[h:] = sens[:h].mean(0)
        elif fault == "altered":
            # one output per member altered where it is produced
            ys = ys.clone()
            ys[:, -1] *= 1.01
            if sens is not None:
                sens = sens.clone()
                sens[:, -1] *= 1.01
        return res._replace(ys=ys, sens=sens)

    return solve


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("kind", KINDS)
def test_planted_fault_is_not_correct(kind, fault, tmp_path, monkeypatch):
    from tpusysbio_torch import solvers

    monkeypatch.setitem(solvers.SOLVERS, "bdf", _faulty(fault))
    line = _tiny.run(kind, tmp_path)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "reversed"])
def test_planted_lm_fault_is_not_correct(fault, tmp_path, monkeypatch):
    """Levenberg-Marquardt's step left out (every start kept) or
    reversed, in both phases of the fit."""
    from types import SimpleNamespace

    from tpusysbio_torch.linalg import lu
    from tpusysbio_torch.optim import lm

    def lu_solve(*args):
        x = lu.lu_solve(*args)
        return 0.0 * x if fault == "unchanged" else -x

    monkeypatch.setattr(lm, "_lu", SimpleNamespace(lu_factor=lu.lu_factor,
                                                   lu_solve=lu_solve))
    line = _tiny.run("fit", tmp_path)
    step = line["checks"]["step_err"]
    assert not line["correct"] and step["value"] > step["limit"], \
        line["checks"]


# -- the process ----------------------------------------------------------

def test_a_run_loads_no_jax_module(tmp_path):
    """A tiny run in a fresh interpreter: no module whose top-level name
    is jax, jaxlib, flax or tpusysbio (compared whole)."""
    code = (
        "import sys, pathlib\n"
        "from portbench.tests import _tiny\n"
        "from portbench import harness\n"
        f"_tiny.run('integrate', pathlib.Path({str(tmp_path)!r}))\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'tpusysbio'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "[]"]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusysbio_torch_fake", sys)
    assert harness.forbidden_modules() == [] or \
        "tpusysbio" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    bench = harness.benchmark()
    out = subprocess.run(
        bench["command"] + ["--workload", "mapk22-sens", "--seed",
                            str(2**33 + 1), "--seconds", "1", "--trace",
                            "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_command_fails_with_the_benchmark_files_alone(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under
    ``paths``: the program is missing, and the run fails."""
    import shutil

    for p in harness.benchmark()["paths"]:
        shutil.copytree(harness.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    bench = harness.benchmark()
    out = subprocess.run(
        bench["command"] + ["--workload", "mapk22-sens", "--seed", "5",
                            "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout
