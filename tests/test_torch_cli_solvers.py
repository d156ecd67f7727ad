"""The port's CLI ``simulate``/``sens`` with every ``--solver`` against
the JAX CLI.

``simulate --model mm3 --t-end 5 --n-times 6 --solver dopri5 --out`` as
tests/test_cli.py runs it; then each solver's printed counter record
against the JAX CLI's on the same command line (equal, f64 on both
sides), and ``sens --solver radau`` likewise.
"""

import json

import numpy as np
import pytest
import torch

from tpusysbio import cli as jcli
from tpusysbio_torch import cli

torch.set_num_threads(1)

SIM = ["--model", "mm3", "--t-end", "5", "--n-times", "6"]


def test_simulate_dopri5_writes_npz(tmp_path, capsys):
    out = str(tmp_path / "traj.npz")
    res = cli.main(["--cpu", "simulate"] + SIM + ["--solver", "dopri5",
                                                  "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["status"] == 1 and rec == res["record"]
    data = np.load(out)
    assert data["ys"].shape == (6, 3)
    assert np.all(np.isfinite(data["ys"]))


def _jax_record(argv, capsys):
    jcli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[0])


@pytest.mark.parametrize("cmd,solver", [
    ("simulate", "bdf"), ("simulate", "radau"), ("simulate", "rosenbrock"),
    ("simulate", "dopri5"), ("simulate", "adams"), ("simulate", "auto"),
    ("sens", "radau")])
def test_counters_match_jax_cli(cmd, solver, capsys):
    argv = [cmd] + SIM + ["--solver", solver]
    ref = _jax_record(argv, capsys)
    got = cli.main(["--cpu"] + argv)
    capsys.readouterr()
    assert got["record"] == ref
    assert got["record"]["status"] == 1
    assert np.isfinite(got["ys"]).all()
