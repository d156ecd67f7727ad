"""The port's CLI ``sample`` against the JAX CLI's on the same command
line (MM-3, 8 walkers, 6 sweeps, 2 LM iterations, on the CPU).

Both synthesize the same data and fit it by LM from θ_true, so the fit
costs agree (1e-6), and both start the walkers from the same numpy ball
around that fit. The chains themselves differ: the port draws from a
``torch.Generator``, the reference from a ``PRNGKey``
(tests/test_torch_mcmc.py compares chains from the same draws).
"""

import json

import numpy as np
import pytest

import tpusysbio.fit as jfit
from tpusysbio import cli as jcli
from tpusysbio_torch import cli

ARGV = ["sample", "--model", "mm3", "--walkers", "8", "--steps", "6",
        "--burn", "2", "--fit-iters", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's returned dict and printed lines, JAX CLI's printed lines,
    the JAX CLI's starting walkers, the two --out files)."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("sample")
    port_out, ref_out = str(d / "port.npz"), str(d / "ref.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = cli.main(["--cpu"] + ARGV + ["--out", port_out])
    port_lines = buf.getvalue().strip().splitlines()

    seen = {}
    real = jfit.ensemble_sample

    def recording(log_prob_fn, x0, *a, **kw):
        seen["x0"] = np.asarray(x0)
        return real(log_prob_fn, x0, *a, **kw)

    jfit.ensemble_sample = recording
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jcli.main(ARGV + ["--out", ref_out])
    finally:
        jfit.ensemble_sample = real
    ref_lines = buf.getvalue().strip().splitlines()
    return got, port_lines, ref_lines, seen["x0"], port_out, ref_out


def test_record_keys_and_fit_cost_match_the_jax_cli(runs):
    got, port_lines, ref_lines, _, _, _ = runs
    rec, ref = json.loads(port_lines[0]), json.loads(ref_lines[0])
    assert list(rec) == list(ref)
    assert rec == got["record"]
    for k in ("model", "free_params", "walkers", "steps", "kept_samples"):
        assert rec[k] == ref[k], k
    assert abs(rec["fit_cost"] - ref["fit_cost"]) <= 1e-6 * ref["fit_cost"]
    assert 0.0 <= rec["mean_acceptance"] <= 1.0
    # one line per free parameter after the record, as the reference's
    assert len(port_lines) == len(ref_lines) == 5
    assert [ln.split(":")[0] for ln in port_lines[1:]] == \
        [ln.split(":")[0] for ln in ref_lines[1:]]


def test_walkers_start_from_the_reference_ball(runs):
    """The same numpy ball (seed 0, sigma 0.01) around each package's fit:
    the walkers' offsets from the JAX CLI's equal to 1e-14, so the ball is
    the same; the fits' θ within 1e-5 (k1 and km1 are identified only
    together: along that valley the two fits part by ~2e-6 while their
    costs agree to 1e-8)."""
    got, _, _, ref_x0, _, _ = runs
    x0 = got["x0"]
    assert x0.shape == ref_x0.shape == (8, 4)
    offset = x0 - ref_x0
    np.testing.assert_allclose(offset, offset[:1].repeat(8, axis=0),
                               rtol=0, atol=1e-14)
    assert float(np.abs(offset[0]).max()) <= 1e-5
    ball = 0.01 * np.random.default_rng(0).normal(size=(8, 4))
    np.testing.assert_allclose(x0 - got["fit"].theta[0].numpy(), ball,
                               rtol=0, atol=1e-14)


def test_out_file_holds_the_reference_keys(runs):
    got, _, _, _, port_out, ref_out = runs
    mine, ref = np.load(port_out), np.load(ref_out)
    assert sorted(mine.files) == sorted(ref.files)
    for k in ref.files:
        assert mine[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(mine["free"], ref["free"])
    np.testing.assert_array_equal(mine["chain"], got["chain"])
    assert mine["chain"].shape == (6, 8, 4)
    assert np.all(np.isfinite(mine["log_prob"]))
