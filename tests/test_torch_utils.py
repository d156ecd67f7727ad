"""The port's ``utils`` against the reference's ``tpusysbio/utils``: the
sanitizer lane, the one-process mesh, the backend choice, result export
and the ``debug_checks`` lane (tests/test_utils.py's cases). The
two-process mesh is held by tests/test_torch_mesh.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusysbio import utils as jutils
from tpusysbio.config import FitConfig as JFitConfig
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.fit import multistart_fit as jmultistart_fit
from tpusysbio.solvers import bdf_solve as jbdf_solve
from tpusysbio_torch import FitConfig, SolverConfig, utils
from tpusysbio_torch.config import MeshConfig
from tpusysbio_torch.fit import multistart_fit
from tpusysbio_torch.solvers import bdf_solve

torch.set_num_threads(1)


def test_sanitizer_traps_nans_and_restores_state():
    anomaly = torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="log"):
        with utils.sanitizer():
            assert torch.is_anomaly_enabled()
            torch.log(torch.tensor(-1.0)) + 1.0
    # restored afterwards
    assert torch.is_anomaly_enabled() == anomaly
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))
    # ±inf and uninitialized buffers are not trapped
    with utils.sanitizer(checks=False):
        torch.empty(1024)
        assert torch.isinf(torch.tensor(float("inf")) * 2.0)


def test_make_mesh_without_a_group():
    mesh = utils.make_mesh(device="cpu")
    assert mesh.axis_names == ("starts",)
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.device == torch.device("cpu")
    mesh = utils.make_mesh(config=MeshConfig(axis_names=("experiments",),
                                             axis_sizes=(1,)), device="cpu")
    assert mesh.axis_names == ("experiments",) and mesh.size == 1
    with pytest.raises(ValueError, match="1-D"):
        utils.make_mesh(config=MeshConfig(axis_names=("a", "b")),
                        device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        utils.make_mesh(2, device="cpu")


def test_mesh_blocks_and_the_one_rank_gather():
    mesh = utils.Mesh(("starts",), 2, 1, torch.device("cpu"))
    assert mesh.block(8) == slice(4, 8)
    th = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(utils.shard_starts(th, mesh), th[3:])
    with pytest.raises(ValueError, match="does not divide"):
        utils.shard_starts(th[:5], mesh)
    one = utils.make_mesh(device="cpu")
    res = (th, None, torch.tensor(1.0))
    assert utils.gather_multihost(res, one)[0] is th
    assert utils.gather_multihost(res) is res


@pytest.mark.parametrize("n_cards,local_ranks,backend", [
    (1, 2, "gloo"),    # two ranks on one card: NCCL refuses a shared GPU
    (0, 2, "gloo"),    # no card
    (2, 2, "nccl"),
    (8, 4, "nccl"),
    (4, 8, "gloo")])
def test_backend_follows_the_layout(n_cards, local_ranks, backend):
    assert utils.default_backend(n_cards, local_ranks) == backend


def _ros(th):
    return torch.stack([10.0 * (th[:, 1] - th[:, 0] ** 2), 1.0 - th[:, 0]],
                       dim=1)


def _ros_rj(th):
    z = torch.zeros_like(th[:, 0])
    J = torch.stack([torch.stack([-20.0 * th[:, 0], z + 10.0], dim=1),
                     torch.stack([z - 1.0, z], dim=1)], dim=1)
    return _ros(th), J


def test_results_export_equals_reference(tmp_path):
    """tests/test_utils.py's export case: the port's records of the same
    Rosenbrock fit equal the reference's (integers exactly, floats to
    1e-10); under a mesh only rank 0 writes the file."""
    starts = np.array([[-1.2, 1.0], [0.3, 0.3]])

    def jr(t):
        return jnp.stack([10.0 * (t[1] - t[0] ** 2), 1.0 - t[0]])

    out = multistart_fit(_ros, _ros_rj, torch.as_tensor(starts),
                         FitConfig(max_iter=100))
    ref = jmultistart_fit(jr, lambda t: (jr(t), jax.jacfwd(jr)(t)),
                          jnp.asarray(starts), JFitConfig(max_iter=100))
    recs, ref_recs = (utils.results_to_records(out),
                      jutils.results_to_records(ref))
    assert len(recs) == 2 and recs[0]["status"] > 0
    for rec, rrec in zip(recs, ref_recs):
        assert set(rec) == set(rrec)
        for k in ("start", "status", "n_iter"):
            assert rec[k] == rrec[k], k
        for k in ("cost", "grad_norm", "theta", "param_sigma"):
            np.testing.assert_allclose(rec[k], rrec[k], rtol=1e-10,
                                       atol=1e-12, err_msg=k)
    path = str(tmp_path / "res.json")
    utils.save_results_json(out, path, extra={"note": "test"})
    loaded = json.load(open(path))
    assert loaded["note"] == "test" and loaded["results"] == recs
    other = str(tmp_path / "rank1.json")
    utils.save_results_json(out, other, mesh=utils.Mesh(
        ("starts",), 2, 1, torch.device("cpu")))
    assert not (tmp_path / "rank1.json").exists()


def test_checked_lane_traps_bad_rhs_and_bad_step_as_the_reference():
    """tests/test_utils.py's checkify case in both packages, on the same
    triggers: a non-finite RHS at the initial condition, and a
    non-positive step size (``first_step=0``, the check of
    ``tpusysbio/solvers/bdf.py``'s step loop), and a NaN step size, which
    that check (``h > 0``) also refuses; a healthy solve under the same
    wrapper passes."""
    t_eval = np.array([0.5, 1.0])
    cfg = dict(rtol=1e-6, atol=1e-9, debug_checks=True)

    def bad_rhs(t, y):
        return 1.0 / (y - 1.0)          # inf at y0 = 1

    def good_rhs(t, y):
        return -y

    cases = [(bad_rhs, {}, "non-finite RHS"),
             (good_rhs, {"first_step": 0.0}, "non-positive step size"),
             (good_rhs, {"first_step": float("nan")},
              "non-positive step size h=nan")]
    for rhs, extra, msg in cases:
        jcfg = JSolverConfig(**cfg, **extra)
        jsim = jutils.checked(jax.jit(lambda y0: jbdf_solve(
            rhs, (0.0, 1.0), y0, jnp.asarray(t_eval), config=jcfg)))
        with pytest.raises(Exception, match=msg):
            jsim(jnp.asarray([1.0]))
        sim = utils.checked(lambda y0: bdf_solve(
            rhs, (0.0, 1.0), y0, torch.as_tensor(t_eval)[None],
            config=SolverConfig(**cfg, **extra)))
        with pytest.raises(FloatingPointError, match=msg):
            sim(torch.tensor([[1.0]], dtype=torch.float64))

    sim = utils.checked(lambda y0: bdf_solve(
        good_rhs, (0.0, 1.0), y0, torch.as_tensor(t_eval)[None].expand(
            2, 2), config=SolverConfig(**cfg)))
    res = sim(torch.tensor([[1.0], [2.0]], dtype=torch.float64))
    assert res.status.tolist() == [1, 1]
    np.testing.assert_allclose(res.ys[:, 1, 0].numpy(),
                               np.exp(-1.0) * np.array([1.0, 2.0]),
                               rtol=1e-5)
    # the flag costs nothing when off: the same solve, the same bits
    plain = bdf_solve(good_rhs, (0.0, 1.0),
                      torch.tensor([[1.0], [2.0]], dtype=torch.float64),
                      torch.as_tensor(t_eval)[None].expand(2, 2),
                      config=SolverConfig(rtol=1e-6, atol=1e-9))
    assert torch.equal(plain.ys, res.ys)
