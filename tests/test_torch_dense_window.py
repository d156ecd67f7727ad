"""The port's windowed dense output (``SolverConfig.dense_window``)
against its full-grid output and the JAX package's
(tests/test_solvers.py's dense-window cases, at B=2).

Tolerances: where the step cap never binds the windowed run equals the
full-grid run bit for bit with the same step counts; both equal the JAX
package's to 1e-9 relative with its step counts; where the cap binds
(window 2 on a 9-point grid) the step counts equal the JAX package's
windowed run's and ``ys`` agrees with the full-grid run to rtol 1e-6,
atol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusysbio import solvers as jsolvers
from tpusysbio.config import SolverConfig as JSolverConfig
from tpusysbio.model import library as jlibrary
from tpusysbio.sens import make_sens_rhs as jmake_sens_rhs
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import library
from tpusysbio_torch.sens import make_sens_rhs
from tpusysbio_torch.solvers import bdf_solve

torch.set_num_threads(1)

PS = np.asarray(jlibrary.MM_TRUE_PARAMS)[None] * np.exp(
    np.random.default_rng(0).normal(scale=0.2, size=(2, 4)))


def _port(t_eval, sens, **cfg):
    tm = library.michaelis_menten(device="cpu")
    p = torch.as_tensor(PS)
    kw = {}
    if sens:
        kw = dict(sens_rhs=make_sens_rhs(tm.rhs, p),
                  s0=torch.zeros((2, 3, 4), dtype=torch.float64))
    return bdf_solve(lambda t, y: tm.rhs(t, y, p), (0.0, 10.0), tm.y0(p),
                     torch.as_tensor(t_eval), config=SolverConfig(**cfg),
                     **kw)


def _jax(t_eval, sens, **cfg):
    jm = jlibrary.michaelis_menten()

    def one(p):
        kw = {}
        if sens:
            kw = dict(sens_rhs=jmake_sens_rhs(jm.rhs, p),
                      s0=jnp.zeros((3, 4)))
        return jsolvers.bdf_solve(
            lambda t, y: jm.rhs(t, y, p), (0.0, 10.0), jm.y0(p),
            jnp.asarray(t_eval), config=JSolverConfig(**cfg), **kw)

    return jax.tree.map(np.asarray,
                        jax.jit(jax.vmap(one))(jnp.asarray(PS)))


def test_window_bitwise_equal_and_matches_reference():
    t_eval = np.linspace(0.0, 10.0, 41)
    cfg = dict(rtol=1e-6, atol=1e-9, max_steps=1024)
    full = _port(t_eval, True, **cfg)
    win = _port(t_eval, True, dense_window=8, **cfg)
    assert full.status.tolist() == win.status.tolist() == [1, 1]
    assert torch.equal(full.nsteps, win.nsteps)
    assert torch.equal(full.ys, win.ys) and torch.equal(full.sens, win.sens)
    ref = _jax(t_eval, True, dense_window=8, **cfg)
    np.testing.assert_array_equal(win.nsteps.numpy(), ref.nsteps)
    for key in ("ys", "sens"):
        a, b = getattr(win, key).numpy(), getattr(ref, key)
        assert np.abs(a - b).max() / np.abs(b).max() <= 1e-9, key


def test_window_cap_binds_still_exact():
    t_eval = np.linspace(0.0, 10.0, 9)
    cfg = dict(rtol=1e-8, atol=1e-11, max_steps=2048)
    full = _port(t_eval, False, **cfg)
    win = _port(t_eval, False, dense_window=2, **cfg)
    assert win.status.tolist() == [1, 1]
    assert bool((win.nsteps >= full.nsteps).all())
    ref = _jax(t_eval, False, dense_window=2, **cfg)
    for c in ("nsteps", "naccepted", "nrejected", "nlu"):
        np.testing.assert_array_equal(getattr(win, c).numpy(),
                                      getattr(ref, c), err_msg=c)
    np.testing.assert_allclose(win.ys.numpy(), full.ys.numpy(), rtol=1e-6,
                               atol=1e-9)
