"""The port's SymPy front end (``tpusysbio_torch/model/sympy_import.py``)
against the JAX package's ``from_sympy`` on the same expressions.

Tolerances: RHS, y0 and observables within 1e-14 relative of the
reference's; trajectories of an imported model within 1e-10 of the
port's hand-written one; forward sensitivities through ``torch.func.jvp``
within 1e-7 of the closed form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch

from tpusysbio.model.sympy_import import from_sympy as jfrom_sympy
from tpusysbio_torch import SolverConfig
from tpusysbio_torch.model import from_sympy, library
from tpusysbio_torch.solvers.common import batched_jacobian

torch.set_num_threads(1)

MM_TRUE = library.MM_TRUE_PARAMS


def _mm(build):
    t = sp.Symbol("t")
    S, C, P = sp.symbols("S C P")
    k1, km1, k2, E0 = sp.symbols("k1 km1 k2 E0")
    return build(
        name="mm3_sympy", states=[S, C, P], params=[k1, km1, k2, E0],
        odes=[-k1 * (E0 - C) * S + km1 * C,
              k1 * (E0 - C) * S - (km1 + k2) * C,
              k2 * C],
        y0=[1.0, 0.0, 0.0], t=t)


def _states(rng, batch, n):
    return rng.uniform(0.05, 1.5, size=(batch, n))


def test_mm3_matches_reference_and_library():
    m = _mm(from_sympy)
    mj = _mm(jfrom_sympy)
    assert m.param_names == mj.param_names and m.state_names == mj.state_names
    rng = np.random.default_rng(0)
    y = _states(rng, 5, 3)
    p = np.tile(MM_TRUE, (5, 1)) * rng.uniform(0.5, 2.0, size=(5, 4))
    t = rng.uniform(0.0, 5.0, size=5)
    got = m.rhs(torch.as_tensor(t), torch.as_tensor(y),
                torch.as_tensor(p)).numpy()
    ref = np.stack([np.asarray(mj.rhs(t[i], jnp.asarray(y[i]),
                                      jnp.asarray(p[i]))) for i in range(5)])
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-300)
    lib = library.michaelis_menten(device="cpu")
    cfg = SolverConfig(rtol=1e-8, atol=1e-11)
    t_eval = np.linspace(0.0, 5.0, 6)
    ys = m.simulate(MM_TRUE[None], (0.0, 5.0), t_eval, config=cfg,
                    device="cpu")
    ys_lib = lib.simulate(MM_TRUE[None], (0.0, 5.0), t_eval, config=cfg,
                          device="cpu")
    assert ys.status.tolist() == [1]
    np.testing.assert_allclose(ys.ys.numpy(), ys_lib.ys.numpy(), rtol=1e-10,
                               atol=1e-12)


def _decay(build):
    x = sp.Symbol("x")
    a, x0 = sp.symbols("a x0")
    return build("decay", states=[x], params=[a, x0], odes=[-a * x],
                 y0=[x0], observables=[2 * x])


def test_param_dependent_y0_observables_and_jvp_sensitivity():
    m, mj = _decay(from_sympy), _decay(jfrom_sympy)
    p = np.asarray([[0.5, 3.0], [0.7, 1.5]])
    np.testing.assert_allclose(
        m.y0(torch.as_tensor(p)).numpy(),
        np.stack([np.asarray(mj.y0(jnp.asarray(r))) for r in p]),
        rtol=1e-14)
    yv = np.asarray([[2.0], [0.3]])
    np.testing.assert_allclose(
        m.observables(torch.as_tensor(yv), torch.as_tensor(p)).numpy(),
        np.stack([np.asarray(mj.observables(jnp.asarray(yv[i]),
                                            jnp.asarray(p[i])))
                  for i in range(2)]), rtol=1e-14)
    res = m.simulate_sensitivities(
        p, (0.0, 2.0), [2.0], config=SolverConfig(rtol=1e-10, atol=1e-13),
        device="cpu")
    a, x0 = p[:, 0], p[:, 1]
    np.testing.assert_allclose(res.ys[:, 0, 0].numpy(), x0 * np.exp(-2 * a),
                               rtol=1e-8)
    # dy/dx0 = exp(-a t); dy/da = -t x0 exp(-a t), dy0/dp chained in
    np.testing.assert_allclose(res.sens[:, 0, 0, 1].numpy(),
                               np.exp(-2 * a), rtol=1e-7)
    np.testing.assert_allclose(res.sens[:, 0, 0, 0].numpy(),
                               -2.0 * x0 * np.exp(-2 * a), rtol=1e-7)


def _special(build):
    """Piecewise, Abs, floor/ceiling and log base 10 mixed with numbers, a
    constant ODE component (0) and a constant observable."""
    x, y, t = sp.symbols("x y t")
    k, c = sp.symbols("k c")
    f0 = (sp.Piecewise((k * x, x > 1), (c, True))
          + sp.Abs(x - y) + sp.floor(3 * x)
          + sp.ceiling(y) + sp.log(x, 10) + sp.exp(2) * x * t
          + sp.Piecewise((1, t >= 0.5), (0, True)) + sp.sqrt(2) * y)
    return build("special", states=[x, y], params=[k, c],
                 odes=[f0, sp.Integer(0)], y0=[1.0, 0.5], t=t,
                 observables=[x + y, sp.Integer(3), sp.log(y, 10)])


def test_special_functions_constants_and_jacobian():
    m, mj = _special(from_sympy), _special(jfrom_sympy)
    rng = np.random.default_rng(1)
    y = rng.uniform(0.2, 2.5, size=(6, 2))
    p = rng.uniform(0.1, 3.0, size=(6, 2))
    t = np.linspace(0.0, 1.0, 6)
    Y, P, T = (torch.as_tensor(v) for v in (y, p, t))
    got = m.rhs(T, Y, P)
    assert got.shape == (6, 2) and got.dtype == torch.float64
    ref = np.stack([np.asarray(mj.rhs(t[i], jnp.asarray(y[i]),
                                      jnp.asarray(p[i]))) for i in range(6)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=1e-300)
    obs = m.observables(Y, P)
    ref_obs = np.stack([np.asarray(mj.observables(jnp.asarray(y[i]),
                                                  jnp.asarray(p[i])))
                        for i in range(6)])
    np.testing.assert_allclose(obs.numpy(), ref_obs, rtol=1e-14)
    # the forward-mode Jacobian runs under vmap + jvp and agrees with
    # the reference's jacfwd
    J = batched_jacobian(lambda yy: m.rhs(T, yy, P), Y).numpy()
    J_ref = np.stack([np.asarray(mj.jacobian(t[i], jnp.asarray(y[i]),
                                             jnp.asarray(p[i])))
                      for i in range(6)])
    np.testing.assert_allclose(J, J_ref, rtol=1e-13, atol=1e-14)
    # the mixed-precision stepper's f32 state gives f32 columns
    assert m.rhs(T.float(), Y.float(), P.float()).dtype == torch.float32


def test_min_max_with_numbers():
    """``Min``/``Max`` over tensors and numbers (SBML's min/max MathML),
    against numpy. The reference's ``from_sympy`` cannot evaluate them
    (its lambdified ``amin`` of a tuple raises ``TypeError``; ROADMAP
    Queue 3), so numpy is the oracle here."""
    x, y = sp.symbols("x y")
    k = sp.Symbol("k")
    m = from_sympy("minmax", states=[x, y], params=[k],
                   odes=[sp.Min(x, 2, k), sp.Max(y, 1) + sp.Min(x, y)],
                   y0=[1.0, 0.5])
    rng = np.random.default_rng(2)
    yv = rng.uniform(0.0, 3.0, size=(8, 2))
    kv = rng.uniform(0.0, 3.0, size=(8, 1))
    got = m.rhs(torch.zeros(8, dtype=torch.float64), torch.as_tensor(yv),
                torch.as_tensor(kv)).numpy()
    ref = np.stack([np.minimum(np.minimum(yv[:, 0], 2.0), kv[:, 0]),
                    np.maximum(yv[:, 1], 1.0) + yv.min(1)], axis=1)
    np.testing.assert_array_equal(got, ref)
    J = batched_jacobian(lambda yy: m.rhs(
        torch.zeros(8, dtype=torch.float64), yy, torch.as_tensor(kv)),
        torch.as_tensor(yv)).numpy()
    assert np.isfinite(J).all()


def test_one_ode_per_state():
    x = sp.Symbol("x")
    with pytest.raises(ValueError, match="one ODE per state"):
        from_sympy("bad", [x], [], [x, x], [1.0])
