"""Trajectories and forward sensitivities of a frozen network, by SciPy.

``sens_solve`` integrates the state ``y`` together with its sensitivities
``S = dy/dq`` along parameter directions ``C = dk/dq`` (m, K):

    dy/dt = f(y, k)
    dS/dt = (df/dy) S + (df/dk) C,      S(0) = 0 (y0 does not depend on k)

with ``scipy.integrate.solve_ivp`` (BDF) at a tolerance far tighter than
the program's, and the whole system's Jacobian: ``df/dy`` once for the
state and once for each column, and the columns' coupling to the state,
``d/dy [(df/dy) S + (df/dk) C]``, from the rate monomials' second
derivatives.

``sens_dtype`` rounds the sensitivity columns to a lower precision at
every evaluation and at the output, and leaves them out of the error
control: the reference computed in that precision, for the comparison's
control.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.integrate import solve_ivp

from portbench.reference.network import Network

RTOL = 1e-10
ATOL = 1e-14


def _rounder(dtype):
    if dtype is None:
        return lambda x: x
    tdt = getattr(torch, dtype)
    return lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(tdt).to(
        torch.float64).numpy()


def sens_solve(net: Network, k: np.ndarray, t_span, t_eval,
               C: np.ndarray = None, rtol: float = RTOL, atol: float = ATOL,
               sens_dtype: str = None):
    """``(ys (T, n), sens (T, n, K))`` at ``t_eval`` for rates ``k`` (m,).
    ``C`` (m, K) defaults to the identity (all rate constants)."""
    n = net.n
    k = np.asarray(k, dtype=np.float64)
    C = np.eye(net.m) if C is None else np.asarray(C, dtype=np.float64)
    K = C.shape[1]
    rnd = _rounder(sens_dtype)
    eye_k = sp.identity(K, format="csr")

    def fun(t, z):
        y = z[:n]
        if not K:
            return net.rhs(y, k)
        S = rnd(z[n:].reshape(n, K))
        J = net.jac(y, k)
        dS = rnd(J @ S + net.dfdp(y) @ C)
        return np.concatenate([net.rhs(y, k), dS.reshape(-1)])

    def jac(t, z):
        y = z[:n]
        Jd = net.jac(y, k)
        J = sp.csr_matrix(Jd)
        if not K:
            return J.tocsc()
        S = rnd(z[n:].reshape(n, K))
        # d/dy_l of sum_j J_ij S_jk, and of sum_r S_ir mono_r C_rk
        H = np.einsum("rjl,jk->rlk", net.d2mono(y), S)       # (m, n, K)
        couple = (np.einsum("ir,r,rlk->ikl", net.S, k, H)
                  + np.einsum("ir,rl,rk->ikl", net.S, net.dmono(y), C))
        top = sp.hstack([J, sp.csr_matrix((n, n * K))])
        low = sp.hstack([sp.csr_matrix(couple.reshape(n * K, n)),
                         sp.kron(J, eye_k)])
        return sp.vstack([top, low], format="csc")

    z0 = np.concatenate([net.y0, np.zeros(n * K)])
    if sens_dtype is not None:
        # rounded columns carry their rounding as noise: the error control
        # holds the state alone, as the program's does by default
        atol = np.concatenate([np.full(n, atol), np.full(n * K, 1e30)])
    sol = solve_ivp(fun, t_span, z0, method="BDF", t_eval=t_eval,
                    rtol=rtol, atol=atol, jac=jac)
    if sol.status != 0:
        raise RuntimeError(f"reference integration failed: {sol.message}")
    z = sol.y.T                                          # (T, n(1+K))
    return z[:, :n], rnd(z[:, n:].reshape(len(z), n, K))


def solve_job(spec: dict, k, t_span, t_eval, C=None, sens_dtype=None):
    """``sens_solve`` of the network ``spec`` (a configuration's frozen
    copy), for a worker process."""
    return sens_solve(Network(spec), k, t_span, t_eval, C=C,
                      sens_dtype=sens_dtype)


def residual_job(spec: dict, free, data: dict, theta, with_jac: bool,
                 sens_dtype=None):
    """The fit problem's residuals ``(obs(t) - data) / sigma`` at ``theta``
    (the free rate constants' logarithms), rows ordered observable by
    observable, each over the data's times; with ``with_jac`` also their
    Jacobian in ``theta`` (rows, G). Returns ``(r, J or None)``."""
    net = Network(spec)
    k = net.rates.copy()
    cols = [net.reaction_names.index(name) for name in free]
    k[cols] = np.exp(np.asarray(theta, dtype=np.float64))
    t = np.asarray(data["times"], dtype=np.float64)
    G = len(cols)
    C = np.zeros((net.m, G if with_jac else 0))
    if with_jac:
        C[cols, np.arange(G)] = k[cols]             # dk/dtheta
    ys, S = sens_solve(net, k, (0.0, float(t[-1])), t, C=C,
                       sens_dtype=sens_dtype)
    sigma = float(data["sigma"])
    values = np.asarray(data["values"])            # (T, n_obs)
    r = ((net.observables(ys) - values) / sigma).T.reshape(-1)
    if not with_jac:
        return r, None
    J = (S[:, net.obs_rows, :] / sigma).transpose(1, 0, 2).reshape(-1, G)
    return r, J
