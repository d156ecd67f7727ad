"""The JAK-STAT two-dose ensemble fit in plain PyTorch (float64) and SciPy.

The model of ``portbench/configs/jakstat.json`` (Swameye et al. 2003, as
the configuration lists its departures): four states, four reactions

    r1 = k1 u(t) x1,  r2 = k2 x2^2,  r3 = k3 x3,  r4 = k4 x4,
    u(t) = amp (t/tau) exp(1 - t/tau),

    dx/dt = N r,  N = [[-1, 0, 0, 2], [1, -2, 0, 0], [0, 1, -1, 0],
                       [0, 0, 1, -1]]  (states by reactions),

and two relative observables, pSTAT ``x2 + 2 x3`` and total cytoplasmic
STAT ``x1 + x2 + 2 x3``. The state Jacobian, ``df/dp`` and the second
derivatives that couple the sensitivity columns to the state are written
out by hand from the rates, with no automatic differentiation: the
program under test takes all of them by forward-mode AD.

``sens_solve`` integrates the state and its sensitivities along parameter
directions ``C = dp/dtheta`` with SciPy's BDF at ``reference/solve.py``'s
tolerance; ``sens_dtype`` rounds the columns to a lower precision as
``reference/solve.py`` does (the comparison's control). ``evaluate``
assembles the fit's residuals ``(B_g obs - data) / sigma`` over both doses,
with each observable's scale factor ``B_g`` pooled over the doses in
closed form, and their Jacobian ``(B_g dobs + obs dB_g) / sigma``.
``python -m portbench.reference.jakstat`` writes the fit's data,
``portbench/data/jakstat_fit.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from scipy.integrate import solve_ivp

from portbench.reference.solve import ATOL, RTOL, _rounder

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HERE = Path(__file__).resolve().parents[1]
F64 = torch.float64
PARAMS = ("k1", "k2", "k3", "k4", "amp", "tau")
N = torch.tensor([[-1.0, 0.0, 0.0, 2.0],
                  [1.0, -2.0, 0.0, 0.0],
                  [0.0, 1.0, -1.0, 0.0],
                  [0.0, 0.0, 1.0, -1.0]], dtype=F64)
H = torch.tensor([[0.0, 1.0, 2.0, 0.0],
                  [1.0, 1.0, 2.0, 0.0]], dtype=F64)


def _input(t, amp, tau):
    """``u``, ``du/damp`` and ``du/dtau`` of the pulse at time ``t``."""
    x = t / tau
    e = torch.exp(1.0 - x)
    return amp * x * e, x * e, amp * e * x * (x - 1.0) / tau


def rates(t, y, p):
    """The four reaction rates (4,)."""
    k1, k2, k3, k4, amp, tau = p
    u = _input(t, amp, tau)[0]
    x1, x2, x3, x4 = y
    return torch.stack([k1 * u * x1, k2 * x2 * x2, k3 * x3, k4 * x4])


def rhs(t, y, p):
    """``dx/dt`` (4,) at the state ``y`` (4,) and parameters ``p`` (6,)."""
    return N @ rates(t, y, p)


def drdy(t, y, p):
    """``d r / d y`` (reactions by states)."""
    k1, k2, k3, k4, amp, tau = p
    u = _input(t, amp, tau)[0]
    z = torch.zeros((), dtype=F64)
    return torch.stack([torch.stack([k1 * u, z, z, z]),
                        torch.stack([z, 2.0 * k2 * y[1], z, z]),
                        torch.stack([z, z, k3, z]),
                        torch.stack([z, z, z, k4])])


def drdp(t, y, p):
    """``d r / d p`` (reactions by the 6 parameters)."""
    k1, k2, k3, k4, amp, tau = p
    u, du_amp, du_tau = _input(t, amp, tau)
    x1, x2, x3, x4 = y
    z = torch.zeros((), dtype=F64)
    return torch.stack([
        torch.stack([u * x1, z, z, z, k1 * du_amp * x1, k1 * du_tau * x1]),
        torch.stack([z, x2 * x2, z, z, z, z]),
        torch.stack([z, z, x3, z, z, z]),
        torch.stack([z, z, z, x4, z, z])])


def jac(t, y, p):
    """The state Jacobian ``df/dy`` (4, 4)."""
    return N @ drdy(t, y, p)


def dfdp(t, y, p):
    """``df/dp`` (4, 6)."""
    return N @ drdp(t, y, p)


def _coupling(t, y, p, S, C):
    """``d/dy_l [(df/dy) S + (df/dp) C]`` as (4, K, 4): the rates' second
    derivatives, ``d2 r2 / dx2^2 = 2 k2`` and ``d2 r / dp dy`` (each
    rate is linear in its parameter and in ``x1`` for r1)."""
    k1, k2, k3, k4, amp, tau = p
    u, du_amp, du_tau = _input(t, amp, tau)
    K = S.shape[1]
    d2y = torch.zeros((4, K, 4), dtype=F64)          # reactions, K, l
    d2y[1, :, 1] = 2.0 * k2 * S[1]
    dpdy = torch.zeros((4, 6, 4), dtype=F64)         # reactions, p, l
    dpdy[0, 0, 0] = u
    dpdy[0, 4, 0] = k1 * du_amp
    dpdy[0, 5, 0] = k1 * du_tau
    dpdy[1, 1, 1] = 2.0 * y[1]
    dpdy[2, 2, 2] = 1.0
    dpdy[3, 3, 3] = 1.0
    per_rate = d2y + torch.einsum("rql,qk->rkl", dpdy, C)
    return torch.einsum("ir,rkl->ikl", N, per_rate)


def observables(ys):
    """pSTAT and total cytoplasmic STAT of states ``ys`` (..., 4)."""
    return ys @ H.T


def sens_solve(p, t_span, t_eval, y0, C, sens_dtype=None):
    """``(ys (T, 4), S (T, 4, K))`` at ``t_eval`` for parameters ``p``
    (6,) along the directions ``C`` (6, K); ``S(0) = 0`` (``y0`` does not
    depend on p)."""
    p = torch.as_tensor(np.asarray(p, dtype=np.float64))
    C = torch.as_tensor(np.asarray(C, dtype=np.float64))
    K = C.shape[1]
    rnd = _rounder(sens_dtype)

    def split(z):
        return (torch.from_numpy(z[:4]),
                torch.from_numpy(rnd(z[4:].reshape(4, K))))

    def fun(t, z):
        y, S = split(z)
        tt = torch.tensor(t, dtype=F64)
        dS = jac(tt, y, p) @ S + dfdp(tt, y, p) @ C
        return np.concatenate([rhs(tt, y, p).numpy(),
                               rnd(dS.numpy()).reshape(-1)])

    def full_jac(t, z):
        y, S = split(z)
        tt = torch.tensor(t, dtype=F64)
        J = jac(tt, y, p)
        out = torch.zeros((4 * (1 + K), 4 * (1 + K)), dtype=F64)
        out[:4, :4] = J
        if K:
            out[4:, :4] = _coupling(tt, y, p, S, C).reshape(4 * K, 4)
            out[4:, 4:] = torch.kron(J, torch.eye(K, dtype=F64))
        return out.numpy()

    z0 = np.concatenate([np.asarray(y0, dtype=np.float64), np.zeros(4 * K)])
    atol = ATOL
    if sens_dtype is not None:
        # rounded columns carry their rounding as noise: the error control
        # holds the state alone, as the program's does by default
        atol = np.concatenate([np.full(4, atol), np.full(4 * K, 1e30)])
    sol = solve_ivp(fun, t_span, z0, method="BDF", t_eval=t_eval,
                    rtol=RTOL, atol=atol, jac=full_jac)
    if sol.status != 0:
        raise RuntimeError(f"reference integration failed: {sol.message}")
    z = sol.y.T
    return z[:, :4], rnd(z[:, 4:].reshape(len(z), 4, K))


def parameters(spec: dict, theta, e: int):
    """Experiment ``e``'s model parameters (6,) at ``theta`` (the shared
    parameters' logarithms, then each local one's, dose by dose) and the
    chain ``dp/dtheta`` (6, G)."""
    theta = np.asarray(theta, dtype=np.float64)
    shared, local = spec["shared"], spec["local"]
    E = len(spec["experiments"])
    p = np.zeros(len(PARAMS))
    C = np.zeros((len(PARAMS), len(theta)))
    for i, name in enumerate(PARAMS):
        if name in shared:
            g = shared.index(name)
        elif name in local:
            g = len(shared) + local.index(name) * E + e
        else:
            p[i] = spec["fixed"][name]
            continue
        p[i] = np.exp(theta[g])
        C[i, g] = p[i]
    return p, C


def theta_true(spec: dict) -> np.ndarray:
    """The shared parameters' true logarithms, then each local one's,
    dose by dose."""
    true = spec["true"]
    return np.log(np.concatenate([[true[n] for n in spec["shared"]]]
                                 + [true[n] for n in spec["local"]]))


def scale_factors(sim, dsim, data, w):
    """Each observable's scale factor pooled over the doses, and its
    gradient: ``sim``, ``data`` (E, n_obs, T), ``dsim`` (E, n_obs, T, G),
    ``w`` (n_obs,) the inverse variances. ``B = sum(w sim data) / sum(w
    sim^2)``; ``dB = (sum(w dsim data) - 2 B sum(w sim dsim)) / sum(w
    sim^2)``. Returns ``B`` (n_obs,) and ``dB`` (n_obs, G)."""
    den = np.einsum("eot,o->o", sim * sim, w)
    B = np.einsum("eot,o->o", sim * data, w) / den
    if dsim is None:
        return B, None
    dnum = np.einsum("eotg,eot,o->og", dsim, data, w)
    dden = np.einsum("eotg,eot,o->og", dsim, sim, w)
    return B, (dnum - 2.0 * B[:, None] * dden) / den[:, None]


def evaluate(spec: dict, data: dict, theta, with_jac: bool,
             sens_dtype=None) -> dict:
    """The fit at ``theta``: residuals ``r`` ordered dose by dose, then
    observable by observable over the data's times (the port's
    ``Project`` order); with ``with_jac`` their Jacobian ``J`` (rows, G),
    and the scale factors ``B`` with ``dB`` (None without)."""
    theta = np.asarray(theta, dtype=np.float64)
    G = len(theta)
    t = np.asarray(data["times"], dtype=np.float64)
    sims, dsims = [], []
    for e in range(len(spec["experiments"])):
        p, C = parameters(spec, theta, e)
        ys, S = sens_solve(p, (spec["t_span"][0], float(t[-1])), t,
                           spec["y0"],
                           C if with_jac else np.zeros((len(PARAMS), 0)),
                           sens_dtype=sens_dtype)
        sims.append(observables(torch.from_numpy(ys)).numpy().T)
        if with_jac:
            dsims.append(np.einsum("oi,tik->otk", H.numpy(), S))
    sim = np.stack(sims)                                  # (E, n_obs, T)
    dsim = np.stack(dsims) if with_jac else None
    values = np.asarray(data["values"], dtype=np.float64)
    sigma = np.asarray(data["sigma"], dtype=np.float64)   # (n_obs,)
    B, dB = scale_factors(sim, dsim, values, 1.0 / sigma ** 2)
    s = sigma[None, :, None]
    r = ((B[None, :, None] * sim - values) / s).reshape(-1)
    J = None
    if with_jac:
        J = ((B[None, :, None, None] * dsim
              + sim[..., None] * dB[None, :, None, :])
             / s[..., None]).reshape(-1, G)
    return dict(r=r, J=J, B=B, dB=dB)


def residual_job(spec: dict, data: dict, theta, with_jac: bool,
                 sens_dtype=None):
    """``(r, J or None)`` of ``evaluate``, for a worker process. Without
    the Jacobian (a trial point of an LM step) a parameter set at which
    the integration fails gives infinite residuals, a cost LM rejects."""
    try:
        out = evaluate(spec, data, theta, with_jac, sens_dtype)
    except RuntimeError:
        if with_jac:
            raise
        return np.full(np.size(data["values"]), np.inf), None
    return out["r"], out["J"]


def make_fit_data(spec: dict) -> dict:
    """The observables of each dose at the true parameters, integrated at
    rtol 1e-10, times the true scale factors, with relative noise
    ``sigma_share`` from ``numpy.random.default_rng(noise_seed)`` drawn
    dose by dose, observable by observable; each observable's sigma is
    ``sigma_share`` of its true scale factor."""
    t = np.asarray(spec["times"], dtype=np.float64)
    rng = np.random.default_rng(spec["noise_seed"])
    scale = np.asarray(spec["scale_true"], dtype=np.float64)
    share = float(spec["sigma_share"])
    theta = theta_true(spec)
    values = []
    for e in range(len(spec["experiments"])):
        p, _ = parameters(spec, theta, e)
        ys, _ = sens_solve(p, tuple(spec["t_span"]), t, spec["y0"],
                           np.zeros((len(PARAMS), 0)))
        obs = observables(torch.from_numpy(ys)).numpy()      # (T, n_obs)
        values.append([(scale[g] * obs[:, g]
                        * (1.0 + rng.normal(scale=share, size=len(t))))
                       .tolist() for g in range(len(scale))])
    return {"config": "jakstat", "times": t.tolist(),
            "experiments": list(spec["experiments"]),
            "scale_groups": list(spec["scale_groups"]),
            "values": values, "sigma": (share * scale).tolist()}


def main():
    with open(HERE / "configs" / "jakstat.json") as fh:
        spec = json.load(fh)["ensemble"]
    out = HERE / "data" / spec["data"]
    with open(out, "w") as fh:
        json.dump(make_fit_data(spec), fh, indent=1)
        fh.write("\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
