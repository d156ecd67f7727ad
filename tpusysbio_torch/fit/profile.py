"""Profile likelihood: identifiability analysis around a fitted optimum.

Port of ``tpusysbio/fit/profile.py``. For each parameter θᵢ every other
parameter is re-optimized while θᵢ is pinned to a grid of values around
the optimum; the cost curve (the profile) gives likelihood-ratio
confidence intervals and shows flat, non-identifiable directions (Raue et
al. 2009).

Every (parameter, direction) pair is a chain that walks outward from the
optimum, each grid point warm-started from the previous point's optimum.
The 2·P chains are one batch of the batched LM (optim/lm.py), and a Python
loop over the grid points takes the place of the reference's ``lax.scan``.
Pinning is expressed inside LM: the residual is evaluated at
``pin(θ) = θ·(1−e_i) + v·e_i`` and the pinned Jacobian column is masked to
zero, so the damped normal equations give δᵢ = 0 and one batch serves all
parameters. ``mesh=`` (``utils.make_mesh``) splits the 2·P chains over its
ranks; their curves are gathered onto every rank.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tpusysbio_torch.config import FitConfig
from tpusysbio_torch.optim.lm import lm_init, lm_run
from tpusysbio_torch.utils import gather_multihost


class ProfileResult(NamedTuple):
    """Profile curves for P parameters on a (2·n_points+1)-point grid.

    Rows are sorted ascending in the pinned value; the center column
    (index ``n_points``) is the unconstrained optimum itself.
    """
    idx: np.ndarray            # (P,) profiled parameter indices into θ
    values: torch.Tensor       # (P, 2n+1) pinned θᵢ values, ascending
    costs: torch.Tensor        # (P, 2n+1) re-optimized 0.5·||r||²
    thetas: torch.Tensor       # (P, 2n+1, G) re-optimized θ per point
    status: torch.Tensor       # (P, 2n+1) LM status (center = 1)
    cost_opt: torch.Tensor     # scalar: cost at the unconstrained optimum


def profile_likelihood(
    residual_fn: Callable,
    residual_and_jac_fn: Callable,
    theta_opt: torch.Tensor,
    idx=None,
    n_points: int = 8,
    span=2.0,
    config: FitConfig = FitConfig(),
    mesh=None,
) -> ProfileResult:
    """Profile the cost around ``theta_opt`` (G,), a fitted optimum.

    Args:
      residual_fn / residual_and_jac_fn: the batched callables a fit uses
        (``θ (N, G) -> r (N, R)`` and ``θ -> (r, J (N, R, G))``), e.g. from
        ``Project``.
      idx: parameter indices to profile (default: all G).
      n_points: grid points per direction (2·n_points+1 per row).
      span: half-width of the window in θ (log) units, scalar or (P,).
      mesh: split the 2·P chains over the mesh's ranks (its size must
        divide 2·P); every rank returns the whole result.

    Returns a :class:`ProfileResult`; :func:`confidence_intervals` turns it
    into likelihood-ratio intervals.
    """
    theta_opt = torch.as_tensor(theta_opt)
    dtype, dev = theta_opt.dtype, theta_opt.device
    G = theta_opt.shape[0]
    idx = np.asarray(np.arange(G) if idx is None else idx, np.int32)
    n_p = int(idx.shape[0])
    span_arr = np.broadcast_to(np.asarray(span, np.float64), (n_p,))
    delta = torch.as_tensor(span_arr / n_points, dtype=dtype, device=dev)
    onehots = torch.as_tensor(np.eye(G)[idx], dtype=dtype, device=dev)

    # chain axis: [+dir rows..., -dir rows...], each member pins its own
    # column
    ohs = torch.cat([onehots, onehots])                       # (2P, G)
    step = torch.cat([delta, -delta])                         # (2P,)
    if mesh is not None:
        # this rank's block of chains
        mine = mesh.block(2 * n_p)
        ohs, step = ohs[mine], step[mine]
    center = ohs @ theta_opt                                  # (2P,)
    keep = 1.0 - ohs

    def pin(th, v):
        return th * keep + v[:, None] * ohs

    values, costs, status, thetas = [], [], [], []
    theta = theta_opt.expand(ohs.shape[0], G).clone()
    for k in range(1, n_points + 1):
        v = center + step * k

        def r_fn(th):
            return residual_fn(pin(th, v))

        def rj_fn(th):
            r, J = residual_and_jac_fn(pin(th, v))
            return r, J * keep[:, None, :]

        # lm_init + lm_run, not lm_fit: lm_finish's covariance solve would
        # meet the masked column's singular JᵀJ, and nothing here uses it
        st = lm_init(rj_fn, pin(theta, v), config)
        st = lm_run(r_fn, rj_fn, st, config)
        theta = pin(st.theta, v)
        values.append(v)
        costs.append(st.cost)
        status.append(st.status)
        thetas.append(theta)
    values, costs, status, thetas = (torch.stack(x, dim=1) for x in
                                     (values, costs, status, thetas))
    if mesh is not None:
        values, costs, status, thetas = gather_multihost(
            (values, costs, status, thetas), mesh)

    r0 = residual_fn(theta_opt[None])[0]
    cost_opt = 0.5 * torch.sum(r0 * r0)

    # ascending rows: reversed(-dir) | center | +dir
    def rows(x, center_col):
        return torch.cat([x[n_p:].flip(1), center_col[:, None], x[:n_p]],
                         dim=1)

    ix = torch.as_tensor(idx, dtype=torch.long, device=dev)
    vals = rows(values, theta_opt[ix])
    cs = rows(costs, cost_opt.expand(n_p))
    sts = rows(status, torch.ones(n_p, dtype=status.dtype, device=dev))
    ths = rows(thetas, theta_opt.expand(n_p, G))
    return ProfileResult(idx=idx, values=vals, costs=cs, thetas=ths,
                         status=sts, cost_opt=cost_opt)


def confidence_intervals(result: ProfileResult, level: float = 0.95):
    """Likelihood-ratio CIs from profile curves (on the host).

    The profile crosses ``cost* + 0.5·χ²₁(level)`` (cost is 0.5·||r||², so
    2·Δcost is the likelihood-ratio statistic; Raue et al. 2009 eq. 6).
    Crossings are found by interpolating the likelihood root
    ``w = sqrt(2·Δcost)``, exactly linear in the pinned value for a
    quadratic profile. A direction that never reaches the threshold inside
    the window gives ±inf, the practical non-identifiability signal.

    Returns a (P, 2) array of [lower, upper] bounds in θ space. The
    reference cost is ``min(cost_opt, costs.min())``: warm-started pinned
    re-fits may dip marginally below the center. A ``UserWarning`` is
    emitted when a grid point on a crossed segment has LM status ≤ 0.
    """
    import warnings

    from scipy.stats import chi2

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    values, costs, status = (host(result.values), host(result.costs),
                             host(result.status))
    ref_cost = min(float(result.cost_opt), float(costs.min()))
    w = np.sqrt(2.0 * np.clip(costs - ref_cost, 0.0, None))
    w_thr = float(np.sqrt(chi2.ppf(level, df=1)))
    n_p, n_grid = costs.shape
    center = n_grid // 2
    out = np.empty((n_p, 2))

    def _check_converged(p, j0, j1, side):
        if status[p, j0] <= 0 or status[p, j1] <= 0:
            warnings.warn(
                f"profile CI for parameter row {p} ({side} bound): a grid "
                "point on the crossed segment did not converge (LM status "
                "<= 0); the interpolated bound may be spuriously narrow.",
                UserWarning, stacklevel=2)

    for p in range(n_p):
        lo, hi = -np.inf, np.inf
        # walk right from the center for the upper bound; the last grid
        # pair accepts a crossing landing exactly on the endpoint
        for j in range(center, n_grid - 1):
            w0, w1 = w[p, j], w[p, j + 1]
            last = j == n_grid - 2
            if w0 <= w_thr and (w_thr < w1 or (last and w_thr <= w1)):
                f = (w_thr - w0) / (w1 - w0) if w1 > w0 else 1.0
                hi = values[p, j] + f * (values[p, j + 1] - values[p, j])
                _check_converged(p, j, j + 1, "upper")
                break
        # walk left for the lower bound
        for j in range(center, 0, -1):
            w0, w1 = w[p, j], w[p, j - 1]
            last = j == 1
            if w0 <= w_thr and (w_thr < w1 or (last and w_thr <= w1)):
                f = (w_thr - w0) / (w1 - w0) if w1 > w0 else 1.0
                lo = values[p, j] + f * (values[p, j - 1] - values[p, j])
                _check_converged(p, j, j - 1, "lower")
                break
        out[p] = (lo, hi)
    return out
