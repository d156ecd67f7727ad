"""Fit visualization, the port of ``tpusysbio/viz.py``.

- :func:`plot_fit`: per-experiment trajectory-vs-data panels, measured
  points with error bars against the model curve at θ (fitted scale
  factors applied to the model side);
- :func:`plot_waterfall`: the multi-start diagnostic, sorted final costs;
- :func:`plot_profiles`: profile-likelihood panels with the
  likelihood-ratio threshold line.

Matplotlib is imported on first use under the Agg backend (nothing here
touches a display); without it every function raises ``ImportError``
naming matplotlib. Everything is computed from ``Project.evaluate``
results and numpy copies of the port's tensors, on whatever device they
live.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "tpusysbio_torch.viz needs matplotlib, which is not "
            "installed") from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_fit(proj, theta, n_dense: int = 200, figsize_per_panel=(4.0, 3.0)):
    """Trajectory-vs-data panels, one per experiment.

    The model curve is dense only for experiments without timed inputs /
    pre-equilibration (it comes from a plain ``model.simulate`` on that
    experiment's parameter row); experiments using those features get the
    exact project evaluation at measurement times connected by lines —
    never a curve from the wrong dynamics.

    Returns the matplotlib Figure.
    """
    import torch

    plt = _mpl()
    b = proj.batch
    dev = b.device
    theta = torch.as_tensor(theta, dtype=torch.float64, device=dev)
    ev = proj.evaluate(theta)
    B = _np(ev.scale)
    E = b.t_eval.shape[0]
    p_dev = proj.pmap.expand(theta[None])[0]          # (E, P)

    # exact sim values at measurement points (same gather the residuals
    # use), reconstructed from the residuals: r = (B·sim − data)/σ
    M = b.values.shape[1]
    values, sigmas = _np(b.values), _np(b.sigmas)
    r_data = _np(ev.residuals)[:E * M].reshape(E, M)
    sim_scaled = r_data * sigmas + values

    simple = (b.seg_bounds is None) and (not b.has_preeq)
    ncols = min(E, 3)
    nrows = (E + ncols - 1) // ncols
    fig, axes = plt.subplots(
        nrows, ncols, squeeze=False,
        figsize=(figsize_per_panel[0] * ncols, figsize_per_panel[1] * nrows))

    group = _np(b.group)
    mask = _np(b.mask)
    is_ss = _np(b.m_is_ss)
    t_meas = np.take_along_axis(_np(b.t_eval), _np(b.m_t_idx).astype(
        np.int64), axis=1)
    obs_idx = _np(b.m_obs)

    for e in range(E):
        ax = axes[e // ncols][e % ncols]
        valid = mask[e]
        obs_here = sorted(set(obs_idx[e][valid].tolist()))
        cmap = plt.get_cmap("tab10")
        if simple:
            t0, t1 = float(_np(b.t0)[e]), float(_np(b.t_end)[e])
            td = np.linspace(t0, t1, n_dense)
            p_e = p_dev[e][None]
            res = proj.model.simulate(p_e, (t0, t1), td, config=proj.config,
                                      solver=proj.solver, device=dev)
            # the batched observables over the dense grid's rows
            otraj = _np(proj.model.observables(
                res.ys[0], p_e.expand(n_dense, -1)))
        for j, o in enumerate(obs_here):
            sel = valid & (obs_idx[e] == o) & ~is_ss[e]
            color = cmap(j % 10)
            if sel.any():
                # data in measured units
                ax.errorbar(t_meas[e][sel], values[e][sel],
                            yerr=sigmas[e][sel], fmt="o",
                            ms=3.5, lw=1, color=color, label=f"obs {o}")
                if simple:
                    # scale the model curve into the data's units
                    gsel = group[e][sel]
                    Bg = B[gsel[0]] if gsel[0] >= 0 else 1.0
                    ax.plot(np.asarray(td), Bg * otraj[:, o], "-",
                            color=color, lw=1.2)
                else:
                    order = np.argsort(t_meas[e][sel])
                    ax.plot(t_meas[e][sel][order],
                            sim_scaled[e][sel][order], "-",
                            color=color, lw=1.2)
            sel_ss = valid & (obs_idx[e] == o) & is_ss[e]
            if sel_ss.any():
                ax.errorbar([t_meas[e][sel_ss][-1]] if not sel.any()
                            else [t_meas[e][sel].max()],
                            values[e][sel_ss][:1],
                            yerr=sigmas[e][sel_ss][:1],
                            fmt="s", ms=5, color=color)
        ax.set_title(f"experiment {e}")
        ax.set_xlabel("t")
        ax.legend(fontsize=7)
    for k in range(E, nrows * ncols):
        axes[k // ncols][k % ncols].set_axis_off()
    fig.tight_layout()
    return fig


def plot_waterfall(results, top: Optional[int] = None, ax=None):
    """Sorted-final-cost waterfall over a multi-start result.

    Accepts anything with ``.cost`` and ``.status`` arrays (the
    ``FitResult`` batches returned by ``multistart_fit`` /
    ``TwoPhaseDriver``). Non-converged members (status <= 0 or
    non-finite cost) are drawn greyed at the tail.
    """
    plt = _mpl()
    cost = _np(results.cost).astype(float).ravel()
    status = _np(results.status).ravel()
    ok = (status > 0) & np.isfinite(cost)
    good = np.sort(cost[ok])
    bad_n = int((~ok).sum())
    if top is not None:
        good = good[:top]
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 3.2))
    else:
        fig = ax.figure
    ax.semilogy(np.arange(1, len(good) + 1), good, ".-", ms=3, lw=0.7,
                label=f"{len(good)} converged")
    if bad_n and top is None:
        ax.axvspan(len(good) + 0.5, len(good) + bad_n + 0.5, color="0.85",
                   label=f"{bad_n} failed")
    ax.set_xlabel("start (sorted)")
    ax.set_ylabel("final cost")
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_profiles(prof, names=None, level: float = 0.95, ncols: int = 3):
    """Profile-likelihood panels (one per profiled parameter).

    ``prof`` is a :class:`tpusysbio_torch.fit.ProfileResult`. Each panel draws
    the re-optimized cost curve over the pinned value, the optimum
    (center) marker, and the likelihood-ratio threshold line
    ``cost* + 0.5·χ²₁(level)`` — the curve's crossings ARE the CI bounds
    (fit/profile.py:confidence_intervals); a curve that never reaches the
    line inside the window reads as non-identifiable at a glance.

    Returns the matplotlib Figure.
    """
    from scipy.stats import chi2

    plt = _mpl()
    values = _np(prof.values).astype(float)
    costs = _np(prof.costs).astype(float)
    n_p, n_grid = costs.shape
    center = n_grid // 2
    # LR reference = best cost actually seen (matches
    # fit/profile.py:confidence_intervals — warm-started re-fits can dip
    # marginally below the nominal optimum)
    ref_cost = min(float(prof.cost_opt), float(costs.min()))
    thr = ref_cost + 0.5 * chi2.ppf(level, df=1)
    ncols = min(ncols, n_p)
    nrows = (n_p + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(3.4 * ncols, 2.6 * nrows),
                             squeeze=False)
    for p in range(n_p):
        ax = axes[p // ncols][p % ncols]
        ax.plot(values[p], costs[p], ".-", ms=4, lw=0.9)
        ax.plot(values[p, center], costs[p, center], "o", ms=6,
                mfc="none", color="C1")
        ax.axhline(thr, lw=0.8, ls="--", color="0.4")
        name = (names[p] if names is not None
                else f"theta[{int(_np(prof.idx)[p])}]")
        ax.set_title(name, fontsize=9)
        ax.set_xlabel("pinned value (log space)", fontsize=8)
        ax.tick_params(labelsize=7)
    for q in range(n_p, nrows * ncols):
        axes[q // ncols][q % ncols].axis("off")
    axes[0][0].set_ylabel("profile cost", fontsize=8)
    fig.tight_layout()
    return fig
