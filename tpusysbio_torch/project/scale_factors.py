"""Analytic optimal scale factors for relative measurements.

Port of ``tpusysbio/project/scale_factors.py``. Relative data (arbitrary
units) is matched to simulation through a per-group scale factor B with a
closed-form optimum for the weighted least-squares inner problem::

    B_g = Σ_i (sim_i · data_i / σ_i²) / Σ_i (sim_i² / σ_i²)   over group g

and the Jacobian of the residuals needs ``dB/dθ`` by the chain rule::

    dB = (Σ (dsim · data / σ²) − 2 B Σ (sim · dsim / σ²)) / Σ (sim² / σ²)

All sums are masked segment sums over a static group-id array (group -1 =
absolute data, B ≡ 1), pooled across the whole experiment batch. ``sim``
and ``dsim`` carry a leading start dimension N.

The segment sum is ``index_add_`` along the residual axis into a fresh
zero tensor. On the CPU it adds in index order and is deterministic. On
the card ``index_add_`` uses atomic adds, whose order changes from run to
run: in f64 the sums can differ at the level of one unit in the last place.
"""

from __future__ import annotations

import torch


def _seg(x, group, n_groups):
    """Sum ``x`` (N, R, ...) over the rows of each group -> (N, Gp, ...)."""
    out = torch.zeros((x.shape[0], max(n_groups, 1)) + x.shape[2:],
                      dtype=x.dtype, device=x.device)
    return out.index_add_(1, group, x)


def _weights(inv_var, group, mask):
    zero = torch.zeros((), dtype=inv_var.dtype, device=inv_var.device)
    w = torch.where(mask & (group >= 0), inv_var, zero)
    return w, torch.clamp(group, min=0).long()


def scale_factors(sim, data, inv_var, group, mask, n_groups):
    """Optimal B per group. ``sim`` is (N, R); ``data``, ``inv_var``,
    ``group``, ``mask`` are flat (R,); returns (N, n_groups).

    ``group`` entries are in [-1, n_groups); -1/masked entries contribute
    nothing (clipped index + zero weight).
    """
    w, g = _weights(inv_var, group, mask)
    num = _seg(w * sim * data, g, n_groups)
    den = _seg(w * sim * sim, g, n_groups)
    return num / torch.where(den > 0, den, torch.ones_like(den))


def scale_factors_and_grad(sim, dsim, data, inv_var, group, mask, n_groups):
    """B (N, n_groups) and dB/dθ (N, n_groups, G) for ``dsim`` of shape
    (N, R, G)."""
    w, g = _weights(inv_var, group, mask)
    num = _seg(w * sim * data, g, n_groups)
    den = _seg(w * sim * sim, g, n_groups)
    den_safe = torch.where(den > 0, den, torch.ones_like(den))
    B = num / den_safe

    dnum = _seg(w[:, None] * dsim * data[:, None], g, n_groups)
    dden = 2.0 * _seg(w[:, None] * dsim * sim[..., None], g, n_groups)
    dB = (dnum - B[..., None] * dden) / den_safe[..., None]
    return B, dB
