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

The segment sum is deterministic on every device: ``segment_index`` lists
each group's rows once, padded to the largest group, and a sum gathers
those rows and reduces along the padded axis (``torch.sum``, whose order is
fixed by the shapes). No atomic adds are involved, so two evaluations of
the same inputs give the same bits on the card as on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class SegmentIndex(NamedTuple):
    """Rows of each scale group: ``rows`` (Gp, L) indices into the residual
    axis and ``valid`` (Gp, L), False on padding (which points at row 0)."""

    rows: torch.Tensor
    valid: torch.Tensor


def segment_index(group: torch.Tensor, n_groups: int) -> SegmentIndex:
    """The padded row lists of ``group`` (R,) for ``n_groups`` groups
    (at least one row of padding per group; rows of group -1 are in no
    list). Reads ``group`` on the host once: build it once per batch."""
    g = group.detach().cpu().numpy().reshape(-1)
    Gp = max(n_groups, 1)
    lists = [np.flatnonzero(g == k) for k in range(Gp)]
    L = max(1, max(len(r) for r in lists))
    rows = np.zeros((Gp, L), dtype=np.int64)
    valid = np.zeros((Gp, L), dtype=bool)
    for k, r in enumerate(lists):
        rows[k, :len(r)] = r
        valid[k, :len(r)] = True
    return SegmentIndex(torch.as_tensor(rows, device=group.device),
                        torch.as_tensor(valid, device=group.device))


def _seg(x, index: SegmentIndex):
    """Sum ``x`` (N, R, ...) over the rows of each group -> (N, Gp, ...)."""
    picked = x[:, index.rows]                         # (N, Gp, L, ...)
    valid = index.valid.reshape(index.valid.shape
                                + (1,) * (x.ndim - 2))
    return torch.where(valid, picked, torch.zeros((), dtype=x.dtype,
                                                  device=x.device)).sum(2)


def _weights(inv_var, group, mask):
    zero = torch.zeros((), dtype=inv_var.dtype, device=inv_var.device)
    return torch.where(mask & (group >= 0), inv_var, zero)


def scale_factors(sim, data, inv_var, group, mask, n_groups,
                  index: Optional[SegmentIndex] = None):
    """Optimal B per group. ``sim`` is (N, R); ``data``, ``inv_var``,
    ``group``, ``mask`` are flat (R,); returns (N, n_groups).

    ``group`` entries are in [-1, n_groups); -1/masked entries contribute
    nothing. ``index`` is ``segment_index(group, n_groups)``, built here
    when not given.
    """
    index = segment_index(group, n_groups) if index is None else index
    w = _weights(inv_var, group, mask)
    num = _seg(w * sim * data, index)
    den = _seg(w * sim * sim, index)
    return num / torch.where(den > 0, den, torch.ones_like(den))


def scale_factors_and_grad(sim, dsim, data, inv_var, group, mask, n_groups,
                           index: Optional[SegmentIndex] = None):
    """B (N, n_groups) and dB/dθ (N, n_groups, G) for ``dsim`` of shape
    (N, R, G)."""
    index = segment_index(group, n_groups) if index is None else index
    w = _weights(inv_var, group, mask)
    num = _seg(w * sim * data, index)
    den = _seg(w * sim * sim, index)
    den_safe = torch.where(den > 0, den, torch.ones_like(den))
    B = num / den_safe

    dnum = _seg(w[:, None] * dsim * data[:, None], index)
    dden = 2.0 * _seg(w[:, None] * dsim * sim[..., None], index)
    dB = (dnum - B[..., None] * dden) / den_safe[..., None]
    return B, dB
