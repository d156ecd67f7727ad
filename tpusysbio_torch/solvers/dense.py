"""Post-hoc continuous solution of a batch (SciPy's ``OdeSolution``).

Port of ``tpusysbio/solvers/dense.py``. ``bdf_solve(...,
dense_export=True)`` (``OdeModel.simulate(dense_output=True)``) records
each accepted step's interpolant ``(t_new, h, order, D[:MAX_ORDER+1])``;
:class:`OdeSolution` evaluates the same ``BdfDenseOutput`` polynomial at
arbitrary times, for every member, in f64 on the result's device: each
member's times are located in its own ``seg_t`` by ``searchsorted``.

The recorded polynomial is the one the stepper evaluates at ``t_eval``,
so ``sol(t_eval)`` reproduces ``result.ys`` to rounding.
"""

from __future__ import annotations

import torch

MAX_ORDER = 5


class OdeSolution:
    """Piecewise-polynomial continuous solution of every member of a
    dense-export run.

    ``sol(t)`` returns the states and ``sol.sens(t)`` the sensitivity
    columns; ``t`` is a float, a (T,) grid shared by the members or a
    (B, T) grid per member. A time maps to the accepted step whose
    interval holds it; times outside ``[t0, t_final]`` evaluate the
    nearest boundary step's polynomial, as SciPy's do.
    """

    def __init__(self, result):
        if result.seg_t is None:
            raise ValueError(
                "result carries no dense-export buffers: integrate with "
                "dense_export=True (bdf_solve) / dense_output=True "
                "(OdeModel.simulate)")
        nacc = result.naccepted.to(torch.int64)
        if bool((nacc == 0).any()):
            raise ValueError("a member has no accepted steps to interpolate")
        f64 = torch.float64
        self.nacc = nacc
        self.ts = result.seg_t.to(f64)
        self.hs = result.seg_h.to(f64)
        self.orders = result.seg_order
        parts = (result.seg_D if isinstance(result.seg_D, tuple)
                 else (result.seg_D,))
        # (B, S, MAX_ORDER+1, n, 1+m): state column 0, sensitivities 1..
        self.D = torch.cat([p.to(f64) for p in parts], dim=-1)
        self.B = self.D.shape[0]
        self.n = self.D.shape[3]
        self.n_cols = self.D.shape[4]
        self.t_max = self.ts.gather(1, (nacc - 1)[:, None])[:, 0]

    def _eval(self, t):
        t = torch.as_tensor(t, dtype=torch.float64, device=self.ts.device)
        scalar = t.ndim == 0
        if t.ndim <= 1:
            t = t.reshape(1, -1).expand(self.B, -1)
        t = t.contiguous()
        # the first accepted step with t_hi >= t, clamped to each member's
        # accepted steps (the unfilled slots hold +inf)
        seg = torch.searchsorted(self.ts.contiguous(), t, right=False)
        seg = torch.minimum(seg, (self.nacc - 1)[:, None])
        t_hi = self.ts.gather(1, seg)
        h = self.hs.gather(1, seg)
        k = self.orders.gather(1, seg)
        j = torch.arange(MAX_ORDER, dtype=torch.float64,
                         device=t.device)
        x = ((t[..., None] - (t_hi[..., None] - h[..., None] * j))
             / (h[..., None] * (1.0 + j)))
        cols = [x[..., 0]]
        for i in range(1, MAX_ORDER):
            cols.append(cols[-1] * x[..., i])
        p = torch.stack(cols, dim=-1)
        p = torch.where(j + 1 <= k[..., None], p, torch.zeros_like(p))
        bi = torch.arange(self.B, device=t.device)[:, None]
        D = self.D[bi, seg]                  # (B, T, MAX_ORDER+1, n, K)
        vals = D[:, :, 0] + torch.einsum("btj,btjnk->btnk", p, D[:, :, 1:])
        return vals[:, 0] if scalar else vals

    def __call__(self, t):
        """States at ``t``: (B, n) for a float, (B, T, n) for a grid."""
        return self._eval(t)[..., 0]

    def sens(self, t):
        """Sensitivities at ``t``: (B, n, m) or (B, T, n, m)."""
        if self.n_cols < 2:
            raise ValueError("run carried no sensitivity columns")
        return self._eval(t)[..., 1:]
