"""Multiple shooting: the K windows of one trajectory integrated as a batch.

Port of ``tpusysbio/solvers/multishoot.py``. ``[t0, tf]`` splits into K
windows whose start states z are extra unknowns; the windows are the
stepper's members (per-member ``t_span`` ends), and the continuity
defects ``y_k(t_{k+1}) − z_{k+1}`` with their exact Jacobian come from the
windows' sensitivity columns [P parameters | n window-start states],
``s0 = [0 | I]``. ``ShootingProblem`` assembles them for a Newton or LM
solve.

Every callable is batched as in the rest of the port: ``f_p(t, y, p)``
takes ``t`` (B,), ``y`` (B, n), ``p`` (B, P); ``y0_fn(p)`` takes (B, P).
The problem's own ``p`` is one parameter vector (P,), repeated over the
windows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpusysbio_torch import resolve_device
from tpusysbio_torch.config import SolverConfig
from tpusysbio_torch.solvers.bdf import bdf_solve


def window_grid(t_span, n_windows: int, dtype=torch.float64, device="cuda"):
    """Equispaced window boundaries: (K+1,) times on ``device`` (the card
    by default; ``device="cpu"`` for the CPU)."""
    return torch.linspace(float(t_span[0]), float(t_span[1]), n_windows + 1,
                          dtype=dtype, device=resolve_device(device))


def integrate_windows(
    f: Callable,
    boundaries: torch.Tensor,    # (K+1,)
    z: torch.Tensor,             # (K, n) window-start states
    config: SolverConfig = SolverConfig(),
    sens_rhs: Optional[Callable] = None,
    n_params: int = 0,
):
    """Integrate all K windows as one batch; ``f`` and ``sens_rhs`` are
    batched over the K windows.

    Returns ``(y_end, S_end, status)``: ``y_end`` (K, n) the state at each
    window's right boundary, ``S_end`` (K, n, P+n) its sensitivities to
    [params | window-start state] (P = ``n_params``; (K, n, 0) without
    ``sens_rhs``), ``status`` (K,).
    """
    K, n = z.shape
    t_lo, t_hi = boundaries[:-1], boundaries[1:]
    t_eval = t_hi[:, None]
    if sens_rhs is None:
        res = bdf_solve(f, (t_lo, t_hi), z, t_eval, config=config)
        return res.ys[:, 0], z.new_zeros((K, n, 0)), res.status
    P = n_params

    def combined_rhs(t, y, S):
        # parameter columns: dS/dt = J S + F_p; state columns: J S, one jvp
        # of f in y per column
        dSp = sens_rhs(t, y, S[..., :P])
        dSz = torch.func.vmap(
            lambda col: torch.func.jvp(lambda yy: f(t, yy), (y,), (col,))[1],
            in_dims=2, out_dims=2)(S[..., P:])
        return torch.cat([dSp, dSz], dim=-1)

    s0 = torch.cat([z.new_zeros((K, n, P)),
                    torch.eye(n, dtype=z.dtype, device=z.device)
                    .expand(K, n, n)], dim=-1)
    res = bdf_solve(f, (t_lo, t_hi), z, t_eval, config=config,
                    sens_rhs=combined_rhs, s0=s0)
    return res.ys[:, 0], res.sens[:, 0], res.status


class ShootingProblem:
    """Joint (params, window-states) least-squares assembly.

    Unknowns: x = [p (P) ; z_1..z_{K-1} (n each)]. The problem contributes
    the weighted continuity defects and their exact Jacobian from the
    windows' sensitivities.
    """

    def __init__(self, f_p: Callable, t_span, y0_fn: Callable,
                 n_windows: int, n_params: int,
                 config: SolverConfig = SolverConfig(),
                 weight: float = 1.0):
        self.f_p = f_p            # f(t, y, p), batched
        self.t_span = t_span
        self.y0_fn = y0_fn        # (B, P) -> (B, n)
        self.K = n_windows
        self.P = n_params
        self.config = config
        self.weight = weight

    def _f(self, p, batch):
        pb = p[None].expand(batch, -1).contiguous()
        return (lambda t, y: self.f_p(t, y, pb)), pb

    def init_z(self, p: torch.Tensor) -> torch.Tensor:
        """Window start states from one coarse serial pass: (K, n)."""
        y0 = self.y0_fn(p[None])
        bounds = window_grid(self.t_span, self.K, y0.dtype, y0.device)
        cfg = SolverConfig(rtol=1e-3, atol=1e-6,
                           max_steps=self.config.max_steps)
        f, _ = self._f(p, 1)
        res = bdf_solve(f, self.t_span, y0, bounds[:-1], config=cfg)
        return res.ys[0]

    def defects_and_jac(self, p: torch.Tensor, z_tail: torch.Tensor):
        """Continuity defects (K-1, n) and their Jacobians in (p, z).

        ``z_tail`` (K-1, n) are the start states of windows 1..K-1;
        window 0 starts at ``y0_fn(p)``. Returns ``(defects, dD_dp (K-1,
        n, P), Jz ((K-1)n, (K-1)n), status (K,))``."""
        from tpusysbio_torch.sens import make_sens_rhs

        y0 = self.y0_fn(p[None])[0]
        n = y0.shape[0]
        z = torch.cat([y0[None], z_tail], dim=0)
        bounds = window_grid(self.t_span, self.K, y0.dtype, y0.device)
        f, pb = self._f(p, self.K)
        y_end, S_end, status = integrate_windows(
            f, bounds, z, config=self.config,
            sens_rhs=make_sens_rhs(self.f_p, pb), n_params=self.P)

        w = self.weight
        defects = w * (y_end[:-1] - z_tail)
        dD_dp = w * S_end[:-1, :, :self.P]
        dEnd_dz = S_end[:-1, :, self.P:]
        # window 0 starts at y0(p): its chain rule folds into dD_dp
        dy0_dp = torch.func.jacfwd(lambda pp: self.y0_fn(pp[None])[0])(p)
        dD_dp = torch.cat([dD_dp[:1] + w * (dEnd_dz[0] @ dy0_dp)[None],
                           dD_dp[1:]], dim=0)

        # defect k depends on z_k (z_tail index k-1) and z_{k+1} (index k)
        Km1 = self.K - 1
        Jz = torch.zeros((Km1, n, Km1, n), dtype=y0.dtype, device=y0.device)
        eye = torch.eye(n, dtype=y0.dtype, device=y0.device)
        for k in range(Km1):
            if k >= 1:
                Jz[k, :, k - 1, :] = w * dEnd_dz[k]
            Jz[k, :, k, :] += -w * eye
        return defects, dD_dp, Jz.reshape(Km1 * n, Km1 * n), status
