"""Affine-invariant ensemble MCMC (emcee-style stretch move).

Port of ``tpusysbio/fit/mcmc.py``. W walkers advance in lockstep; each
sweep is two half-ensemble updates (the red/black split: each half's
partners come from the other, already-updated half) of elementwise math
plus one batched log-posterior evaluation of W/2 walkers.

Contract notes:
- ``log_prob_fn(theta (W/2, G)) -> (W/2,)`` is batched. For a
  least-squares ``Project``, ``lambda th: -proj.cost(th)`` is the Gaussian
  log-likelihood up to a constant; add log-priors as extra terms.
- Non-finite log-probs are handled as emcee does: a proposal whose
  log-prob is NaN rejects, and a walker at -inf accepts any finite
  proposal.
- An explicit ``torch.Generator`` takes the place of the reference's key:
  the draws are made on the generator's device and used on the device of
  ``x0``, so one seed gives one chain, and a CPU generator gives the same
  draws to a run on the CPU and on the card. Its stream differs from
  JAX's by construction; ``_sweep`` takes explicit draws, so a chain can
  be fed any stream.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class MCMCResult(NamedTuple):
    """``chain``: (n_kept, W, G) post-thinning walker positions;
    ``log_prob``: (n_kept, W); ``acceptance``: (W,) per-walker accepted
    fraction over ALL proposals (thinned or not)."""

    chain: torch.Tensor
    log_prob: torch.Tensor
    acceptance: torch.Tensor

    def flat(self, burn: int = 0) -> torch.Tensor:
        """(n_kept - burn) · W samples, (S, G) — emcee's flatchain."""
        return self.chain[burn:].reshape(-1, self.chain.shape[-1])


def _stretch_half(x_move, lp_move, x_other, log_prob_fn, a, j, u, u_acc):
    """One stretch-move update of ``x_move`` with partners ``x_other[j]``
    (Goodman & Weare 2010 eq. 7; emcee's default move), from the stretch
    uniforms ``u`` and the acceptance uniforms ``u_acc``.

    z ~ g(z) ∝ 1/√z on [1/a, a]  (inverse-CDF: z = ((a-1)u + 1)² / a)
    y = x_j + z (x_k − x_j);  accept with prob min(1, z^{G-1} e^{Δlp}).
    """
    G = x_move.shape[1]
    partners = x_other[j]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    y = partners + z[:, None] * (x_move - partners)
    lp_y = log_prob_fn(y)
    log_ratio = (G - 1) * torch.log(z) + lp_y - lp_move
    log_ratio = torch.where(torch.isnan(lp_y), float("-inf"), log_ratio)
    accept = torch.log(u_acc) < log_ratio
    x_new = torch.where(accept[:, None], y, x_move)
    lp_new = torch.where(accept, lp_y, lp_move)
    return x_new, lp_new, accept


def _sweep(x, lp, log_prob_fn: Callable, a: float, draws):
    """One sweep from explicit draws: ``draws`` holds, for the first and
    the second half in turn, ``(j, u, u_acc)``: the partner indices into
    the other half, the stretch uniforms and the acceptance uniforms, each
    (W/2,). Returns ``(x, lp, accepted)`` after the sweep."""
    half = x.shape[0] // 2
    (ja, ua, aa), (jb, ub, ab) = draws
    xa, lpa, acc_a = _stretch_half(x[:half], lp[:half], x[half:],
                                   log_prob_fn, a, ja, ua, aa)
    xb, lpb, acc_b = _stretch_half(x[half:], lp[half:], xa, log_prob_fn, a,
                                   jb, ub, ab)
    return (torch.cat([xa, xb]), torch.cat([lpa, lpb]),
            torch.cat([acc_a, acc_b]))


def _draws(generator: torch.Generator, half: int, dtype, device):
    """One sweep's draws on the generator's device, moved to ``device``."""
    gdev = generator.device
    out = []
    for _ in range(2):
        j = torch.randint(0, half, (half,), generator=generator, device=gdev)
        u = torch.rand((half,), generator=generator, dtype=dtype,
                       device=gdev)
        u_acc = torch.rand((half,), generator=generator, dtype=dtype,
                           device=gdev)
        out.append(tuple(t.to(device) for t in (j, u, u_acc)))
    return out


def ensemble_sample(log_prob_fn: Callable, x0: torch.Tensor, n_steps: int,
                    generator: torch.Generator, a: float = 2.0,
                    thin: int = 1,
                    log_prob_v: Optional[Callable] = None) -> MCMCResult:
    """Run W walkers for ``n_steps`` stretch-move sweeps from ``x0`` (W, G).

    W must be even and at least 4, and should be ≥ 2·G (emcee guidance).
    ``thin`` keeps every thin-th sweep (sweeps ``thin-1::thin``) and must
    divide ``n_steps``.

    ``log_prob_v`` optionally overrides the batch evaluator ``(W', G) ->
    (W',)`` that scores ``x0`` and both halves of every sweep (by default
    ``log_prob_fn`` itself). It can shard the walker axis, which is
    embarrassingly parallel: on a mesh (``utils.make_mesh``) each rank
    evaluates its block ``mesh.block(W')`` of the rows and
    ``utils.all_gather`` collects the blocks, every rank passing the same
    walkers. The draws still come from ``generator``, so the chain
    depends only on the values the evaluator returns.
    """
    W, G = x0.shape
    if W % 2:
        raise ValueError("number of walkers must be even")
    if W < 4:
        raise ValueError("need at least 4 walkers (2 per half)")
    if n_steps % thin:
        raise ValueError("thin must divide n_steps")
    lpv = log_prob_v if log_prob_v is not None else log_prob_fn
    x, lp = x0, lpv(x0)
    xs, lps, accs = [], [], []
    for _ in range(n_steps):
        draws = _draws(generator, W // 2, x0.dtype, x0.device)
        x, lp, acc = _sweep(x, lp, lpv, a, draws)
        xs.append(x)
        lps.append(lp)
        accs.append(acc)
    return MCMCResult(
        chain=torch.stack(xs)[thin - 1::thin],
        log_prob=torch.stack(lps)[thin - 1::thin],
        acceptance=torch.mean(torch.stack(accs).to(x0.dtype), dim=0))


def autocorr_time(chain, c: float = 5.0) -> np.ndarray:
    """Integrated autocorrelation time per parameter (emcee's
    ``autocorr`` method: FFT autocorrelation averaged over walkers,
    Sokal's self-consistent window M ≥ c·τ). ``chain``: (S, W, G), a
    tensor or an array; returns (G,). Host numpy (a diagnostic)."""
    if isinstance(chain, torch.Tensor):
        chain = chain.detach().cpu().numpy()
    x = np.asarray(chain, np.float64)
    S, W, G = x.shape
    taus = np.empty(G)
    for g in range(G):
        d = x[:, :, g] - x[:, :, g].mean(axis=0, keepdims=True)
        n = 1 << (2 * S - 1).bit_length()
        f = np.fft.fft(d, n=n, axis=0)
        acf = np.fft.ifft(f * np.conj(f), axis=0)[:S].real
        acf = acf.mean(axis=1)
        acf /= acf[0] if acf[0] > 0 else 1.0
        tau_cum = 2.0 * np.cumsum(acf) - 1.0
        window = np.arange(len(tau_cum)) >= c * tau_cum
        idx = np.argmax(window) if window.any() else len(tau_cum) - 1
        taus[g] = tau_cum[idx]
    return taus
