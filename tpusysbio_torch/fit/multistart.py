"""Batched multi-start fitting.

Port of ``tpusysbio/fit/multistart.py``. Call stack:

    sampler (LHS in log bounds, seeded generator)
    └─ batched LM or bounded TRF fit over the starts (optim/lm.py,
       optim/trf.py)
       └─ BDF + forward sensitivities over starts × experiments
          (solvers/bdf.py)
    └─ ranking of (θ*, cost, status)

Failed members (solver failure, non-finite residuals, LM status -1) carry
their status in the result tensors and are ranked last — never aborting the
batch. Checkpoint/resume: chunked execution writes an .npz after every
chunk; a resumed run skips completed chunks.

``bounds=`` (``multistart_trf``, ``polish_bounds=``) switches a phase from
LM to the bounded Coleman–Li TRF (``optim/trf.py``) with its
``subproblem``/``loss``/``f_scale``; both states are resumable, so
``iter_chunk``, ``compact`` and checkpointing work over either.

``mesh=`` (``utils.make_mesh``) splits the starts over the ranks of a
process group: every rank passes the same full start set, fits its
contiguous block (N must divide by the mesh size) and all-gathers the
results, so every rank returns the whole result. Members are
independent, so each rank compacts its own block, and the checkpointed
path writes from rank 0 after the gather.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpusysbio_torch.config import FitConfig
from tpusysbio_torch.optim.lm import FitResult, lm_finish, lm_init, lm_run
from tpusysbio_torch.optim.trf import trf_finish, trf_init, trf_run
from tpusysbio_torch.utils import (all_gather, barrier, gather_multihost,
                                   shard_starts)


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _wait(x) -> None:
    """Block until the device work behind tensor ``x`` is done."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class MultistartResult(NamedTuple):
    """Per-start results: torch tensors, or numpy arrays when a chunked run
    keeps them on the host."""

    theta: object       # (N, G) fitted parameters (log space)
    cost: object        # (N,)
    grad_norm: object   # (N,)
    status: object      # (N,) LM status codes
    n_iter: object      # (N,)
    theta0: object      # (N, G) the starts
    # per-member (JᵀJ)⁻¹ and 1σ error bars at the final iterate, carried
    # identically by the plain, iter_chunk and checkpointed paths
    cov: Optional[object] = None          # (N, G, G)
    param_sigma: Optional[object] = None  # (N, G)
    # accepted-cost history per member
    cost_trace: Optional[object] = None   # (N, max_iter)

    def ranked(self) -> "MultistartResult":
        """Sort by cost; invalid members (failed init / non-finite) last.

        ``status == 0`` (iteration cap) members rank by their achieved
        cost: a capped fit's cost is real — screening phases stop ALL
        members at a small iteration budget, and the whole point of
        ranking is to pick the best basins among them.
        """
        order = _rank_order(self.status, self.cost)
        return MultistartResult(
            *(None if x is None else x[order] for x in self))

    def best(self) -> "MultistartResult":
        """The best member's row of every field."""
        return MultistartResult(
            *(None if x is None else x[0] for x in self.ranked()))


def _rank_order(status, cost):
    """Stable ascending order by cost, invalid members last."""
    if isinstance(cost, np.ndarray):
        bad = (status < 0) | ~np.isfinite(cost)
        return np.argsort(np.where(bad, np.inf, cost), kind="stable")
    bad = (status < 0) | ~torch.isfinite(cost)
    key = torch.where(bad, torch.full_like(cost, float("inf")), cost)
    return torch.argsort(key, stable=True)


def _phase_fns(residual_fn: Callable, residual_and_jac_fn: Callable,
               config: FitConfig, bounds, subproblem: str, loss: str,
               f_scale: float):
    """``(init, step, finish)`` for one optimizer family: unbounded LM
    (``bounds=None``) or the bounded Coleman–Li TRF with its robust loss.
    Both states are resumable, so every multi-start path runs over
    either."""
    if bounds is None:
        return (
            lambda th: lm_init(residual_and_jac_fn, th, config),
            lambda st, cap: lm_run(residual_fn, residual_and_jac_fn, st,
                                   config, iter_cap=cap),
            lm_finish,
        )
    lb, ub = bounds
    return (
        lambda th: trf_init(residual_and_jac_fn, th, lb, ub, config,
                            loss=loss, f_scale=f_scale),
        lambda st, cap: trf_run(residual_fn, residual_and_jac_fn, st, lb,
                                ub, config, iter_cap=cap,
                                subproblem=subproblem, loss=loss,
                                f_scale=f_scale),
        trf_finish,
    )


def _take(x, idx: np.ndarray):
    """Rows ``idx`` of a tensor (on its device) or of a numpy array."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device)]
    return x[idx]


def _fit_batch_fn(residual_fn: Callable, residual_and_jac_fn: Callable,
                  config: FitConfig, iter_chunk: Optional[int],
                  compact: bool, with_cov: bool, bounds=None,
                  subproblem: str = "normal", loss: str = "linear",
                  f_scale: float = 1.0):
    """The batch fit: whole, or advanced ``iter_chunk`` LM/TRF iterations
    per ``step`` call (bounded single-call time; the hook for mid-fit
    checkpointing), with ``compact`` repacking the live members between
    chunks."""
    init, step, finish_fn = _phase_fns(residual_fn, residual_and_jac_fn,
                                       config, bounds, subproblem, loss,
                                       f_scale)

    def finish(state):
        fr = finish_fn(state)
        return fr if with_cov else fr._replace(cov=None, param_sigma=None)

    def run(theta0s):
        state = init(theta0s)
        if not iter_chunk:
            return finish(step(state, config.max_iter))
        if compact:
            return run_compact(state, theta0s.shape[0])
        # The early-exit check lags one chunk behind: chunk c+1 is
        # dispatched before chunk c's done flags are read. Worst case one
        # extra no-op call (lm_run returns an all-done state unchanged).
        prev_done = None
        cap = iter_chunk
        while True:
            state = step(state, min(cap, config.max_iter))
            if cap >= config.max_iter:
                break
            if prev_done is not None and bool(prev_done.all()):
                break
            prev_done = state.done
            cap += iter_chunk
        return finish(state)

    def run_compact(state, N):
        # Batch compaction: finished members leave the lockstep between
        # chunks. They are flushed into result rows and the survivors
        # repacked into the next power-of-two batch (at least min(8, N));
        # pad slots repeat a survivor and are dropped at flush.
        orig_idx = np.arange(N)
        rows, parts = [], []

        def flush(mask, state, idxs):
            slots = np.flatnonzero(mask & (idxs >= 0))
            fr = finish(state)
            rows.append(idxs[slots])
            parts.append([None if a is None else _take(a, slots)
                          for a in fr])

        cap = iter_chunk
        while True:
            state = step(state, min(cap, config.max_iter))
            done = (state.done | (state.n_iter >= config.max_iter)
                    ).cpu().numpy()
            if done.all() or cap >= config.max_iter:
                flush(np.ones_like(done), state, orig_idx)
                break
            n_live = int((~done).sum())
            cur = orig_idx.shape[0]
            # repack when at most half the slots are live and the repack
            # shrinks the batch
            if n_live <= cur // 2:
                new_size = max(1 << (n_live - 1).bit_length(), min(8, cur))
                if new_size < cur:
                    flush(done, state, orig_idx)
                    live = np.flatnonzero(~done)
                    sel = np.concatenate(
                        [live, np.full(new_size - n_live, live[0])])
                    state = type(state)(*(_take(a, sel) for a in state))
                    orig_idx = np.concatenate(
                        [orig_idx[live], np.full(new_size - n_live, -1)])
            cap += iter_chunk
        order = np.argsort(np.concatenate(rows), kind="stable")
        fields = [None if xs[0] is None else _take(torch.cat(xs), order)
                  for xs in zip(*parts)]
        return FitResult(*fields)

    return run


def make_multistart_runner(
    residual_fn: Callable,
    residual_and_jac_fn: Callable,
    config: FitConfig = FitConfig(),
    mesh=None,
    iter_chunk: Optional[int] = None,
    compact: bool = False,
    with_cov: bool = True,
    bounds=None,
    subproblem: str = "normal",
    loss: str = "linear",
    f_scale: float = 1.0,
) -> Callable:
    """Build a reusable batch-fit callable ``runner(theta0s (N, G)) ->
    MultistartResult`` for one (objective, config).

    ``with_cov=False`` (screening) returns ``cov``/``param_sigma`` as None.
    ``bounds=(lower, upper)`` switches every member from unbounded LM to
    the Coleman–Li bounded TRF (``optim/trf.py``) with ``subproblem``,
    ``loss`` and ``f_scale``. ``compact=True`` acts under ``iter_chunk``
    only: between chunks it flushes the done members and repacks the live
    ones into the next power-of-two batch (pays off for long-tailed
    convergence). With ``mesh``, each rank fits its block of the starts
    and the results are gathered onto every rank; ``bounds`` are
    replicated.
    """
    run = _fit_batch_fn(residual_fn, residual_and_jac_fn, config,
                        iter_chunk, compact, with_cov, bounds=bounds,
                        subproblem=subproblem, loss=loss, f_scale=f_scale)

    def runner(theta0s):
        if mesh is None:
            fr = run(theta0s)
        else:
            fr = gather_multihost(run(shard_starts(theta0s, mesh)), mesh)
        return MultistartResult(theta=fr.theta, cost=fr.cost,
                                grad_norm=fr.grad_norm, status=fr.status,
                                n_iter=fr.n_iter, theta0=theta0s,
                                cov=fr.cov, param_sigma=fr.param_sigma,
                                cost_trace=fr.cost_trace)

    # advertised so run_chunked can reject a channels='all'/cov-less
    # mismatch up front instead of after the first (expensive) chunk
    runner.with_cov = with_cov
    runner.mesh = mesh
    return runner


# every per-member channel — including cov/param_sigma/cost_trace (the
# reference's cov_x contract, scipy/optimize/_minpack_py.py:482-501) —
# is persisted per chunk, so a checkpointed result is field-for-field
# identical with the plain path. 'rank' keeps only the ranking channels:
# screening phases triage thousands of non-converged members whose
# covariance is meaningless, and the heavy channels cost real wall time
# in device->host transfer per chunk.
_CHUNK_KEYS = ("theta", "cost", "grad_norm", "status", "n_iter",
               "cov", "param_sigma", "cost_trace")
_RANK_KEYS = ("theta", "cost", "grad_norm", "status", "n_iter")


def _atomic_savez(path: str, **arrays) -> None:
    """np.savez via temp file + os.replace: a crash mid-write (the exact
    scenario checkpoints exist for) must never corrupt the previous good
    checkpoint or leave a truncated file that poisons every resume."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _run_digest(theta0s, chunk_size: int, trace_len: int,
                config: Optional[FitConfig] = None,
                run_tag: str = "") -> np.ndarray:
    """Fingerprint of (start set, chunking, fit budget, fit config,
    caller tag) stored in every checkpoint: a resumed run must be THE
    SAME run. Chunks fit from a different N (LHS start sets depend on N),
    different starts, a different chunk size, a different iteration
    budget, different tolerances/eval mode, or a different objective
    (identified by ``run_tag`` — the config cannot see the model) must
    never be silently mixed with fresh chunks."""
    import hashlib

    h = hashlib.sha256(np.ascontiguousarray(
        _to_numpy(theta0s).astype(np.float64)).tobytes())
    h.update(np.int64([chunk_size, trace_len]).tobytes())
    if config is not None:
        import dataclasses as _dc
        h.update(repr(sorted(_dc.asdict(config).items())).encode())
    h.update(run_tag.encode())
    return np.frombuffer(h.digest(), np.uint8)


def _load_checkpoint(path: str, keys, n_theta: int, digest: np.ndarray,
                     chunk_size: int):
    """Load and VALIDATE a chunk checkpoint; returns (acc dict, chunks
    done) or (None, 0) for a missing/corrupt/incompatible file (e.g.
    written by an older version without the cov channels, a different
    channel set, or — via the run digest — different starts / N /
    chunking / iteration budget: resuming any of those would silently
    mix results of different runs, drop channels, or crash in
    np.concatenate, so they restart from scratch instead)."""
    if not os.path.exists(path):
        return None, 0
    try:
        ck = np.load(path)
        done = int(ck["chunks_done"])
        if set(ck.files) != set(keys) | {"chunks_done", "run_digest"}:
            return None, 0
        if not np.array_equal(ck["run_digest"], digest):
            return None, 0
        acc = {k: ck[k] for k in keys}
    except Exception:
        return None, 0
    n = acc["theta"].shape[0]
    shapes_ok = (
        n == done * chunk_size
        and acc["theta"].ndim == 2 and acc["theta"].shape[1] == n_theta
        and all(acc[k].shape[0] == n for k in keys))
    if not (done and shapes_ok):
        return None, 0
    return acc, done


def run_chunked(
    runner: Callable,
    theta0s: torch.Tensor,
    chunk_size: int,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    trace_len: int = 0,
    channels: str = "all",
    config: Optional[FitConfig] = None,
    run_tag: str = "",
    as_numpy: bool = False,
):
    """Run a ``make_multistart_runner`` callable over sequential chunks of
    ``theta0s`` with per-chunk checkpointing.

    Returns ``(MultistartResult, chunks_resumed)``. With
    ``checkpoint_path``, every completed chunk is persisted ATOMICALLY;
    a re-run with ``resume=True`` continues after the last completed
    chunk. A checkpoint only resumes if it is THE SAME run: the file
    carries a digest of (starts, chunk_size, trace_len, fit config,
    run_tag) and a missing/corrupt/old-format/different-run checkpoint
    restarts cleanly from chunk 0. ``resume=False`` ignores and
    overwrites any existing file. ``trace_len`` must be the fit config's
    ``max_iter`` (part of the digest, so a changed iteration budget
    restarts too). Pass the runner's ``config`` so tolerance/eval-mode
    changes restart, and a ``run_tag`` naming the objective/model —
    the digest cannot see through the runner closure, so two different
    models with identical starts are only distinguished by the tag.

    ``channels='all'`` carries every per-member channel (field-for-field
    identical with the plain path); ``'rank'`` keeps only the ranking
    channels and returns ``cov``/``param_sigma``/``cost_trace`` as None —
    the right mode for screening phases. ``as_numpy=True`` keeps the
    accumulated results on the host (they arrive there anyway for the
    checkpoint); otherwise they return to the device of ``theta0s``.

    A runner built with ``mesh=`` shards every chunk (``chunk_size`` must
    divide by the mesh size); rank 0 writes the checkpoint after each
    chunk's gather, the others wait for it, and every rank resumes from
    the same file, which must lie where every rank can read it.
    """
    if channels not in ("all", "rank"):
        raise ValueError(f"unknown channels {channels!r}")
    if channels == "all" and not getattr(runner, "with_cov", True):
        raise ValueError(
            "channels='all' needs a runner built with with_cov=True")
    keys = _CHUNK_KEYS if channels == "all" else _RANK_KEYS
    N = theta0s.shape[0]
    if N % chunk_size:
        raise ValueError("chunk_size must divide the number of starts")
    n_chunks = N // chunk_size
    digest = _run_digest(theta0s, chunk_size, trace_len, config, run_tag)
    done, parts = 0, []
    if checkpoint_path and resume:
        acc, done = _load_checkpoint(checkpoint_path, keys,
                                     theta0s.shape[1], digest, chunk_size)
        if done:
            parts = [acc]
        done = min(done, n_chunks)
    mesh = getattr(runner, "mesh", None)
    if checkpoint_path and resume and mesh is not None:
        seen = [int(d) for d in all_gather(torch.tensor([done]), mesh)]
        if len(set(seen)) > 1:
            raise ValueError(
                f"the ranks read different checkpoints (chunks done by "
                f"rank: {seen}): {checkpoint_path} must be one file that "
                "every rank reads")

    for c in range(done, n_chunks):
        fr = runner(theta0s[c * chunk_size:(c + 1) * chunk_size])
        if channels == "all" and fr.cov is None:
            raise ValueError(
                "channels='all' needs a runner built with with_cov=True")
        parts.append({k: _to_numpy(getattr(fr, k)) for k in keys})
        if checkpoint_path:
            acc = {k: np.concatenate([p[k] for p in parts]) for k in keys}
            if mesh is None or mesh.rank == 0:
                _atomic_savez(checkpoint_path, chunks_done=c + 1,
                              run_digest=digest, **acc)
            barrier(mesh)
            parts[:] = [acc]

    acc = {k: np.concatenate([p[k] for p in parts]) for k in keys}

    def lift(a):
        return a if as_numpy else torch.as_tensor(a, device=theta0s.device)

    def opt(k):
        return lift(acc[k]) if k in acc else None

    res = MultistartResult(
        theta=lift(acc["theta"]), cost=lift(acc["cost"]),
        grad_norm=lift(acc["grad_norm"]), status=lift(acc["status"]),
        n_iter=lift(acc["n_iter"]), theta0=theta0s,
        cov=opt("cov"), param_sigma=opt("param_sigma"),
        cost_trace=opt("cost_trace"))
    return res, done


def multistart_fit(
    residual_fn: Callable,
    residual_and_jac_fn: Callable,
    theta0s: torch.Tensor,
    config: FitConfig = FitConfig(),
    mesh=None,
    checkpoint_path: Optional[str] = None,
    chunk_size: Optional[int] = None,
    iter_chunk: Optional[int] = None,
    compact: bool = False,
) -> MultistartResult:
    """Fit every row of ``theta0s`` (N, G); returns per-start results.

    With ``checkpoint_path``/``chunk_size``, the batch runs in chunks and
    each completed chunk is persisted; re-running resumes after the last
    one. With ``iter_chunk``, each ``lm_run`` call advances the
    (resumable) LM state by at most that many iterations; ``compact=True``
    then also repacks the live members between chunks. With ``mesh`` (1-D,
    axis ``'starts'``) the starts are split over its ranks: N must divide
    by the mesh size.
    """
    run = make_multistart_runner(residual_fn, residual_and_jac_fn, config,
                                 mesh=mesh, iter_chunk=iter_chunk,
                                 compact=compact)
    N = theta0s.shape[0]
    if chunk_size is None or chunk_size >= N:
        return run(theta0s)
    res, _ = run_chunked(run, theta0s, chunk_size,
                         checkpoint_path=checkpoint_path,
                         trace_len=config.max_iter, config=config)
    return res


def multistart_trf(
    residual_fn: Callable,
    residual_and_jac_fn: Callable,
    theta0s: torch.Tensor,
    lower,
    upper,
    config: FitConfig = FitConfig(),
    mesh=None,
    subproblem: str = "normal",
    loss: str = "linear",
    f_scale: float = 1.0,
    iter_chunk: Optional[int] = None,
) -> MultistartResult:
    """Bounded multi-start: the Coleman–Li TRF over the starts axis.

    The bounded counterpart of :func:`multistart_fit` (PEtab problems carry
    box bounds); robust ``loss``/``f_scale`` pass straight through to every
    member, and ``iter_chunk`` bounds the time of one call as in
    ``multistart_fit``. For screening-scale N use :class:`TwoPhaseDriver`
    with an LM screen and ``polish_bounds`` for the bounded polish.
    """
    lower = torch.as_tensor(lower, dtype=theta0s.dtype,
                            device=theta0s.device)
    upper = torch.as_tensor(upper, dtype=theta0s.dtype,
                            device=theta0s.device)
    run = make_multistart_runner(
        residual_fn, residual_and_jac_fn, config, mesh=mesh,
        iter_chunk=iter_chunk, bounds=(lower, upper),
        subproblem=subproblem, loss=loss, f_scale=f_scale)
    return run(theta0s)


def multistart_two_phase(
    screen_fns,
    polish_fns,
    theta0s: torch.Tensor,
    screen_config: FitConfig,
    polish_config: FitConfig,
    top_k: int,
    mesh=None,
    iter_chunk: Optional[int] = None,
    polish_iter_chunk: Optional[int] = None,
    chunk_size: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    screen_channels: str = "rank",
    run_tag: str = "",
    polish_subbatch: Optional[int] = None,
    return_info: bool = False,
    polish_bounds=None,
    polish_subproblem: str = "normal",
    polish_loss: str = "linear",
    polish_f_scale: float = 1.0,
    presort_fn: Optional[Callable] = None,
):
    """Two-phase multi-start: wide cheap screening, then accurate polish.

    Phase 1 fits every start with ``screen_fns`` (typically a Project at
    loose tolerance with ``mixed_precision=True`` — f32 hot loop); phase 2
    re-fits the ``top_k`` ranked survivors with ``polish_fns`` (tight f64).
    The screening phase costs a fraction of a full-accuracy fit per member,
    and only the basin winners pay for reference accuracy.

    Production knobs:
      chunk_size: screen the starts in sequential same-shape batches (the
        set is padded with clones of start 0 to a chunk multiple; pads are
        dropped before ranking).
      checkpoint_path: every completed screening chunk is persisted
        ATOMICALLY (``run_chunked``); a re-run with ``resume=True``
        continues after the last completed chunk — validated against a
        digest of (starts, chunking, config, run_tag). The polish phase
        reruns after a crash-resume.
      screen_channels: 'rank' (default) keeps only ranking channels for
        the screen result; 'all' carries every channel.
      polish_iter_chunk: the polish phase's per-call iteration cap
        (defaults to ``iter_chunk``).
      polish_bounds: ``(lower, upper)``; the polish becomes the bounded
        TRF with ``polish_subproblem``, ``polish_loss`` and
        ``polish_f_scale`` (the screen stays unbounded LM).
      presort_fn: ``(B, G) -> (B,)`` sort key (typically a
        sensitivity-free integration's step count at the screen config),
        used with ``chunk_size``: the starts are screened in key-sorted
        chunks, so each chunk's lockstep groups members of similar cost;
        results come back in the caller's order. Pays only when the
        per-start step distribution is broad beside the probe's cost.
      mesh: the screen is split over the ranks and gathered; every rank
        ranks the same gathered screen, and the polish is split too when
        the mesh size divides its batch (``polish_subbatch`` or
        ``top_k``), else it runs whole on every rank.

    Returns ``(polish_result, screen_result)``; with ``return_info=True``
    additionally a dict with phase wall times and resume counts.
    """
    two_phase = TwoPhaseDriver(
        screen_fns, polish_fns, screen_config, polish_config, top_k,
        mesh=mesh, iter_chunk=iter_chunk,
        polish_iter_chunk=polish_iter_chunk, chunk_size=chunk_size,
        screen_channels=screen_channels, run_tag=run_tag,
        polish_subbatch=polish_subbatch, polish_bounds=polish_bounds,
        polish_subproblem=polish_subproblem, polish_loss=polish_loss,
        polish_f_scale=polish_f_scale, presort_fn=presort_fn)
    polish, screen, info = two_phase.run(
        theta0s, checkpoint_path=checkpoint_path, resume=resume)
    return (polish, screen, info) if return_info else (polish, screen)


class TwoPhaseDriver:
    """Persistent two-phase runner: builds BOTH phase runners once and
    exposes ``warmup`` so production runs and benches can pay first-use
    costs (the kernels' build, library initialisation) on representative
    shapes before the measured pass. ``multistart_two_phase`` is the
    one-shot facade."""

    def __init__(self, screen_fns, polish_fns, screen_config: FitConfig,
                 polish_config: FitConfig, top_k: int,
                 mesh=None,
                 iter_chunk: Optional[int] = None,
                 polish_iter_chunk: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 screen_channels: str = "rank",
                 run_tag: str = "",
                 polish_subbatch: Optional[int] = None,
                 polish_bounds=None,
                 polish_subproblem: str = "normal",
                 polish_loss: str = "linear",
                 polish_f_scale: float = 1.0,
                 presort_fn: Optional[Callable] = None):
        self.presort_fn = presort_fn
        self.screen_config = screen_config
        self.polish_config = polish_config
        self.top_k = top_k
        self.chunk_size = chunk_size
        self.screen_channels = screen_channels
        self.run_tag = run_tag
        # Cost-sorted polish sub-batches: the polish input is the RANKED
        # screen top_k, so consecutive slices group members of similar
        # screened cost — each sub-batch's lockstep union is tighter than
        # the full batch's (one slow member taxes sb-1 peers instead of
        # top_k-1).
        if polish_subbatch and top_k % polish_subbatch:
            raise ValueError("polish_subbatch must divide top_k")
        self.polish_subbatch = (polish_subbatch
                                if polish_subbatch
                                and polish_subbatch < top_k else None)
        self.screen_run = make_multistart_runner(
            screen_fns[0], screen_fns[1], screen_config, mesh=mesh,
            iter_chunk=iter_chunk, with_cov=(screen_channels == "all"))
        pic = iter_chunk if polish_iter_chunk is None else polish_iter_chunk
        # a polish batch that the mesh size does not divide polishes
        # unsharded on every rank (a small fraction of the work)
        pb = self.polish_subbatch or top_k
        polish_mesh = (mesh if mesh is not None and pb % mesh.size == 0
                       else None)
        self.polish_run = make_multistart_runner(
            polish_fns[0], polish_fns[1], polish_config, mesh=polish_mesh,
            iter_chunk=(pic or None), bounds=polish_bounds,
            subproblem=polish_subproblem, loss=polish_loss,
            f_scale=polish_f_scale)

    def warmup(self, theta_rep: torch.Tensor) -> float:
        """Run both phases on their production shapes: one screen chunk
        and one top_k polish batch (and the presort key on a chunk), all
        rows = ``theta_rep`` (a representative start). Returns the wall
        seconds spent."""
        t0 = time.perf_counter()
        G = theta_rep.shape[0]
        n = self.chunk_size or max(self.top_k, 1)
        pb = self.polish_subbatch or self.top_k
        _wait(self.screen_run(theta_rep.expand(n, G).clone()).cost)
        _wait(self.polish_run(theta_rep.expand(pb, G).clone()).cost)
        if self.presort_fn is not None:
            _wait(self.presort_fn(theta_rep.expand(n, G).clone()))
        return time.perf_counter() - t0

    def run(self, theta0s: torch.Tensor,
            checkpoint_path: Optional[str] = None, resume: bool = True):
        """Screen all starts (chunked + checkpointed when configured),
        rank, polish the top_k. Returns (polish, screen, info)."""
        N = theta0s.shape[0]
        starts = theta0s
        n_pad = 0
        t0 = time.perf_counter()
        chunked = bool(self.chunk_size and self.chunk_size < N)
        inv_order = None
        if self.presort_fn is not None and chunked:
            # probe-sorted chunking: one key per start, probed in chunks
            # (the last start cloned into the pad), sorted stably
            cs = self.chunk_size
            probe_pad = (-N) % cs
            probe_in = (torch.cat([starts, starts[-1:].expand(
                probe_pad, starts.shape[1])]) if probe_pad else starts)
            keys = np.concatenate([
                _to_numpy(self.presort_fn(probe_in[i:i + cs]))
                for i in range(0, probe_in.shape[0], cs)])[:N]
            order = np.argsort(keys, kind="stable")
            inv_order = np.empty(N, np.int64)
            inv_order[order] = np.arange(N)
            starts = _take(starts, order)
        t_presort = time.perf_counter() - t0
        if chunked:
            n_pad = (-N) % self.chunk_size
            if n_pad:
                # presorted: pad with clones of the last (most expensive)
                # start, which cannot raise its chunk's lockstep union;
                # unsorted keeps the first start's clone
                pad_src = starts[-1:] if inv_order is not None \
                    else starts[:1]
                starts = torch.cat(
                    [starts, pad_src.expand(n_pad, starts.shape[1])])
            screen, chunks_resumed = run_chunked(
                self.screen_run, starts, self.chunk_size,
                checkpoint_path=checkpoint_path, resume=resume,
                trace_len=self.screen_config.max_iter,
                channels=self.screen_channels,
                config=self.screen_config, run_tag=self.run_tag,
                as_numpy=True)
            if n_pad:
                screen = MultistartResult(
                    *(None if a is None else a[:N] for a in screen))
        else:
            screen = self.screen_run(starts)
            chunks_resumed = 0
        _wait(screen.cost)
        if inv_order is not None:
            # the caller's start order (ranking below does not depend on
            # it; the pairing with theta0 does)
            screen = MultistartResult(
                *(None if a is None else _take(a, inv_order)
                  for a in screen))
        t1 = time.perf_counter()

        # chunked screen results are host-resident: rank in numpy and
        # upload ONLY the top_k rows
        order = _rank_order(screen.status, screen.cost)
        top = torch.as_tensor(screen.theta[order[:self.top_k]],
                              device=theta0s.device)
        if self.polish_subbatch:
            sb = self.polish_subbatch
            frs = [self.polish_run(top[i:i + sb])
                   for i in range(0, self.top_k, sb)]
            polish = MultistartResult(
                *(None if xs[0] is None else torch.cat(xs, dim=0)
                  for xs in zip(*frs)))
        else:
            polish = self.polish_run(top)
        _wait(polish.cost)
        t2 = time.perf_counter()
        return polish, screen, {
            "screen_seconds": t1 - t0, "polish_seconds": t2 - t1,
            "presort_seconds": t_presort,
            "chunks_resumed": chunks_resumed, "n_pad": n_pad,
        }
