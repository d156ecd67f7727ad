"""Utilities: the sanitizer lane, the ``torch.distributed`` mesh, result
export.

Port of ``tpusysbio/utils/__init__.py``. The reference's mesh is a
``jax.sharding.Mesh`` over devices that ``shard_map`` splits a batch
across; here it is one process per rank, each rank owning one device
(SPMD):

- every rank calls the same entry point with the same full inputs, as
  every JAX process passes the same host array to ``shard_starts``;
- each rank computes its contiguous block of the sharded axis;
- the blocks are all-gathered, so every rank returns the whole result,
  equal on every rank. No collective runs inside a fit: the gathers at
  the end are the only ones (the reference's ``shard_map`` runs with
  ``check_vma=False`` because the fit is collective-free).

Launch one process per rank with ``torchrun --nproc_per_node=K`` (or set
its environment variables), call :func:`distributed_initialize` once in
each, then :func:`make_mesh`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tpusysbio_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: the port's counterpart of
    ``jax.sharding.Mesh`` over the ensemble axis.

    ``group`` is the ``torch.distributed`` process group of the ``size``
    ranks, or None for a one-rank mesh (no collective runs)."""

    axis_names: Tuple[str, ...]
    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    def block(self, n: int) -> slice:
        """This rank's contiguous rows of an axis of length ``n``, which
        the mesh size must divide."""
        if n % self.size:
            raise ValueError(
                f"an axis of length {n} does not divide over the "
                f"{self.size} ranks of the mesh {self.axis_names!r}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


class _NanTrap(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op with a NaN output."""

    # outputs that hold whatever the allocator returned, not a result
    _UNINITIALIZED = ("empty", "new_empty")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] in self._UNINITIALIZED:
            return out
        for x in tree_leaves(out):
            if (isinstance(x, torch.Tensor) and (x.is_floating_point()
                                                 or x.is_complex())
                    and bool(torch.isnan(x).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func.__name__}")
        return out


@contextlib.contextmanager
def sanitizer(nans: bool = True, checks: bool = True):
    """Sanitizer lane: trap NaNs at op granularity (``nans``, the
    counterpart of ``jax_debug_nans``: a dispatch mode checks every op's
    floating outputs and raises ``FloatingPointError``) and turn on
    autograd's anomaly detection (``checks``, standing in for
    ``jax_enable_checks``). ±inf is not trapped, as in the reference: the
    port builds it on purpose (unbounded boxes, ranking keys). Wrap a
    test or debug run, not production (every op syncs with the host). The
    previous state is restored on exit::

        with sanitizer():
            result = my_fit(theta0)
    """
    anomaly = torch.is_anomaly_enabled()
    with contextlib.ExitStack() as stack:
        if checks:
            torch.autograd.set_detect_anomaly(True)
            stack.callback(torch.autograd.set_detect_anomaly, anomaly)
        if nans:
            stack.enter_context(_NanTrap())
        yield


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "starts",
              config=None, device="cuda") -> Mesh:
    """1-D mesh over the ranks of the process group (all of them by
    default).

    A ``MeshConfig`` (``tpusysbio_torch.config``) supplies the same layout
    declaratively; explicit arguments override it. Without a process
    group this is the one-rank mesh on ``device``. A process group cannot
    grow, so asking for more ranks than it has raises (the reference
    takes the first ``n_devices`` devices that exist); a one-rank request
    inside a group gives the one-rank mesh (every rank computes all)."""
    import torch.distributed as dist

    if config is not None:
        if len(config.axis_names) != 1:
            raise ValueError("the ensemble mesh is 1-D; got axes "
                             f"{config.axis_names!r}")
        axis_name = config.axis_names[0]
        if n_devices is None and config.axis_sizes is not None:
            n_devices = config.axis_sizes[0]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = world if n_devices is None else int(n_devices)
    if n == 1:
        return Mesh((axis_name,), 1, 0, dev, None)
    if n != world:
        raise ValueError(
            f"a mesh of {n} ranks needs a process group of {n} (this one "
            f"has {world}): launch with torchrun --nproc_per_node={n} and "
            "call distributed_initialize() first")
    return Mesh((axis_name,), world, dist.get_rank(), dev,
                dist.group.WORLD)


def checked(fn):
    """The reference's checkify lane, for code written against it: there
    ``SolverConfig(debug_checks=True)`` emits in-jit assertions (finite
    RHS at init, positive step) that ``checked`` functionalizes and
    raises. In the port those checks already raise ``FloatingPointError``
    eagerly where they fail, so this wrapper only calls ``fn`` and lets
    them through::

        sim = utils.checked(lambda p: model.simulate(
            p, span, ts, config=SolverConfig(debug_checks=True)))
        sim(p_bad)   # -> FloatingPointError with the check's message
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


def default_backend(n_cards: int, local_ranks: int) -> str:
    """``nccl`` when every rank of this host has a card of its own, else
    ``gloo`` (ranks sharing a card, which NCCL refuses as a duplicate GPU,
    or no card at all)."""
    return "nccl" if 0 < local_ranks <= n_cards else "gloo"


def distributed_initialize(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           timeout_s: float = 1800.0) -> None:
    """Join this process to the process group (call ONCE per rank before
    :func:`make_mesh`) and pin its CUDA device to ``LOCAL_RANK %
    torch.cuda.device_count()``.

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``). ``coordinator_address`` (``host:port``) names
    rank 0's TCP store instead; ``init_method="file://..."`` a file every
    rank can reach. The backend follows from the layout
    (:func:`default_backend`) unless named. Under gloo the collectives
    move host copies of the (small) gathered results; the work stays on
    each rank's device. A rank that dies makes the others fail within
    ``timeout_s`` instead of hanging."""
    import torch.distributed as dist

    env = os.environ
    rank = int(env.get("RANK", 0) if process_id is None else process_id)
    world = int(env.get("WORLD_SIZE", 1) if num_processes is None
                else num_processes)
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards:
        torch.cuda.set_device(local_rank % n_cards)
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}"
                       if coordinator_address else "env://")
    dist.init_process_group(
        backend or default_backend(n_cards, local_world),
        init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def all_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> list:
    """Every rank's ``x`` (equal shapes and dtypes on all ranks), in rank
    order, on ``x``'s device. The transfer goes through host copies under
    gloo and through the mesh's device under NCCL."""
    import torch.distributed as dist

    if mesh is None or mesh.size == 1:
        return [x]
    y = x.detach().contiguous()
    y = y.cpu() if dist.get_backend(mesh.group) == "gloo" else y.to(
        mesh.device)
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y, group=mesh.group)
    return [p.to(x.device) for p in parts]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of ``mesh`` (nothing for one rank)."""
    import torch.distributed as dist

    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.group)


def check_device(x: torch.Tensor, mesh: Mesh, what: str,
                 host_ok: bool = False) -> None:
    """Raise unless ``x`` lies on ``mesh.device`` (or on the host, with
    ``host_ok``). A rank that builds its problem before
    :func:`distributed_initialize` pins its card puts it on the default
    card, not on the rank's own."""
    want = mesh.device
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    if x.device != want and not (host_ok and x.device.type == "cpu"):
        raise ValueError(
            f"{what} lie on {x.device}, but rank {mesh.rank}'s mesh device "
            f"is {mesh.device}: call distributed_initialize() before "
            "building the problem, and build it on mesh.device")


def shard_starts(theta0s, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous rows of a start array (N, G) that every rank
    passes whole (the samplers are deterministic in their generator, so
    each rank calls the sampler with the same seed), on the rank's
    device. N must divide by the mesh size; starts on another device than
    the host or the mesh's raise (:func:`check_device`)."""
    theta0s = torch.as_tensor(theta0s)
    check_device(theta0s, mesh, "the starts", host_ok=True)
    return theta0s[mesh.block(theta0s.shape[0])].to(mesh.device)


def gather_multihost(tree, mesh: Optional[Mesh] = None):
    """All-gather the blocks that the ranks computed of a result — a
    ``MultistartResult``, ``ProfileResult`` or tuple of tensors (or numpy
    arrays) — along dim 0, onto every rank; None fields stay None, as do
    0-dim ones (the same on every rank). ``mesh=None`` means the whole
    process group, and nothing to gather without one.

    The port's entry points that take ``mesh=`` gather with this already
    and return whole results: call it on results of your own blocks (a
    runner called on :func:`shard_starts` rows, a profile of this rank's
    parameters)."""
    import torch.distributed as dist

    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return tree
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device("cpu"))
        mesh = Mesh(("starts",), dist.get_world_size(), dist.get_rank(),
                    dev, dist.group.WORLD)
    if mesh.size == 1:
        return tree

    def gather(a):
        if a is None or np.ndim(a) == 0:
            return a
        if isinstance(a, np.ndarray):
            return torch.cat(all_gather(torch.as_tensor(a), mesh)).numpy()
        return torch.cat(all_gather(a, mesh))

    return type(tree)(*(gather(a) for a in tree)) if hasattr(
        tree, "_fields") else type(tree)(gather(a) for a in tree)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def results_to_records(result) -> list:
    """MultistartResult -> list of per-start dicts (JSON-ready)."""
    cost, status, n_iter, grad_norm, theta = (
        _host(getattr(result, k)) for k in
        ("cost", "status", "n_iter", "grad_norm", "theta"))
    sigma = getattr(result, "param_sigma", None)
    sigma = None if sigma is None else _host(sigma)
    recs = []
    for i in range(cost.shape[0]):
        rec = {
            "start": i,
            "cost": float(cost[i]),
            "status": int(status[i]),
            "n_iter": int(n_iter[i]),
            "grad_norm": float(grad_norm[i]),
            "theta": theta[i].tolist(),
        }
        if sigma is not None:
            rec["param_sigma"] = sigma[i].tolist()
        recs.append(rec)
    return recs


def save_results_json(result, path: str, extra: Optional[dict] = None,
                      mesh: Optional[Mesh] = None):
    """Write ``results_to_records(result)`` (and ``extra``) to ``path``;
    under a mesh only rank 0 writes (every rank holds the whole
    result)."""
    if mesh is not None and mesh.rank != 0:
        return
    payload = {"results": results_to_records(result)}
    if extra:
        payload.update(extra)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2)
