"""Timing of short CUDA kernels with CUDA events."""

from __future__ import annotations

import torch

_BLOCKER = []


def cuda_ms(fn, reps: int, warmup: int = 3, queued: bool = True) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``.

    With ``queued`` the calls are enqueued behind three large matrix
    products (~60 ms of device work), so short kernels run back to back
    from the queue and the figure is device time. Without it they run at
    the pace the host launches them, which for a kernel of a few
    microseconds measures the wrapper's host time instead."""
    for _ in range(warmup):
        fn()
    if queued and not _BLOCKER:
        _BLOCKER.append(torch.ones((8192, 8192), device="cuda"))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        for _ in range(3):
            _BLOCKER[0] @ _BLOCKER[0]
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
