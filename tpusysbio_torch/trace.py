"""Spans and counters inside the port.

Counters are always on: ``count(name, k)`` adds to a dict, and
``counters()`` returns a copy of it. The port counts each host read of a
device value (``<layer>.reads``), the BDF stepper's trips (``bdf.trips``)
and every launch of a hand-written kernel (``linalg/kernels.py``:
``gpu_lu.<kernel>`` and, for the Gauss-Jordan kernels,
``gpu_lu.<kernel>.n<n>`` by matrix size; the mass-action kernel's
``massaction.<epilogue>``; the BDF stepper's dense-output fold
``bdf.fold``, one a trip), and ``massaction.plain`` or ``bdf.fold.plain``
for each gradient or tangent of such a call that the plain twin gave.
The forward-mode AD derivatives of a model without closed-form ones count
their jvps (``ad.jvps``): n for a state Jacobian
(``solvers/common.py::batched_jacobian``, span ``ad.jac``), one a column
for the sensitivity columns (``sens/forward.py``, span ``ad.sens``).
``Project.evaluate`` times its pooled scale factors as ``project.scale``.

Spans record only while recording is on: while a ``torch.profiler``
session is active (whatever its activities), or inside ``recording()``.
A span keeps its name, its start and end as ``time.time_ns()`` (the clock
of the profiler's events, so spans line up with the device trace), the
index of its parent (the innermost span open when it began, in the same
thread; -1 for none) and of its root (the outermost: the spans of one
call share it). Spans emit no profiler events, so a profile reads the same
events with the spans as without. With recording off, ``span()`` returns
one shared object that does nothing.

``read(x, counter)`` is the host read ``bool(x)`` of a device value: it
counts ``counter`` and, while recording, times the blocking read as a leaf
span named after the counter's layer (``bdf.reads`` -> ``bdf.read``).

``reset()`` clears counters and spans; call it with no span open.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

_COUNTS: dict = {}
_SPANS: list = []      # [name, start_ns, end_ns, parent, root] each
_local = threading.local()
_forced = 0            # depth of open ``recording()`` blocks


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int        # index in ``spans()``, -1 for a root
    root: int


def count(name: str, k: int = 1):
    _COUNTS[name] = _COUNTS.get(name, 0) + k


def counters() -> dict:
    return dict(_COUNTS)


def reset():
    _COUNTS.clear()
    _SPANS.clear()


def spans() -> list:
    """Every span recorded since the last ``reset()``, in the order they
    began."""
    return [Span(*s) for s in _SPANS]


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("i",)

    def __init__(self, name):
        stack = _stack()
        parent = stack[-1] if stack else -1
        self.i = len(_SPANS)
        root = _SPANS[parent][4] if parent >= 0 else self.i
        _SPANS.append([name, 0, 0, parent, root])

    def __enter__(self):
        _stack().append(self.i)
        _SPANS[self.i][1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        _SPANS[self.i][2] = time.time_ns()
        _stack().pop()
        return False


def span(name: str):
    """A context manager timing its block as the span ``name``."""
    if _forced or _profiler._is_profiler_enabled:
        return _Open(name)
    return _NOOP


def spanned(name: str):
    """Decorator: each call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def read(x, counter: str) -> bool:
    """``bool(x)``, counted under ``counter`` and, while recording, timed
    as the span ``<layer>.read``."""
    _COUNTS[counter] = _COUNTS.get(counter, 0) + 1
    if not (_forced or _profiler._is_profiler_enabled):
        return bool(x)
    with _Open(counter.split(".", 1)[0] + ".read"):
        return bool(x)


def self_ns(all_spans: list, i: int) -> int:
    """Span ``i``'s duration less the time its children cover (children
    run one after another in their parent's thread)."""
    s = all_spans[i]
    inner = 0
    for c in all_spans[i + 1:]:
        if c.start_ns > s.end_ns:
            break
        if c.parent == i:
            inner += c.end_ns - c.start_ns
    return s.end_ns - s.start_ns - inner


def chrome_events(all_spans: list, base_ns: int = 0, first: int = 0) -> list:
    """Spans ``first`` onwards as Chrome trace events (``ph`` "X"), in
    microseconds since ``base_ns`` on the Unix-epoch clock: with the
    ``baseTimeNanoseconds`` of a ``torch.profiler`` trace, the two files
    share their time axis."""
    return [dict(name=s.name, ph="X", ts=(s.start_ns - base_ns) / 1e3,
                 dur=(s.end_ns - s.start_ns) / 1e3, pid=0, tid=0,
                 args=dict(index=i, parent=s.parent, root=s.root))
            for i, s in enumerate(all_spans) if i >= first]
