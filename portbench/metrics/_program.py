"""What the readers of the program's own spans and counters share
(``tpusysbio_torch/trace.py``): its counters over the whole run (set-up,
window and profiled unit), and its spans, which the program records only
while a ``torch.profiler`` session is active: in a traced run, those of
the profiled unit. A program without that module gives every reader
None."""

from __future__ import annotations


def _trace():
    try:
        from tpusysbio_torch import trace
    except ImportError:
        return None
    return trace


def per_count(num, den):
    """Counter ``num`` over counter ``den``."""
    tr = _trace()
    if tr is None:
        return None
    counts = tr.counters()
    if not counts.get(den):
        return None
    return counts.get(num, 0) / counts[den]


def _enclosing(spans, i, name):
    """The index of span ``i``'s nearest ancestor named ``name``, or
    None."""
    j = spans[i].parent
    while j >= 0:
        if spans[j].name == name:
            return j
        j = spans[j].parent
    return None


def less_inner_ms(outer, inner, inner_only=False):
    """Per span ``outer``: its time less (or, with ``inner_only``, only)
    the time of the spans ``inner`` it holds at any depth, in ms; None
    without such a span."""
    tr = _trace()
    if tr is None:
        return None
    spans = tr.spans()
    total = sum(s.end_ns - s.start_ns for s in spans if s.name == outer)
    n = sum(s.name == outer for s in spans)
    if not n:
        return None
    held = sum(s.end_ns - s.start_ns for i, s in enumerate(spans)
               if s.name == inner
               and _enclosing(spans, i, outer) is not None)
    return 1e-6 * (held if inner_only else total - held) / n
