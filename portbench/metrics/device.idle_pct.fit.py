"""Device: share of the profiled unit's wall with no operation on the card, in %."""

from portbench.metrics import _layers


def read(trace):
    return _layers.idle_pct(trace)
