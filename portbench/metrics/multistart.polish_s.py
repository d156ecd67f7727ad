"""Multi-start driver (fit/multistart.py::TwoPhaseDriver): seconds of a fit's polish (its polish_seconds), mean over the window's fits."""

from portbench.metrics import _layers


def read(trace):
    return _layers.mean_info(trace, 'polish_seconds')
