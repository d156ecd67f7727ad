"""BDF stepper (solvers/bdf.py::bdf_solve): rejected step attempts over all attempts, in %."""

from portbench.metrics import _layers


def read(trace):
    return _layers.reject_pct(trace)
