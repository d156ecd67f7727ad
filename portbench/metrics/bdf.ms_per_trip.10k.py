"""BDF stepper (solvers/bdf.py::bdf_solve): ms of stepper wall per trip of its batched step loop, over the window's stepper calls; in the 10,000-member cell."""

from portbench.metrics import _layers


def read(trace):
    return _layers.ms_per_trip(trace)
