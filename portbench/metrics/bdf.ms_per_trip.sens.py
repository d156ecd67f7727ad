"""BDF stepper (solvers/bdf.py::bdf_solve): ms of stepper wall per trip of its batched step loop, over the window's stepper calls."""

from portbench.metrics import _layers


def read(trace):
    return _layers.ms_per_trip(trace)
