"""BDF stepper (solvers/bdf.py::bdf_solve): host reads of a device value (the program's ``bdf.reads``) per trip of the batched step loop (``bdf.trips``), over the whole run."""

from portbench.metrics import _program


def read(trace):
    return _program.per_count("bdf.reads", "bdf.trips")
