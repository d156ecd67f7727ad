"""BDF stepper (solvers/bdf.py::bdf_solve): in the profiled unit, the time of each ``bdf.trip`` span outside its ``bdf.read`` spans (the host's cost of issuing a trip), ms per trip."""

from portbench.metrics import _program


def read(trace):
    return _program.less_inner_ms("bdf.trip", "bdf.read")
