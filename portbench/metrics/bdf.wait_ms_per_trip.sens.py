"""BDF stepper (solvers/bdf.py::bdf_solve): in the profiled unit, the time of the ``bdf.read`` spans inside each ``bdf.trip`` (device work the host waits for), ms per trip."""

from portbench.metrics import _program


def read(trace):
    return _program.less_inner_ms("bdf.trip", "bdf.read", inner_only=True)
