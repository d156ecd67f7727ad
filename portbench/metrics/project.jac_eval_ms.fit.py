"""Residual layer (project/residuals.py::Project.evaluate): ms per call of residuals_and_jacobian, ending in a synchronise."""

from portbench.metrics import _layers


def read(trace):
    return _layers.span_ms(trace, 'project.jac.')
