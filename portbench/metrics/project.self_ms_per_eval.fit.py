"""Residual layer (project/residuals.py Project.evaluate): in the profiled unit, each ``project.evaluate`` span less the ``bdf.solve`` spans it holds (observation, chain rule, assembly), ms per evaluation."""

from portbench.metrics import _program


def read(trace):
    return _program.less_inner_ms("project.evaluate", "bdf.solve")
