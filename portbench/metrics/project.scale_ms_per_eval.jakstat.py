"""Residual layer (project/residuals.py Project.evaluate): in the profiled unit, the time of the ``project.scale`` spans (the pooled scale factors and their gradient) inside each ``project.evaluate``, ms per evaluation; None where the program records no ``project.scale`` span."""

from portbench.metrics import _program


def read(trace):
    tr = _program._trace()
    if tr is None or not any(s.name == "project.scale" for s in tr.spans()):
        return None
    return _program.less_inner_ms("project.evaluate", "project.scale",
                                  inner_only=True)
