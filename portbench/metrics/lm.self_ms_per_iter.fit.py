"""Levenberg-Marquardt (optim/lm.py): in the profiled unit, each ``lm.iter`` span less the ``project.evaluate`` spans it holds (LM's own work in an iteration), ms per iteration."""

from portbench.metrics import _program


def read(trace):
    return _program.less_inner_ms("lm.iter", "project.evaluate")
