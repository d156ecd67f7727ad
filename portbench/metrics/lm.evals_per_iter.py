"""Levenberg-Marquardt (optim/lm.py): calls of the residual and Jacobian callables over the fits' lockstep LM iterations."""

from portbench.metrics import _layers


def read(trace):
    return _layers.evals_per_iter(trace)
