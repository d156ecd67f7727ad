"""Newton linear algebra (linalg/gpu_lu.py, K2): the f64 state-column solves' least time over the refined-solve kernels' device time, in %; in the 10,000-member cell."""

from portbench.metrics import _layers


def read(trace):
    return _layers.solve_roofline(trace)
