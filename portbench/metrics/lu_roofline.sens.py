"""Newton linear algebra (linalg/gpu_lu.py, K1/K3): the factorizations' least time over the factorization kernels' device time, in %."""

from portbench.metrics import _layers


def read(trace):
    return _layers.lu_roofline(trace)
