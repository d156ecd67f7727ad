"""Dense linear algebra for the Newton inner loop: plain batched LU, the
Newton solver strategies, and the CUDA kernels of ``gpu_lu`` (``inverse``;
its kernel library is built and loaded at the first launch, not here)."""

from tpusysbio_torch.linalg.gpu_lu import inverse  # noqa: F401
from tpusysbio_torch.linalg.lu import (  # noqa: F401
    lu_factor,
    lu_inverse,
    lu_solve,
    solve,
)
from tpusysbio_torch.linalg.newton import make_linear_solver  # noqa: F401
