"""Dense linear algebra for the Newton inner loop: plain batched LU, the
Newton solver strategies, and the CUDA kernels of ``gpu_lu``."""

from tpusysbio_torch.linalg.lu import lu_factor, lu_inverse, lu_solve  # noqa: F401
from tpusysbio_torch.linalg.newton import make_linear_solver  # noqa: F401
