"""ODE integrators over a batch of members.

Ported so far: ``bdf`` — variable-order NDF/BDF with in-stepper forward
sensitivities (``solvers/bdf.py``). The other steppers of the reference
are still to port (ROADMAP.md).
"""

from tpusysbio_torch.solvers.common import (  # noqa: F401
    STATUS_DONE,
    STATUS_EVENT,
    STATUS_MAX_STEPS,
    STATUS_NONFINITE,
    STATUS_RUNNING,
    STATUS_TOO_SMALL_STEP,
    IntegrateResult,
)
from tpusysbio_torch.solvers.bdf import bdf_solve  # noqa: F401

SOLVERS = {"bdf": bdf_solve}
