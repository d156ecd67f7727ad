"""ODE integrators over a batch of members.

Ported so far: ``bdf`` — variable-order NDF/BDF with in-stepper forward
sensitivities (``solvers/bdf.py``) — and the algebraic steady-state solve
(``solvers/steady_state.py``). The other steppers of the reference are
still to port (ROADMAP.md).
"""

from tpusysbio_torch.solvers.common import (  # noqa: F401
    STATUS_DONE,
    STATUS_EVENT,
    STATUS_MAX_STEPS,
    STATUS_NONFINITE,
    STATUS_RUNNING,
    STATUS_SS_FAIL,
    STATUS_TOO_SMALL_STEP,
    IntegrateResult,
)
from tpusysbio_torch.solvers.bdf import bdf_solve  # noqa: F401
from tpusysbio_torch.solvers.steady_state import (  # noqa: F401
    SteadyStateResult,
    steady_state,
)

SOLVERS = {"bdf": bdf_solve}
