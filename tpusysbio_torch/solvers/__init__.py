"""ODE integrators over a batch of members, port of ``tpusysbio/solvers``.

- ``bdf``        variable-order NDF/BDF with in-stepper forward
                 sensitivities, events, dense export and windowed output;
- ``rosenbrock`` the linearly-implicit ode23s pair, fixed work per step;
- ``radau``      Radau IIA order 5;
- ``dopri5``     explicit Dormand–Prince RK45;
- ``adams``      variable-order Adams–Bashforth–Moulton (PECE);
- ``auto``       an explicit attempt with a warm handoff to BDF;

plus multiple shooting (``solvers/multishoot.py``), the post-hoc
``OdeSolution`` (``solvers/dense.py``) and the algebraic steady-state
solve (``solvers/steady_state.py``).
"""

from tpusysbio_torch.solvers.common import (  # noqa: F401
    STATUS_DONE,
    STATUS_EVENT,
    STATUS_MAX_STEPS,
    STATUS_NONFINITE,
    STATUS_RUNNING,
    STATUS_SS_FAIL,
    STATUS_STIFF,
    STATUS_TOO_SMALL_STEP,
    EventSpec,
    IntegrateResult,
)
from tpusysbio_torch.solvers.adams import adams_solve  # noqa: F401
from tpusysbio_torch.solvers.auto import auto_solve  # noqa: F401
from tpusysbio_torch.solvers.bdf import bdf_solve  # noqa: F401
from tpusysbio_torch.solvers.dense import OdeSolution  # noqa: F401
from tpusysbio_torch.solvers.dopri5 import dopri5_solve  # noqa: F401
from tpusysbio_torch.solvers.radau import radau_solve  # noqa: F401
from tpusysbio_torch.solvers.rosenbrock import rosenbrock_solve  # noqa: F401
from tpusysbio_torch.solvers.steady_state import (  # noqa: F401
    SteadyStateResult,
    steady_state,
)

SOLVERS = {
    "adams": adams_solve,
    "auto": auto_solve,
    "bdf": bdf_solve,
    "radau": radau_solve,
    "dopri5": dopri5_solve,
    "rosenbrock": rosenbrock_solve,
}
