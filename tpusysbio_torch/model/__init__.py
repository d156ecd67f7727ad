"""Models: the batched ``OdeModel`` container, mass-action networks and
the model library."""

from tpusysbio_torch.model.core import OdeModel  # noqa: F401
from tpusysbio_torch.model.massaction import (  # noqa: F401
    MassActionNetwork,
    NetworkBuilder,
)
