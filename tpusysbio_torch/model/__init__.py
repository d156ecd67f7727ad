"""Models: the batched ``OdeModel`` container, mass-action networks, the
model library and the SymPy/SBML front ends (``from_sympy``; ``from_sbml``
is loaded on first use, as in the reference, so that importing the
package does not import SymPy)."""

from tpusysbio_torch.model.core import OdeModel  # noqa: F401
from tpusysbio_torch.model.massaction import (  # noqa: F401
    MassActionNetwork,
    NetworkBuilder,
)
from tpusysbio_torch.model.sympy_import import from_sympy  # noqa: F401
from tpusysbio_torch.model import library  # noqa: F401


def __getattr__(name):
    if name == "from_sbml":
        from tpusysbio_torch.model.sbml_import import from_sbml
        return from_sbml
    raise AttributeError(name)
