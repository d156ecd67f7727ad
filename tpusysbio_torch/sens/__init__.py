"""Forward sensitivities (``tpusysbio/sens``'s names)."""

from tpusysbio_torch.sens.forward import make_sens_rhs, make_sens_rhs_dir

__all__ = ["make_sens_rhs", "make_sens_rhs_dir"]
