"""Objective assembly (``tpusysbio/project``'s names, for what is ported)."""

from tpusysbio_torch.project.mapping import ParameterMap
from tpusysbio_torch.project.priors import Priors
from tpusysbio_torch.project.residuals import Project, ProjectEval
from tpusysbio_torch.project.scale_factors import (scale_factors,
                                                   scale_factors_and_grad)

__all__ = ["ParameterMap", "Priors", "Project", "ProjectEval",
           "scale_factors", "scale_factors_and_grad"]
