"""Optimizers (``tpusysbio/optim``'s names): Levenberg–Marquardt and the
bounded Coleman–Li trust-region solver with SciPy's robust losses, each
over a batch of starts."""

from tpusysbio_torch.optim.lm import (FitResult, LMState, lm_finish, lm_fit,
                                      lm_init, lm_run)
from tpusysbio_torch.optim.trf import (TRFState, trf_finish, trf_fit,
                                       trf_init, trf_run)

__all__ = ["FitResult", "LMState", "TRFState", "lm_finish", "lm_fit",
           "lm_init", "lm_run", "trf_finish", "trf_fit", "trf_init",
           "trf_run"]
