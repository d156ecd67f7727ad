"""Optimizers (``tpusysbio/optim``'s LM names; the bounded trust-region
solver and the robust losses are not ported yet)."""

from tpusysbio_torch.optim.lm import (FitResult, LMState, lm_finish, lm_fit,
                                      lm_init, lm_run)

__all__ = ["FitResult", "LMState", "lm_finish", "lm_fit", "lm_init",
           "lm_run"]
