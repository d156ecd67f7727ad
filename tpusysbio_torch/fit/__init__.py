"""Multi-start fitting (LM or bounded TRF), profile likelihood and ensemble
MCMC (``tpusysbio/fit``'s names)."""

from tpusysbio_torch.fit.mcmc import (MCMCResult, autocorr_time,
                                      ensemble_sample)
from tpusysbio_torch.fit.multistart import (MultistartResult,
                                            TwoPhaseDriver,
                                            make_multistart_runner,
                                            multistart_fit,
                                            multistart_trf,
                                            multistart_two_phase,
                                            run_chunked)
from tpusysbio_torch.fit.profile import (ProfileResult,
                                         confidence_intervals,
                                         profile_likelihood)
from tpusysbio_torch.fit.sampling import latin_hypercube, uniform_starts

__all__ = ["MCMCResult", "MultistartResult", "ProfileResult",
           "TwoPhaseDriver", "autocorr_time", "confidence_intervals",
           "ensemble_sample", "latin_hypercube", "make_multistart_runner",
           "multistart_fit", "multistart_trf", "multistart_two_phase",
           "profile_likelihood", "run_chunked", "uniform_starts"]
