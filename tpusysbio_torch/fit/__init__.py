"""Multi-start fitting and profile likelihood (``tpusysbio/fit``'s names,
for what is ported)."""

from tpusysbio_torch.fit.multistart import (MultistartResult,
                                            TwoPhaseDriver,
                                            make_multistart_runner,
                                            multistart_fit,
                                            multistart_two_phase,
                                            run_chunked)
from tpusysbio_torch.fit.profile import (ProfileResult,
                                         confidence_intervals,
                                         profile_likelihood)
from tpusysbio_torch.fit.sampling import latin_hypercube, uniform_starts

__all__ = ["MultistartResult", "ProfileResult", "TwoPhaseDriver",
           "confidence_intervals", "latin_hypercube",
           "make_multistart_runner", "multistart_fit",
           "multistart_two_phase", "profile_likelihood", "run_chunked",
           "uniform_starts"]
