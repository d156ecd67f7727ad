"""Experiment records (``tpusysbio/data``'s names)."""

from tpusysbio_torch.data.experiment import (Experiment, ExperimentBatch,
                                             Measurement)

__all__ = ["Experiment", "ExperimentBatch", "Measurement"]
