"""Experiment records (``tpusysbio/data``'s names) and the tidy-CSV
loader."""

from tpusysbio_torch.data.experiment import (Experiment, ExperimentBatch,
                                             Measurement)
from tpusysbio_torch.data.io import experiments_from_csv

__all__ = ["Experiment", "ExperimentBatch", "Measurement",
           "experiments_from_csv"]
