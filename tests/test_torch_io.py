"""The port's tidy-CSV loader (``tpusysbio_torch/data/io.py``) against the
JAX package's ``experiments_from_csv`` on ``tests/test_io_viz.py``'s CSV.

Every field of every record equal; the batch built from the records equal
to the hand-built one's; the same errors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_io_viz import CSV
from tpusysbio.data.io import experiments_from_csv as jexperiments_from_csv
from tpusysbio.model import library as jlibrary
from tpusysbio_torch.data import (Experiment, ExperimentBatch, Measurement,
                                  experiments_from_csv)
from tpusysbio_torch.model import library


def _records(exps):
    """Each experiment as plain Python/numpy values, field by field."""
    out = []
    for e in exps:
        d = dataclasses.asdict(e)
        d["measurements"] = [
            {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in dataclasses.asdict(m).items()}
            for m in e.measurements]
        out.append(d)
    return out


@pytest.mark.parametrize("case", ["names", "settings", "indices",
                                  "steady"])
def test_records_equal_reference(case):
    model = library.michaelis_menten(device="cpu")
    jmodel = jlibrary.michaelis_menten()
    text, kw = CSV, {}
    if case == "settings":
        kw = {"settings": {"e1": dict(fixed_params={"E0": 0.1})}}
    if case == "indices":
        text = CSV.replace(",S,", ",0,").replace(",P,", ",2,")
    if case == "steady":
        text = ("experiment,observable,time,value,steady_state\n"
                "e0,S,1.0,0.9,0\ne0,S,0.0,0.4,true\ne0,S,0.0,0.41,1\n")
    got = experiments_from_csv(text, model=model, **kw)
    want = jexperiments_from_csv(text, model=jmodel, **kw)
    assert _records(got) == _records(want)


def test_batch_equals_hand_built(tmp_path):
    path = tmp_path / "data.csv"
    path.write_text(CSV)
    exps = experiments_from_csv(str(path),
                                model=library.michaelis_menten(device="cpu"))
    hand = [
        Experiment("e0", (
            Measurement(0, [1.0, 2.0], [0.9, 0.8], [0.02, 0.02]),
            Measurement(2, [1.0, 2.0], [0.05, 0.12], [0.01, 0.01],
                        scale_group="blot"))),
        Experiment("e1", (Measurement(0, [1.5], [0.85], [0.02]),)),
    ]
    b1 = ExperimentBatch.from_experiments(exps, device="cpu")
    b2 = ExperimentBatch.from_experiments(hand, device="cpu")
    for field in ("t_eval", "values", "sigmas", "group", "mask", "m_obs"):
        assert torch.equal(getattr(b1, field), getattr(b2, field)), field


def _error_cases():
    return {
        "unknown settings": (CSV, True, {"settings": {"nope": {}}}),
        "missing column": ("experiment,time\ne0,1\n", False, {}),
        "names need a model": (CSV, False, {}),
        "duplicate times": (CSV + "e1,S,1.5,0.9,0.02,\n", True, {}),
        "unknown name": (CSV.replace(",P,", ",Q,"), True, {}),
    }


@pytest.mark.parametrize("case", list(_error_cases()))
def test_errors_match_reference(case):
    text, with_model, kw = _error_cases()[case]
    model = library.michaelis_menten(device="cpu") if with_model else None
    jmodel = jlibrary.michaelis_menten() if with_model else None
    with pytest.raises(ValueError) as got:
        experiments_from_csv(text, model=model, **kw)
    with pytest.raises(ValueError) as want:
        jexperiments_from_csv(text, model=jmodel, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        experiments_from_csv("no_such_file.csv")
