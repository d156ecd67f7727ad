"""Tiny cells for the harness tests: the real configurations and entries
at sizes the CPU runs in seconds (short horizons, a few members). Each
takes the name of the cell it shrinks, whose metrics a traced run reads."""

import json

from portbench import harness


def integrate_cell():
    return dict(name="mapk22-sens", config="mapk22", entry="integrate",
                chips=1, traffic={"batch": 4, "log_sd": 0.1,
                                  "t_span": [0.0, 5.0], "n_t": 6,
                                  "solver": "sens", "stepper": "bdf",
                                  "warmup_max_steps": 4, "keep_per_unit": 2,
                                  "check_members": 3},
                limits={"traj_err": 1e-3})


def fit_cell():
    return dict(name="mapk22-fit", config="mapk22", entry="fit", chips=1,
                traffic={"starts": 4, "box": 0.5, "top_k": 2,
                         "screen_iters": 1, "polish_iters": 1,
                         "screen": "screen", "polish": "tight",
                         "screen_ftol": 1e-4, "screen_xtol": 1e-4,
                         "iter_chunk": 4, "warmup_max_steps": 4,
                         "lam0": 1e-3, "check_polished": 2,
                         "profile_host_ops": False},
                limits={"top_k_miss": 0, "step_err": 0.05,
                        "polish_err": 2e-4})


def short_horizon(cfg, tmp_path, t_end):
    """``cfg`` with its fit data cut to the times up to ``t_end``, in a
    file under ``tmp_path``."""
    data = harness.load_json(harness.HERE / "data" / cfg["fit"]["data"])
    keep = [i for i, t in enumerate(data["times"]) if t <= t_end]
    data = dict(data, times=[data["times"][i] for i in keep],
                values=[data["values"][i] for i in keep])
    path = tmp_path / "data.json"
    path.write_text(json.dumps(data))
    return dict(cfg, fit=dict(cfg["fit"], data=str(path)))


def cell_and_config(kind, tmp_path):
    """The tiny cell of entry ``kind`` and its configuration."""
    cell = {"integrate": integrate_cell, "fit": fit_cell}[kind]()
    cfg = harness.load_config(cell["config"])
    if kind == "fit":
        cfg = short_horizon(cfg, tmp_path, 14.0)
    return cell, cfg


def run(kind, tmp_path, seed=2**40 + 7, traced=False, control=None):
    cell, cfg = cell_and_config(kind, tmp_path)
    return harness.run_cell(cell["name"], seed, 0.01, traced, device="cpu",
                            cell=cell, cfg=cfg, control=control)
