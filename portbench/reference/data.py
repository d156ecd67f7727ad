"""The fit data of each configuration, made once by the plain reference.

The observables at the configuration's measurement times under its true
rate constants, integrated at rtol 1e-10, plus noise of standard deviation
``sigma_share`` of the largest observable drawn from
``numpy.random.default_rng(noise_seed)``. ``python -m
portbench.reference.data`` writes ``portbench/data/<config>_fit.json``;
the runs read those files and simulate nothing in their set-up.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench.reference.network import Network
from portbench.reference.solve import sens_solve

HERE = Path(__file__).resolve().parents[1]


def make_fit_data(cfg: dict) -> dict:
    net = Network(cfg["network"])
    fit = cfg["fit"]
    t = np.asarray(fit["times"], dtype=np.float64)
    ys, _ = sens_solve(net, net.rates, tuple(fit["t_span"]), t,
                       C=np.zeros((net.m, 0)))
    obs = net.observables(ys)                            # (T, n_obs)
    sigma = fit["sigma_share"] * float(np.max(obs))
    rng = np.random.default_rng(fit["noise_seed"])
    data = obs + rng.normal(scale=sigma, size=obs.shape)
    return {"config": cfg["name"], "times": t.tolist(),
            "observables": list(cfg["network"]["observables"]),
            "values": data.tolist(), "sigma": sigma}


def main():
    for path in sorted((HERE / "configs").glob("*.json")):
        with open(path) as fh:
            cfg = json.load(fh)
        if "fit" not in cfg:
            continue
        out = HERE / "data" / cfg["fit"]["data"]
        with open(out, "w") as fh:
            json.dump(make_fit_data(cfg), fh, indent=1)
            fh.write("\n")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
