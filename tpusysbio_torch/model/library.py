"""Canonical models, port of ``tpusysbio/model/library.py``.

Ported so far: the Huang–Ferrell MAPK cascade (22 species, 30 mass-action
rate constants), the model of the main path. The other library models are
still to port (ROADMAP.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpusysbio_torch import resolve_device
from tpusysbio_torch.model.core import OdeModel
from tpusysbio_torch.model.massaction import (MassActionNetwork,
                                              NetworkBuilder)


@functools.lru_cache(maxsize=None)
def _mapk_network_on(device: torch.device) -> MassActionNetwork:
    b = NetworkBuilder()
    # canonical species ordering
    for sp in ["E1", "E2", "KKK", "KKKs", "KK", "KKP", "KKPP", "KKPase",
               "K", "KP", "KPP", "KPase"]:
        b.species(sp)
    b.catalytic("E1", "KKK", "KKKs")          # MAPKKK activation
    b.catalytic("E2", "KKKs", "KKK")          # MAPKKK deactivation
    b.catalytic("KKKs", "KK", "KKP")          # MAPKK phosphorylation 1
    b.catalytic("KKPase", "KKP", "KK")
    b.catalytic("KKKs", "KKP", "KKPP")        # MAPKK phosphorylation 2
    b.catalytic("KKPase", "KKPP", "KKP")
    b.catalytic("KKPP", "K", "KP")            # MAPK phosphorylation 1
    b.catalytic("KPase", "KP", "K")
    b.catalytic("KKPP", "KP", "KPP")          # MAPK phosphorylation 2
    b.catalytic("KPase", "KPP", "KP")
    return b.build(device)


def _mapk_network(device="cuda") -> MassActionNetwork:
    return _mapk_network_on(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _mapk_model_on(device: torch.device) -> OdeModel:
    net = _mapk_network_on(device)
    n = net.n_species
    idx = {sp: i for i, sp in enumerate(net.species)}
    totals = {
        "E1": 3e-5, "E2": 3e-4, "KKK": 3e-3,
        "KK": 1.2, "KKPase": 3e-4,
        "K": 1.2, "KPase": 0.12,
    }
    y_init = np.zeros(n)
    for sp, v in totals.items():
        y_init[idx[sp]] = v

    def y0(p):
        y = torch.as_tensor(y_init, dtype=p.dtype, device=p.device)
        return y.expand(p.shape[0], n).clone()

    obs_rows = [idx["KKKs"], idx["KKPP"], idx["KPP"]]

    def observables(y, p):
        return y[:, obs_rows]

    return OdeModel(
        name="mapk_huang_ferrell", n_states=n, n_params=net.n_reactions,
        n_obs=3, rhs=net.rhs(), y0=y0, observables=observables,
        param_names=net.reaction_names, state_names=net.species,
        rhs_jac=net.jac(), rhs_sens=net.sens_rhs(),
        rhs_sens_dir=net.sens_rhs_dir())


def mapk_huang_ferrell(device="cuda") -> OdeModel:
    """Huang & Ferrell (1996)-style ultrasensitive MAPK cascade: 22
    species, 30 mass-action rate constants (a, d, k per catalytic
    mechanism). Stiff at the standard enzyme/substrate separations."""
    return _mapk_model_on(resolve_device(device))


def mapk_true_params(device="cuda") -> torch.Tensor:
    """Plausible rate set (30,) f64: binding 1000, unbinding and catalysis
    150 — the stiff time-scale separation of the benchmark contract."""
    net = _mapk_network(device)
    p = np.zeros(net.n_reactions)
    for j, name in enumerate(net.reaction_names):
        p[j] = 1000.0 if name.endswith(".bind") else 150.0
    return torch.as_tensor(p, device=resolve_device(device))
