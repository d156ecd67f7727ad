"""Canonical models, port of ``tpusysbio/model/library.py``.

Ported so far: the Huang–Ferrell MAPK cascade (22 species, 30 mass-action
rate constants), the model of the MAPK-22 paths, and the generated
EGFR-scale receptor cascade (99 species and 146 rate constants at the
default 12 layers; the repository calls it EGFR-97). The other library
models are still to port (ROADMAP.md).
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


# ----------------------------------------------------------------------
# EGFR-scale generated network (99 species at 12 layers)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _egfr_network_on(n_layers: int,
                     device: torch.device) -> MassActionNetwork:
    """Receptor-activated dual-phosphorylation cascade.

    Layer l: a kinase (the doubly phosphorylated form of layer l-1; layer 0
    uses the ligand-receptor complex) drives A0 -> A1 -> A2 and a per-layer
    phosphatase reverses it. Each layer adds 8 species (A0, A1, A2, the
    phosphatase, 4 complexes) and 12 rate constants; the receptor module
    adds 3 species and 2 constants."""
    b = NetworkBuilder()
    b.species("L")      # ligand
    b.species("Rec")    # receptor
    b.reaction("L+Rec.bind", ["L", "Rec"], ["LR"])
    b.reaction("L+Rec.unbind", ["LR"], ["L", "Rec"])
    kinase = "LR"
    for l in range(n_layers):
        a0, a1, a2, pase = (f"A{l}_0", f"A{l}_1", f"A{l}_2", f"P{l}")
        b.catalytic(kinase, a0, a1)
        b.catalytic(kinase, a1, a2)
        b.catalytic(pase, a1, a0)
        b.catalytic(pase, a2, a1)
        kinase = a2
    return b.build(device)


def _egfr_network(n_layers: int = 12, device="cuda") -> MassActionNetwork:
    return _egfr_network_on(n_layers, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _egfr_model_on(n_layers: int, device: torch.device) -> OdeModel:
    net = _egfr_network_on(n_layers, device)
    n = net.n_species
    idx = {sp: i for i, sp in enumerate(net.species)}
    y_init = np.zeros(n)
    y_init[idx["L"]] = 0.5
    y_init[idx["Rec"]] = 0.2
    for l in range(n_layers):
        y_init[idx[f"A{l}_0"]] = 1.0
        y_init[idx[f"P{l}"]] = 0.3

    def y0(p):
        y = torch.as_tensor(y_init, dtype=p.dtype, device=p.device)
        return y.expand(p.shape[0], n).clone()

    obs_rows = [idx[f"A{l}_2"] for l in range(n_layers)]

    def observables(y, p):
        return y[:, obs_rows]

    return OdeModel(
        name=f"egfr_like_{n}", n_states=n, n_params=net.n_reactions,
        n_obs=len(obs_rows), rhs=net.rhs(), y0=y0, observables=observables,
        param_names=net.reaction_names, state_names=net.species,
        rhs_jac=net.jac(), rhs_sens=net.sens_rhs(),
        rhs_sens_dir=net.sens_rhs_dir())


def egfr_like(n_layers: int = 12, device="cuda") -> OdeModel:
    """Generated EGFR-scale mass-action network: ``3 + 8 n_layers`` species,
    ``2 + 12 n_layers`` rate constants and one observable per layer (its
    doubly phosphorylated form). 12 layers: 99 species, 146 constants, 12
    observables; n > 64, so the ``pallas`` linear solver factors its Newton
    matrix by block-Schur elimination."""
    return _egfr_model_on(n_layers, resolve_device(device))


def egfr_true_params(n_layers: int = 12, seed: int = 0,
                     device="cuda") -> torch.Tensor:
    """Rate set (``2 + 12 n_layers``,) f64 drawn log-uniformly from
    ``numpy.random.default_rng(seed)``: binding 10^[1, 2.5], unbinding
    10^[-0.5, 1], catalysis 10^[-0.5, 1.5]."""
    net = _egfr_network(n_layers, device)
    rng = np.random.default_rng(seed)
    p = np.zeros(net.n_reactions)
    for j, name in enumerate(net.reaction_names):
        if name.endswith(".bind"):
            p[j] = 10.0 ** rng.uniform(1.0, 2.5)
        elif name.endswith(".unbind"):
            p[j] = 10.0 ** rng.uniform(-0.5, 1.0)
        else:
            p[j] = 10.0 ** rng.uniform(-0.5, 1.5)
    return torch.as_tensor(p, device=resolve_device(device))
