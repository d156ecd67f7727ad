"""Canonical models, port of ``tpusysbio/model/library.py``.

1. ``michaelis_menten``  — 3-state enzyme kinetics (config 1);
2. ``lotka_volterra``    — 2-state predator/prey whose initial conditions
                           are parameters (dy0/dp is not zero);
3. ``repressilator``     — 6-state genetic oscillator (config 2);
4. ``mapk_huang_ferrell``— 22 species, 30 mass-action rate constants,
                           stiff (config 3);
5. ``jak_stat``          — 4-state STAT5 model with a time-dependent input
                           and relative observables (config 4);
6. ``egfr_like``         — the generated receptor cascade, 99 species and
                           146 rate constants at 12 layers (config 5; the
                           repository calls it EGFR-97).

Models 1, 2, 3 and 5 are plain batched callables with no closed-form
Jacobian or sensitivity RHS: the stepper takes their Jacobian by
forward-mode AD and their sensitivities come from ``sens/forward.py``. They
are written for ``torch.func``: states and parameters are split with
``unbind(-1)``, with no in-place writes and no reads of values on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpusysbio_torch import resolve_device
from tpusysbio_torch.model.core import OdeModel
from tpusysbio_torch.model.massaction import (MassActionNetwork,
                                              NetworkBuilder)


def _constant_y0(values):
    """``y0(p)``: the same initial state for every member, (B, n)."""
    y_init = np.asarray(values, dtype=np.float64)

    def y0(p):
        y = torch.as_tensor(y_init, dtype=p.dtype, device=p.device)
        return y.expand(p.shape[0], len(y_init)).clone()

    return y0


def _all_states(y, p):
    return y


# ----------------------------------------------------------------------
# 1. Michaelis-Menten (3 states: S, C, P; params k1, km1, k2, E0)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _michaelis_menten_model() -> OdeModel:
    def rhs(t, y, p):
        s, c, _ = y.unbind(-1)
        k1, km1, k2, e0 = p.unbind(-1)
        bind = k1 * (e0 - c) * s
        return torch.stack([-bind + km1 * c, bind - (km1 + k2) * c, k2 * c],
                           dim=-1)

    return OdeModel(
        name="michaelis_menten", n_states=3, n_params=4, n_obs=3,
        rhs=rhs, y0=_constant_y0([1.0, 0.0, 0.0]), observables=_all_states,
        param_names=("k1", "km1", "k2", "E0"), state_names=("S", "C", "P"))


def michaelis_menten(device="cuda") -> OdeModel:
    """3-state enzyme kinetics, all states observed. The model holds no
    tensor; ``device`` is checked as every entry point checks it."""
    resolve_device(device)
    return _michaelis_menten_model()


MM_TRUE_PARAMS = np.array([10.0, 1.0, 1.5, 0.5])


# ----------------------------------------------------------------------
# 2. Lotka-Volterra (2 states; params a, b, c, d, x0, z0)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lotka_volterra_model() -> OdeModel:
    def rhs(t, y, p):
        x, z = y.unbind(-1)
        a, b, c, d = p[:, :4].unbind(-1)
        return torch.stack([a * x - b * x * z, -c * z + d * x * z], dim=-1)

    def y0(p):
        return p[:, 4:6].clone()

    return OdeModel(
        name="lotka_volterra", n_states=2, n_params=6, n_obs=2,
        rhs=rhs, y0=y0, observables=_all_states,
        param_names=("a", "b", "c", "d", "x0", "z0"),
        state_names=("prey", "predator"))


def lotka_volterra(device="cuda") -> OdeModel:
    """Predator/prey; the initial state is the parameters ``x0``, ``z0``."""
    resolve_device(device)
    return _lotka_volterra_model()


LV_TRUE_PARAMS = np.array([1.5, 1.0, 3.0, 1.0, 1.0, 1.0])


# ----------------------------------------------------------------------
# 3. Repressilator (6 states; params alpha, alpha0, beta, n)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _repressilator_model() -> OdeModel:
    def rhs(t, y, p):
        m, prot = y[:, :3], y[:, 3:]
        alpha, alpha0, beta, n = (x[:, None] for x in p.unbind(-1))
        repressor = torch.roll(prot, 1, dims=-1)  # protein i-1 represses i
        dm = -m + alpha / (1.0 + repressor ** n) + alpha0
        dp = -beta * (prot - m)
        return torch.cat([dm, dp], dim=-1)

    def observables(y, p):
        return y[:, 3:]  # proteins (e.g. fluorescent reporters)

    return OdeModel(
        name="repressilator", n_states=6, n_params=4, n_obs=3,
        rhs=rhs, y0=_constant_y0([0.2, 0.1, 0.3, 0.1, 0.4, 0.5]),
        observables=observables,
        param_names=("alpha", "alpha0", "beta", "n"),
        state_names=("m1", "m2", "m3", "p1", "p2", "p3"))


def repressilator(device="cuda") -> OdeModel:
    """Three-gene ring oscillator; the proteins are observed. The Hill
    power is the parameter ``n``."""
    resolve_device(device)
    return _repressilator_model()


REPRESSILATOR_TRUE_PARAMS = np.array([50.0, 1.0, 5.0, 2.0])


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
# 5. JAK-STAT (4 states, a driven input, relative observables)
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jak_stat_model() -> OdeModel:
    def input_u(t, amp, tau):
        x = t / tau
        return amp * x * torch.exp(1.0 - x)  # smooth pulse peaking at tau

    def rhs(t, y, p):
        x1, x2, x3, x4 = y.unbind(-1)
        k1, k2, k3, k4, amp, tau = p.unbind(-1)
        r1 = k1 * input_u(t, amp, tau) * x1
        r2 = k2 * x2 * x2
        r3 = k3 * x3
        r4 = k4 * x4
        return torch.stack([-r1 + 2.0 * r4, r1 - 2.0 * r2, r2 - r3, r3 - r4],
                           dim=-1)

    def observables(y, p):
        x1, x2, x3, _ = y.unbind(-1)
        return torch.stack([
            x2 + 2.0 * x3,        # total phosphorylated STAT (relative)
            x1 + x2 + 2.0 * x3,   # total cytoplasmic STAT (relative)
        ], dim=-1)

    return OdeModel(
        name="jak_stat", n_states=4, n_params=6, n_obs=2,
        rhs=rhs, y0=_constant_y0([1.0, 0.0, 0.0, 0.0]),
        observables=observables,
        param_names=("k1", "k2", "k3", "k4", "amp", "tau"),
        state_names=("STAT", "pSTAT", "pSTAT_dimer", "nSTAT"))


def jak_stat(device="cuda") -> OdeModel:
    """STAT5 cycling driven by a pulse input ``u(t)`` (EpoR activity) of
    amplitude ``amp`` peaking at ``tau``; the RHS reads ``t``, (B,), of the
    dtype the stepper evaluates in. The observables are relative, so a fit
    needs scale factors."""
    resolve_device(device)
    return _jak_stat_model()


JAKSTAT_TRUE_PARAMS = np.array([2.5, 4.0, 0.3, 0.6, 1.0, 6.0])


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
