"""The canonical fit examples behind ``cli.py fit --example``, and the
timed-input example.

The port's own copies of ``examples/jakstat_ensemble.py`` (config 4: the
JAK-STAT two-dose ensemble with shared and local parameters and two scale
groups), ``examples/mm3_fit.py`` (config 1: one Michaelis-Menten LM fit)
and ``examples/jakstat_pulse.py`` (a JAK-STAT stimulus pulse and washout
as two timed parameter clamps): the same data, problem and fit settings.
The ensemble's starts come from a ``torch.Generator`` seeded as the
reference seeds its JAX key, so they differ from the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusysbio_torch.config import FitConfig, SolverConfig
from tpusysbio_torch.data import Experiment, ExperimentBatch, Measurement
from tpusysbio_torch.fit import latin_hypercube, multistart_fit
from tpusysbio_torch.model import library
from tpusysbio_torch.optim import lm_fit
from tpusysbio_torch.project import ParameterMap, Project

JAKSTAT_DOSES = (1.0, 0.4)
JAKSTAT_SCALE_TRUE = {"pstat": 2.8, "tstat": 0.7}


def jakstat_build_project(seed=0, sigma=0.04, device="cuda"):
    """Two Epo doses share k1..k4; the input amplitude is local to each
    dose; both observables are relative, each in its own scale group.
    Returns ``(project, pmap, theta_true, scale_true)``."""
    model = library.jak_stat(device=device)
    rng = np.random.default_rng(seed)
    t = np.linspace(2.0, 60.0, 12)
    exps = []
    for amp in JAKSTAT_DOSES:
        p = np.array([[2.5, 4.0, 0.3, 0.6, amp, 6.0]])
        r = model.simulate(p, (0.0, 60.0), t,
                           config=SolverConfig(rtol=1e-10, atol=1e-12),
                           device=device)
        p_rows = torch.as_tensor(p, device=r.ys.device).expand(len(t), -1)
        obs = model.observables(r.ys[0], p_rows).cpu().numpy()
        meas = []
        for i, g in enumerate(["pstat", "tstat"]):
            vals = JAKSTAT_SCALE_TRUE[g] * obs[:, i] * (
                1 + rng.normal(scale=sigma, size=len(t)))
            meas.append(Measurement(
                obs_index=i, times=t, values=vals,
                sigmas=np.full(len(t), sigma * JAKSTAT_SCALE_TRUE[g]),
                scale_group=g))
        exps.append(Experiment(f"dose_{amp}", tuple(meas)))
    batch = ExperimentBatch.from_experiments(exps, device=device)
    pmap = ParameterMap.create(model.param_names, len(JAKSTAT_DOSES),
                               shared=("k1", "k2", "k3", "k4"),
                               local=("amp",), fixed={"tau": 6.0},
                               device=device)
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-7, atol=1e-10, max_steps=512))
    theta_true = pmap.pack({"k1": 2.5, "k2": 4.0, "k3": 0.3, "k4": 0.6,
                            "amp": np.asarray(JAKSTAT_DOSES)})
    return proj, pmap, theta_true, dict(JAKSTAT_SCALE_TRUE)


def jakstat_ensemble(device="cuda", seed=0, max_iter=60) -> dict:
    """8 Latin-hypercube starts in ``θ_true ± 1.5``, ``max_iter`` LM
    iterations each (60, as the reference's example); prints the best fit,
    its scale factors and parameters, and returns them."""
    proj, pmap, theta_true, scale_true = jakstat_build_project(device=device)
    starts = latin_hypercube(torch.Generator().manual_seed(seed), 8,
                             theta_true - 1.5, theta_true + 1.5)
    out = multistart_fit(proj.residuals, proj.residuals_and_jacobian,
                         starts, FitConfig(max_iter=max_iter)).best()
    ev = proj.evaluate(out.theta, with_jac=False)
    cost_truth = float(proj.cost(theta_true))
    scale = ev.scale.cpu().numpy()
    print(f"best: status={int(out.status)} cost={float(out.cost):.2f} "
          f"(cost at truth: {cost_truth:.2f})")
    print("fitted scale factors:",
          dict(zip(["pstat", "tstat"], np.round(scale, 3).tolist())),
          "true:", scale_true)
    theta = out.theta.cpu().numpy()
    for name, v in zip(pmap.theta_names, np.exp(theta)):
        print(f"  {name:>7s} = {v:.4f}")
    return {"status": int(out.status), "cost": float(out.cost),
            "cost_at_truth": cost_truth, "scale": scale, "theta": theta,
            "theta_names": pmap.theta_names}


def mm3_fit(device="cuda", max_iter=FitConfig.max_iter) -> dict:
    """The minimal slice: simulate, add noise, build a ``Project``, one LM
    fit from a fixed start (``max_iter`` iterations at most, the default
    ``FitConfig``'s as in the reference). Prints and returns the fit."""
    model = library.michaelis_menten(device=device)
    p_true = library.MM_TRUE_PARAMS
    t = np.linspace(0.5, 10.0, 15)
    sim = model.simulate(p_true[None], (0.0, 10.0), t,
                         config=SolverConfig(rtol=1e-10, atol=1e-12),
                         device=device)
    rng = np.random.default_rng(0)
    sigma = 0.01
    data = sim.ys[0].cpu().numpy() + rng.normal(scale=sigma,
                                                size=(len(t), 3))
    meas = tuple(Measurement(obs_index=i, times=t, values=data[:, i],
                             sigmas=np.full(len(t), sigma))
                 for i in range(3))
    batch = ExperimentBatch.from_experiments([Experiment("synthetic", meas)],
                                             device=device)
    pmap = ParameterMap.create(model.param_names, 1,
                               shared=("k1", "km1", "k2", "E0"),
                               device=device)
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-8, atol=1e-10))
    theta0 = pmap.pack({"k1": 3.0, "km1": 0.3, "k2": 0.6, "E0": 1.0})
    fit = lm_fit(proj.residuals, proj.residuals_and_jacobian, theta0[None],
                 FitConfig(max_iter=max_iter))
    print(f"status={int(fit.status[0])}  iters={int(fit.n_iter[0])}  "
          f"cost={float(fit.cost[0]):.3f}")
    theta = fit.theta[0].cpu().numpy()
    for name, v_fit, v_true in zip(pmap.theta_names, np.exp(theta), p_true):
        print(f"  {name:>4s}: fit={v_fit:8.4f}  true={v_true:8.4f}")
    return {"status": int(fit.status[0]), "cost": float(fit.cost[0]),
            "theta": theta}


# the pulse: amp -> 1 at t=5 (stimulus on), -> 0 at t=25 (washout)
JAKSTAT_PULSE = ((5.0, "amp", 1.0), (25.0, "amp", 0.0))
JAKSTAT_PULSE_TRUE = {"k1": 2.5, "k2": 4.0, "k3": 0.3, "k4": 0.6}


def jakstat_pulse_build_project(seed=0, sigma=0.02, device="cuda"):
    """JAK-STAT whose Epo stimulus is a square pulse of two timed inputs;
    k1..k4 free, amp (basal 0) and tau fixed. The data are generated
    through the segment machinery itself at rtol=1e-10, with relative
    noise ``sigma``. Returns ``(project, pmap, theta_true)``."""
    model = library.jak_stat(device=device)
    rng = np.random.default_rng(seed)
    t = np.linspace(2.0, 60.0, 15)
    zero = tuple(Measurement(obs_index=i, times=t, values=np.zeros(len(t)),
                             sigmas=np.ones(len(t))) for i in range(2))
    batch_gen = ExperimentBatch.from_experiments(
        [Experiment("pulse", zero, inputs=JAKSTAT_PULSE)],
        param_names=model.param_names, device=device)
    pmap = ParameterMap.create(model.param_names, 1,
                               shared=("k1", "k2", "k3", "k4"),
                               fixed={"amp": 0.0, "tau": 6.0}, device=device)
    proj_gen = Project(model=model, pmap=pmap, batch=batch_gen,
                       config=SolverConfig(rtol=1e-10, atol=1e-12))
    theta_true = pmap.pack(JAKSTAT_PULSE_TRUE)
    # residuals against zero data with sigma=1 ARE the simulated values
    data = proj_gen.residuals(theta_true).cpu().numpy().reshape(2, len(t))
    meas = tuple(
        Measurement(obs_index=i, times=t,
                    values=data[i] * (1 + rng.normal(scale=sigma,
                                                     size=len(t))),
                    sigmas=np.maximum(np.abs(data[i]) * sigma, 1e-3))
        for i in range(2))
    batch = ExperimentBatch.from_experiments(
        [Experiment("pulse", meas, inputs=JAKSTAT_PULSE)],
        param_names=model.param_names, device=device)
    proj = Project(model=model, pmap=pmap, batch=batch,
                   config=SolverConfig(rtol=1e-8, atol=1e-11))
    return proj, pmap, theta_true


def jakstat_pulse_fit(device="cuda", max_iter=None) -> dict:
    """One LM fit of the pulse problem from ``θ_true + 0.7`` (log space),
    ``max_iter`` iterations at most (the example's 80 by default). Prints
    and returns the fit."""
    proj, pmap, theta_true = jakstat_pulse_build_project(device=device)
    theta0 = theta_true + 0.7
    fit = lm_fit(proj.residuals, proj.residuals_and_jacobian, theta0[None],
                 FitConfig(max_iter=80 if max_iter is None else max_iter))
    cost_truth = float(proj.cost(theta_true))
    print(f"fit: status={int(fit.status[0])} iters={int(fit.n_iter[0])} "
          f"cost={float(fit.cost[0]):.3f}")
    theta = fit.theta[0].cpu().numpy()
    for name, v_fit, v_true in zip(pmap.theta_names, np.exp(theta),
                                   np.exp(theta_true.cpu().numpy())):
        print(f"  {name:>3s} = {v_fit:.4f}  (true {v_true:.4f})")
    return {"status": int(fit.status[0]), "n_iter": int(fit.n_iter[0]),
            "cost": float(fit.cost[0]), "cost_at_truth": cost_truth,
            "theta": theta, "theta_true": theta_true.cpu().numpy(),
            "theta_names": pmap.theta_names, "project": proj}
