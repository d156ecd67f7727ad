"""Carry a model and a fit problem across from the JAX package's numpy
form.

Here the "weights" of a model are its rate-constant vector ``p`` and the
network's integer matrices; the state of a fit problem is the fields of its
``ExperimentBatch``, ``ParameterMap`` and ``Priors``. All arrive as numpy arrays (the
caller does the ``np.asarray`` on the fields of the ``tpusysbio`` objects),
so this module never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from tpusysbio_torch import resolve_device
from tpusysbio_torch.data.experiment import ExperimentBatch
from tpusysbio_torch.model.massaction import MassActionNetwork
from tpusysbio_torch.project.mapping import ParameterMap
from tpusysbio_torch.project.priors import Priors


def network_from_numpy(species: Sequence[str],
                       reaction_names: Sequence[str],
                       reactants, stoich,
                       device="cuda") -> MassActionNetwork:
    """A port network from the reference's fields: ``reactants``
    (n_reactions, n_species) and ``stoich`` (n_species, n_reactions)."""
    dev = resolve_device(device)
    R = np.asarray(reactants)
    S = np.asarray(stoich)
    if R.ndim != 2 or S.shape != R.shape[::-1]:
        raise ValueError(f"reactants {R.shape} and stoich {S.shape} must be "
                         "(rx, n) and (n, rx)")
    if len(species) != R.shape[1] or len(reaction_names) != R.shape[0]:
        raise ValueError("species/reaction_names do not match the matrices")
    return MassActionNetwork(
        species=tuple(species), reaction_names=tuple(reaction_names),
        reactants=torch.as_tensor(R.astype(np.int64), device=dev),
        stoich=torch.as_tensor(S.astype(np.int64), device=dev))


def params_from_numpy(p, device="cuda") -> torch.Tensor:
    """A ``(B, m)`` or ``(m,)`` parameter array as a float64 tensor."""
    arr = np.asarray(p, dtype=np.float64)
    if arr.ndim not in (1, 2):
        raise ValueError(f"p must be (m,) or (B, m); got {arr.shape}")
    return torch.as_tensor(arr, device=resolve_device(device))


def _tensor_fields(cls, arrays: Mapping, dev):
    """``arrays`` restricted to ``cls``'s fields: numpy arrays become
    tensors on ``dev`` (dtypes kept), plain values pass through, ``None``
    fields are dropped so that the defaults apply."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(arrays) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    out = {}
    for k, v in arrays.items():
        if v is None:
            continue
        # a copy: the caller's arrays may be read-only views
        out[k] = (torch.as_tensor(np.array(v), device=dev)
                  if isinstance(v, np.ndarray) else v)
    return out


def batch_from_reference(arrays: Mapping, device="cuda") -> ExperimentBatch:
    """The port's ``ExperimentBatch`` from the reference object's fields:
    ``{field name: numpy array or static value}``, for instance
    ``{f.name: to_numpy(getattr(ref_batch, f.name)) for f in fields}``."""
    kw = _tensor_fields(ExperimentBatch, arrays, resolve_device(device))
    for k in ("n_groups", "n_segments"):
        if k in kw:
            kw[k] = int(kw[k])
    kw["group_names"] = tuple(kw.get("group_names", ()))
    return ExperimentBatch(**kw)


def pmap_from_reference(arrays: Mapping, device="cuda") -> ParameterMap:
    """The port's ``ParameterMap`` from the reference object's fields
    (``map_idx``, ``fixed``, ``n_global``, ``theta_names``)."""
    kw = _tensor_fields(ParameterMap, arrays, resolve_device(device))
    kw["n_global"] = int(kw["n_global"])
    kw["theta_names"] = tuple(kw.get("theta_names", ()))
    return ParameterMap(**kw)


def priors_from_reference(arrays: Mapping, device="cuda") -> Priors:
    """The port's ``Priors`` from the reference object's fields
    (``theta_mu``, ``theta_w``, ``scale_mu``, ``scale_w``, ``has_theta``,
    ``has_scale``)."""
    kw = _tensor_fields(Priors, arrays, resolve_device(device))
    return Priors(**{**kw, "has_theta": bool(kw["has_theta"]),
                     "has_scale": bool(kw["has_scale"])})
