"""Carry a model across from the JAX package's numpy form.

Here the "weights" of a model are its rate-constant vector ``p`` and the
network's integer matrices. Both arrive as numpy arrays (for instance the
fields of a ``tpusysbio`` ``MassActionNetwork``, or a parameter array that
a JAX caller holds), so this module never imports the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpusysbio_torch import resolve_device
from tpusysbio_torch.model.massaction import MassActionNetwork


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
