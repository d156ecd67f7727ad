"""Start-point samplers in log-parameter space.

Port of ``tpusysbio/fit/sampling.py``: Latin hypercube (stratified, one
stratum per start per dimension) and plain uniform sampling over log-space
boxes. An explicit ``torch.Generator`` takes the place of the JAX key, so a
seeded run is reproducible; its stream differs from JAX's by construction.
The draws are made on the generator's device and returned on the device of
``lower``.
"""

from __future__ import annotations

import torch


def uniform_starts(generator: torch.Generator, n: int, lower: torch.Tensor,
                   upper: torch.Tensor) -> torch.Tensor:
    """n starts uniform in the box [lower, upper] (log space), (n, G)."""
    G = lower.shape[0]
    u = torch.rand((n, G), generator=generator, dtype=lower.dtype,
                   device=generator.device).to(lower.device)
    return lower + (upper - lower) * u


def latin_hypercube(generator: torch.Generator, n: int, lower: torch.Tensor,
                    upper: torch.Tensor) -> torch.Tensor:
    """Latin hypercube sample of n starts in [lower, upper], (n, G)."""
    G = lower.shape[0]
    # one independent permutation of strata per dimension
    perms = torch.stack([torch.randperm(n, generator=generator,
                                        device=generator.device)
                         for _ in range(G)], dim=1)          # (n, G)
    u = torch.rand((n, G), generator=generator, dtype=lower.dtype,
                   device=generator.device)
    strata = ((perms.to(lower.dtype) + u) / n).to(lower.device)  # [0, 1)
    return lower + (upper - lower) * strata
