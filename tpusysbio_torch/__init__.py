"""tpusysbio_torch — the PyTorch/CUDA port of ``tpusysbio``.

A second package beside ``tpusysbio/`` (the JAX reference, unchanged).
It runs the same systems-biology ODE machinery on an NVIDIA H100:

- the ensemble that the JAX package gets from ``jax.vmap`` is an explicit
  leading batch dimension ``(B, ...)`` with per-member status codes and
  ``torch.where`` freezes (see ``solvers/bdf.py``);
- the TPU Pallas kernels of ``tpusysbio/linalg/pallas_lu.py`` are
  hand-written CUDA C++ kernels for ``sm_90a`` under ``linalg/csrc/``,
  built with ``nvcc`` at first use (``linalg/_build.py``); each has a plain
  PyTorch twin that runs only for CPU tensors.

The package imports ``torch`` and numpy, never ``jax`` or ``tpusysbio``.

Device rule: functions that take tensors follow their inputs' device;
entry points that build tensors from numpy or Python values take
``device=`` (default ``"cuda"``) and raise when CUDA is absent, unless the
caller asks for the CPU explicitly.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# True f32 everywhere. The reference forces jax_default_matmul_precision=
# 'highest' because bf16 contraction made the f32 Newton loop fail on every
# member (tpusysbio/__init__.py); TF32 on the card would do the same.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device() -> torch.device:
    """The CUDA device, or a ``RuntimeError`` when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpusysbio_torch runs on the GPU by default and CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``"cuda"`` raises without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        default_device()
    return dev


from tpusysbio_torch.config import (  # noqa: E402,F401
    FitConfig,
    MeshConfig,
    SolverConfig,
)
