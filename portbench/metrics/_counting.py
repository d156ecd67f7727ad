"""The work a run needed, counted from the stepper's counters and the
network's shapes, whatever kernels did it; and the card's peaks.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): 3.35 TB/s of HBM,
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor cores.

Counts for one stepper call, summed over its members (the counters are
per member, so a batch's masked members add nothing):

- a Newton matrix factorization (``nlu``): an LU of n x n, 2/3 n^3 flops,
  reading the matrix once and writing its factor once, 4 n^2 bytes each
  in float32 (the port factors in f32 and refines); above n = 64 the
  port's kernels factor the two diagonal blocks of a one-level Schur
  split (64 and n - 64), which is how ``lu_blocks`` counts it;
- a Newton iteration (``nfev`` less the call's initial evaluations): one
  right-hand side with its sensitivity columns, and one solve of the
  state column (2 n^2 flops; the factor in f32 read once, the right-hand
  side and the solution in f64) and of the K sensitivity columns
  (2 n^2 K flops);
- a right-hand side: each reaction's monomial and rate (its order plus 1
  multiplications) and the stoichiometric sum (2 flops a nonzero of S);
- a sensitivity right-hand side: ``(df/dy) S`` over the nonzeros of the
  state Jacobian (2 nnz(J) K) and ``(df/dk) C`` (one product a nonzero of
  S in a direction's column);
- a Jacobian (``njev``): one product a (reactant, species changed) pair
  of each reaction.

The state runs in float64 and the sensitivity columns in float32, as the
configurations state; under the mixed-precision control everything is
float32.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
KERNEL_N = 64


class Shapes:
    """The counts of one network that the work depends on."""

    def __init__(self, spec: dict):
        species = list(spec["species"])
        idx = {s: i for i, s in enumerate(species)}
        n, m = len(species), len(spec["reactions"])
        R = np.zeros((m, n))
        S = np.zeros((n, m))
        for j, (_, reac, prod) in enumerate(spec["reactions"]):
            for sp in reac:
                R[j, idx[sp]] += 1
                S[idx[sp], j] -= 1
            for sp in prod:
                S[idx[sp], j] += 1
        self.n, self.m = n, m
        self.nnz_S = int(np.count_nonzero(S))
        self.nnz_J = int(np.count_nonzero((np.abs(S) @ (R > 0)) > 0))
        order = R.sum(axis=1)
        self.rhs_flops = float(np.sum(order + 1) + 2 * self.nnz_S)
        self.jac_flops = float(np.sum((R > 0).sum(axis=1)
                                      * (S != 0).sum(axis=0)) * 2)
        self.S = S


def lu_blocks(n: int):
    """The diagonal blocks the port factors for an n x n Newton matrix."""
    return (n,) if n <= KERNEL_N else (KERNEL_N, n - KERNEL_N)


def newton_iterations(call) -> int:
    return max(call["nfev"] - call["initial_fev"] * call["B"], 0)


def lu_work(call):
    """(f32 flops, bytes) of the call's factorizations."""
    blocks = lu_blocks(call["n"])
    flops = call["nlu"] * sum(2.0 / 3.0 * b ** 3 for b in blocks)
    nbytes = call["nlu"] * sum(8.0 * b * b for b in blocks)
    return flops, nbytes


def state_solve_work(call):
    """(f64 flops, bytes) of the call's float64 state-column solves; none
    under mixed precision, where the state is float32."""
    if call["mixed"]:
        return 0.0, 0.0
    n, k = call["n"], newton_iterations(call)
    return k * 2.0 * n * n, k * (4.0 * n * n + 16.0 * n)


def least_seconds(flops, nbytes, peak):
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def step_flops(call, shapes: Shapes, n_dirs: int = None):
    """(f64 flops, f32 flops) the call's integration needed: right-hand
    sides, sensitivity products, Jacobians, factorizations and Newton
    solves. ``n_dirs`` counts the nonzeros of ``df/dk C`` (all rate
    constants when None)."""
    n, K = call["n"], call["K"]
    iters = newton_iterations(call)
    evals = call["nfev"]
    nnz_dir = shapes.nnz_S if n_dirs is None else n_dirs
    rhs = evals * shapes.rhs_flops
    sens = evals * (2.0 * shapes.nnz_J * K + nnz_dir) if K else 0.0
    jac = call["njev"] * shapes.jac_flops
    lu, _ = lu_work(call)
    solve_state = iters * 2.0 * n * n
    solve_sens = iters * 2.0 * n * n * K
    if call["mixed"]:
        return 0.0, rhs + sens + jac + lu + solve_state + solve_sens
    f64 = rhs + jac + solve_state
    f32 = sens + lu + solve_sens
    if not call["split"]:
        f64, f32 = f64 + sens + solve_sens, lu
    return f64, f32


def kernel_patterns(path) -> list:
    """The kernel name fragments of a data list, one a line."""
    with open(path) as fh:
        return [ln.strip() for ln in fh
                if ln.strip() and not ln.startswith("#")]
