"""A mass-action network in plain NumPy, from a configuration's frozen copy.

The configuration file (``portbench/configs/<name>.json``) holds the
network as lists: species, reactions as ``[name, reactants, products]``,
the true rate constants, the initial state and the observed species. This
module works the right-hand side, its state Jacobian and its parameter
Jacobian out again from those lists, with no code of the program under
test: every rate is ``k_j * prod(y_i for i in reactants_j)`` and the
species change by ``products - reactants``.
"""

from __future__ import annotations

import numpy as np


class Network:
    """The ODE ``dy/dt = S (k * mono(y))`` of one frozen network."""

    def __init__(self, spec: dict):
        self.species = list(spec["species"])
        self.reaction_names = [r[0] for r in spec["reactions"]]
        self.n = len(self.species)
        self.m = len(spec["reactions"])
        idx = {s: i for i, s in enumerate(self.species)}
        order = max(len(r[1]) for r in spec["reactions"])
        # reactant slots, padded with index n (a constant 1.0)
        self.slots = np.full((self.m, order), self.n, dtype=np.int64)
        self.S = np.zeros((self.n, self.m))
        for j, (_, reac, prod) in enumerate(spec["reactions"]):
            for s, sp in enumerate(reac):
                self.slots[j, s] = idx[sp]
                self.S[idx[sp], j] -= 1.0
            for sp in prod:
                self.S[idx[sp], j] += 1.0
        self.rates = np.asarray(spec["rates"], dtype=np.float64)
        self.y0 = np.asarray(spec["y0"], dtype=np.float64)
        self.obs_rows = np.asarray([idx[s] for s in spec["observables"]])

    def mono(self, y: np.ndarray) -> np.ndarray:
        """Rate monomials ``prod(y_i)`` over each reaction's reactants,
        (m,)."""
        y_ext = np.append(y, 1.0)
        return np.prod(y_ext[self.slots], axis=1)

    def dmono(self, y: np.ndarray) -> np.ndarray:
        """``d mono_j / d y_i``, (m, n): the product of the other slots,
        summed over the slots that hold species i."""
        y_ext = np.append(y, 1.0)
        vals = y_ext[self.slots]                       # (m, order)
        out = np.zeros((self.m, self.n + 1))
        rows = np.arange(self.m)
        for s in range(self.slots.shape[1]):
            others = np.prod(np.delete(vals, s, axis=1), axis=1)
            np.add.at(out, (rows, self.slots[:, s]), others)
        return out[:, :self.n]

    def d2mono(self, y: np.ndarray) -> np.ndarray:
        """``d2 mono_j / dy_i dy_l``, (m, n, n): for each ordered pair of
        slots, the product of the remaining slots."""
        y_ext = np.append(y, 1.0)
        vals = y_ext[self.slots]
        order = self.slots.shape[1]
        out = np.zeros((self.m, self.n + 1, self.n + 1))
        rows = np.arange(self.m)
        for a in range(order):
            for b in range(order):
                if a == b:
                    continue
                rest = np.prod(np.delete(vals, [a, b], axis=1), axis=1)
                np.add.at(out, (rows, self.slots[:, a], self.slots[:, b]),
                          rest)
        return out[:, :self.n, :self.n]

    def rhs(self, y: np.ndarray, p: np.ndarray) -> np.ndarray:
        return self.S @ (p * self.mono(y))

    def jac(self, y: np.ndarray, p: np.ndarray) -> np.ndarray:
        """State Jacobian ``df/dy``, (n, n)."""
        return self.S @ (p[:, None] * self.dmono(y))

    def dfdp(self, y: np.ndarray) -> np.ndarray:
        """Parameter Jacobian ``df/dk``, (n, m)."""
        return self.S * self.mono(y)[None, :]

    def observables(self, ys: np.ndarray) -> np.ndarray:
        """The observed species of states ``ys`` (..., n)."""
        return ys[..., self.obs_rows]

    def conservation(self) -> np.ndarray:
        """A basis of the left null space of S, (c, n): each row ``w``
        gives a conserved total ``w . y``."""
        u, sv, vt = np.linalg.svd(self.S.T)
        rank = int(np.sum(sv > 1e-10 * sv[0]))
        return vt[rank:]
