"""Quadratic Assignment Problem instances for the permutation family, the
port's own copy of ``repro.objectives.qap`` (numpy only, same seeded
generators, so the same F, D, ``best_known`` and ``p_best``).

The QAP (Koopmans–Beckmann form) assigns ``n`` facilities to ``n``
locations, minimising

    cost(p) = sum_{i,j} F[i, j] * D[p[i], p[j]]

over permutations ``p`` (facility ``i`` at location ``p[i]``), with flow
matrix ``F`` and distance matrix ``D``.  Paul (arXiv 1208.2675) drives
exactly this objective with GPU simulated annealing using pairwise-exchange
moves and O(n) delta evaluation — the combinatorial counterpart of the
paper's continuous sweep, and the forcing function for this repo's
problem-family refactor.

Instances
---------
The container vendors no QAPLIB data files, so the registry ships two
QAPLIB-*style* instances whose data is generated from seeded NumPy
generators (fully reproducible from this file alone) and whose reference
optima are *verifiable*, not copied:

``syn10``  : n=10, dense asymmetric integer matrices.  ``best_known`` is
             the **proven** optimum, found by exhaustive enumeration of
             all 10! permutations (scripted, single pass, vectorised).
``grid12`` : n=12, Nugent-style — Manhattan distances on a 3x4 grid,
             symmetric random integer flows.  ``best_known`` is the best
             value from 200k-start pairwise-swap (2-opt) descent; ~1.6%
             of random starts terminate at it, so it is the global
             optimum with overwhelming confidence.

Every instance carries a witness permutation ``p_best`` achieving
``best_known``; tests recompute its cost so any silent data corruption
(or generator drift across NumPy versions) fails loudly.

Exactness note: all entries are small integers, so every product and
partial sum in the cost (and in the swap-move delta) is an integer well
below 2**24 — float32 arithmetic on these values is *exact*, which is
what lets the serving engine's delta-evaluated kernel stay bitwise equal
to a full re-evaluation (the bit-exactness oracle extends to QAP).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class QAPInstance:
    """One registered QAP instance (matrices are read-only float32)."""

    name: str
    F: np.ndarray            #: (n, n) flow matrix, float32, integer-valued
    D: np.ndarray            #: (n, n) distance matrix, float32, integer-valued
    best_known: int          #: reference optimum (see module docstring)
    p_best: Tuple[int, ...]  #: witness permutation achieving best_known
    proven: bool             #: True when best_known is an exhaustive optimum
    source: str              #: one-line provenance of the data

    @property
    def n(self) -> int:
        return int(self.F.shape[0])

    def cost(self, p) -> np.ndarray:
        """Host-side full evaluation; ``p`` is (n,) or (chains, n) int."""
        p = np.asarray(p)
        F = self.F.astype(np.int64)
        D = self.D.astype(np.int64)
        if p.ndim == 1:
            return (F * D[np.ix_(p, p)]).sum()
        return (F[None] * D[p[:, :, None], p[:, None, :]]).sum(axis=(1, 2))


def _freeze(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    a.setflags(write=False)
    return a


def _grid_distance(rows: int, cols: int) -> np.ndarray:
    """Manhattan distances between cells of a rows x cols grid (the Nugent
    layout family; nug12 uses the same 3x4 construction)."""
    n = rows * cols
    r = np.arange(n) // cols
    c = np.arange(n) % cols
    return (np.abs(r[:, None] - r[None, :])
            + np.abs(c[:, None] - c[None, :]))


def _make_syn10() -> QAPInstance:
    g = np.random.default_rng(2675)      # arXiv 1208.2675
    F = g.integers(0, 10, (10, 10))
    D = g.integers(0, 10, (10, 10))
    np.fill_diagonal(F, 0)
    np.fill_diagonal(D, 0)
    return QAPInstance(
        name="syn10", F=_freeze(F), D=_freeze(D),
        best_known=1024, p_best=(1, 2, 0, 3, 5, 9, 6, 7, 8, 4),
        proven=True,
        source="seeded synthetic (default_rng(2675)); optimum proven by "
               "exhaustive enumeration of all 10! assignments")


def _make_grid12() -> QAPInstance:
    D = _grid_distance(3, 4)
    g = np.random.default_rng(1208)      # arXiv 1208.2675
    F = np.triu(g.integers(0, 11, (12, 12)), 1)
    F = F + F.T
    return QAPInstance(
        name="grid12", F=_freeze(F), D=_freeze(D),
        best_known=1278, p_best=(6, 0, 2, 9, 7, 3, 11, 10, 8, 5, 1, 4),
        proven=False,
        source="Nugent-style synthetic: Manhattan 3x4 grid distances, "
               "seeded symmetric flows (default_rng(1208)); best known "
               "from 200k-start 2-opt descent (~1.6% of starts reach it)")


#: Registered instances, by name — the permutation family's servable set.
INSTANCES: Dict[str, QAPInstance] = {
    inst.name: inst for inst in (_make_syn10(), _make_grid12())
}

#: Stable small integer id per instance (registry order), the permutation
#: family's analogue of a continuous ``kid``.
INSTANCE_ID = {name: i for i, name in enumerate(sorted(INSTANCES))}


def get(name: str) -> QAPInstance:
    if name not in INSTANCES:
        raise ValueError(
            f"unknown QAP instance {name!r}; registered: "
            f"{sorted(INSTANCES)}")
    return INSTANCES[name]
