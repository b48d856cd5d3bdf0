"""Problem families: the representation layer of the serving stack, the
counterpart of ``repro.objectives.families`` on the port's
``kernels/objective_math`` and ``objectives/qap``.

A *family* owns everything about a problem class that the representation
determines — the chain-state dtype and per-chain shape, the deterministic
initial-state sampler, the known optimum lookup, and which sweep kernel the
engine dispatches — while the serving machinery above it (slots, scheduler,
engine tick loop, exchange operators, checkpoint/restore) stays family-
agnostic.  A request names its family (``SARequest.family``) and an
objective *within* that family; dispatch groups are keyed by
``(family, dim, N)``, so heterogeneous families co-batch in one fleet, one
sweep kernel per family (B1 for continuous, B3 for permutation).

Registered families
-------------------
``continuous``  : the six registry objectives (objective_math) — float32
                  states in a box, per-coordinate Metropolis moves, one
                  sweep kernel for the whole registry (runtime ``kid``).
``permutation`` : QAP instances (objectives/qap.py) — int32 permutation
                  states, pairwise-exchange Metropolis moves with O(n)
                  delta evaluation (kernels/qap_sweep.py, kernel B3),
                  flow/distance matrices threaded as per-request operands.

Both families ride the same placement-invariant counter-based RNG and the
same segmented exchange, so the engine's bit-exactness oracle
(``run_standalone`` / ``serve_sa --check``) holds for either at every
macro-K.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.kernels import objective_math as om
from repro_torch.objectives import qap

FAMILY_CONTINUOUS = "continuous"
FAMILY_PERMUTATION = "permutation"

#: Known optima of the continuous registry objectives, by name (Schwefel is
#: the paper's normalized form, so its optimum is dim-free).  The engine's
#: kid-keyed ``F_OPT`` is derived from this — one source of truth.
F_OPT_BY_NAME = {
    "schwefel": -418.982887,
    "rastrigin": 0.0,
    "ackley": 0.0,
    "griewank": 0.0,
    "exponential": -1.0,
    "salomon": 0.0,
}


class ProblemFamily:
    """One problem representation: state layout + samplers + optima.

    Subclasses are stateless singletons; every method takes the request so
    a family never caches per-tenant data.  ``validate`` runs inside
    ``SARequest.__post_init__`` — family-incompatible fields fail eagerly
    with a typed ValueError at construction, never mid-tick.
    """

    #: family name — the ``SARequest.family`` value and dispatch-group key
    name: str = ""
    #: chain-state dtype of this family's slot blocks
    state_dtype: np.dtype = np.dtype(np.float32)

    def servable(self) -> Tuple[str, ...]:
        """Objective names servable under this family."""
        raise NotImplementedError

    def validate(self, req) -> None:
        """Family-specific request validation (typed ValueErrors)."""
        raise NotImplementedError

    def sample_x0(self, req, n_chains: int) -> np.ndarray:
        """Deterministic (n_chains, dim) initial states from ``req.seed``,
        independent of slot placement."""
        raise NotImplementedError

    def f_opt(self, req) -> Optional[float]:
        """Known optimum for ``req.objective`` (None if unregistered)."""
        raise NotImplementedError


class ContinuousFamily(ProblemFamily):
    """The paper's family: registry objectives over a float32 box."""

    name = FAMILY_CONTINUOUS
    state_dtype = np.dtype(np.float32)

    def servable(self) -> Tuple[str, ...]:
        return tuple(sorted(om.KID_BY_NAME))

    def validate(self, req) -> None:
        if req.objective not in om.KID_BY_NAME:
            raise ValueError(
                f"objective {req.objective!r} not servable; "
                f"one of {self.servable()}")

    def sample_x0(self, req, n_chains: int) -> np.ndarray:
        lo, hi = om.BOX[om.KID_BY_NAME[req.objective]]
        r = np.random.default_rng(req.seed)
        return (lo + r.random((n_chains, req.dim), dtype=np.float32)
                * (hi - lo)).astype(np.float32)

    def f_opt(self, req) -> Optional[float]:
        return F_OPT_BY_NAME.get(req.objective)


class PermutationFamily(ProblemFamily):
    """QAP: int32 permutation states, pairwise-exchange moves.

    Method restrictions are representational, not incidental: parallel
    tempering's rung layout and population annealing's Boltzmann-resample
    weights are defined on this stack only for the continuous sweep today,
    so ``method`` must be ``'sa'`` (all three ``exchange`` policies work —
    champion adoption copies permutations verbatim).
    """

    name = FAMILY_PERMUTATION
    state_dtype = np.dtype(np.int32)

    def servable(self) -> Tuple[str, ...]:
        return tuple(sorted(qap.INSTANCES))

    def validate(self, req) -> None:
        if req.objective not in qap.INSTANCES:
            raise ValueError(
                f"objective {req.objective!r} not servable by the "
                f"permutation family; one of {self.servable()}")
        inst = qap.INSTANCES[req.objective]
        if req.dim != inst.n:
            raise ValueError(
                f"request dim {req.dim} does not match QAP instance "
                f"{req.objective!r} size n={inst.n}")
        if req.pa_ess_ratio != 0.0:
            raise ValueError(
                "pa_ess_ratio is a population-annealing control and is "
                "invalid on a permutation-family request")
        if req.method != "sa":
            raise ValueError(
                f"method {req.method!r} is not supported by the "
                "permutation family (no temperature-rung replica layout "
                "or resampling weights for permutation states); use "
                "method='sa'")

    def sample_x0(self, req, n_chains: int) -> np.ndarray:
        # One generator, chains drawn in logical chain order — the
        # permutation analogue of the continuous box sampler, equally
        # placement-invariant.
        r = np.random.default_rng(req.seed)
        return np.stack(
            [r.permutation(req.dim) for _ in range(n_chains)]
        ).astype(np.int32)

    def f_opt(self, req) -> Optional[float]:
        return float(qap.INSTANCES[req.objective].best_known)


CONTINUOUS = ContinuousFamily()
PERMUTATION = PermutationFamily()

#: The family registry: ``SARequest.family`` values -> singleton.
FAMILIES = {f.name: f for f in (CONTINUOUS, PERMUTATION)}


def get_family(name: str) -> ProblemFamily:
    if name not in FAMILIES:
        raise ValueError(
            f"unknown problem family {name!r}; one of "
            f"{tuple(sorted(FAMILIES))}")
    return FAMILIES[name]
