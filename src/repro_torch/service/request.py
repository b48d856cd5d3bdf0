"""Request/result schema for the multi-tenant SA serving engine, the
counterpart of ``repro.service.request`` on the port's exchange operators,
objective math, problem families and QAP instances.

An :class:`SARequest` is one tenant's optimization job: which problem
family (``continuous`` registry objectives or ``permutation`` QAP
instances), which objective within it, at what dimensionality, with how
many parallel chains, under which cooling schedule, and until which
stopping condition.  Heterogeneous requests — across families — are
co-scheduled on one fleet by the continuous-batching engine (engine.py);
nothing here touches the device.  Everything the representation
determines (state dtype, initial-state sampler, known optimum,
family-specific field validation) is delegated to the request's
:class:`~repro_torch.objectives.families.ProblemFamily`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.core.exchange import EXCHANGES
from repro_torch.kernels import objective_math as om
from repro_torch.objectives import families as fam_mod
from repro_torch.objectives import qap

#: Objectives servable by the engine under the default (continuous)
#: family: the kernel registry.
SERVABLE = tuple(sorted(om.KID_BY_NAME))

#: Annealing method (workload class) per request:
#: ``sa`` — plain parallel SA (the paper's V1/V2, per ``exchange``);
#: ``pt`` — parallel tempering: each chain holds one rung of the request's
#:   temperature ladder, with an even/odd replica-swap pass every level;
#: ``pa`` — population annealing: Boltzmann resampling of the chain
#:   population at every temperature-level transition.
METHODS = ("sa", "pt", "pa")

#: Per-request overload policies (see scheduler.py): what the scheduler may
#: do with/for this request when the pool is saturated.  ``None`` on a
#: request defers to the scheduler-wide default.
OVERLOAD_POLICIES = ("none", "reject", "degrade", "preempt")

#: Terminal finish_reason values.  'rejected' is the only non-completed
#: terminal status: the request was dropped by SLO admission control and
#: carries no solution.  'truncated' is a completed terminal: the ladder
#: was shortened mid-flight (finish-deadline SLO degrade) and ended at
#: the truncated length — the champion up to that level is still
#: bit-exact vs a standalone run of the same truncate schedule.
TERMINAL_REASONS = ("ladder", "target", "budget", "rejected", "truncated")


@dataclasses.dataclass(frozen=True)
class SARequest:
    """One annealing job submitted to the serving engine.

    The chain budget is rounded *up* to whole slots (blocks of
    ``chains_per_slot`` chains) at admission; a request may span several
    slots, which then exchange among themselves — never across tenants.
    """

    req_id: int
    objective: str              # registry name: schwefel|rastrigin|ackley|griewank
    dim: int                    # problem dimensionality
    n_chains: int = 64          # chain budget (rounded up to slot granularity)
    T0: float = 100.0           # initial temperature
    T_min: float = 0.1          # stop temperature (ladder end)
    rho: float = 0.95           # geometric cooling factor
    N: int = 50                 # Metropolis steps per temperature level
    seed: int = 0               # RNG stream seed (placement-invariant)
    priority: int = 0           # higher = served sooner (aged for fairness)
    method: str = "sa"          # workload class: 'sa' | 'pt' | 'pa'
    exchange: str = "sync"      # 'sync' (paper V2) | 'async' (paper V1) |
                                # 'sos' (Onbasoglu–Özdamar stochastic);
                                # ignored for method 'pt'/'pa' (replica
                                # swap / resampling replaces adoption)
    pa_ess_ratio: float = 0.0   # method 'pa' only: if > 0, halve the
                                # population width whenever the effective
                                # sample size falls below ratio*width
                                # (self-driven shrink schedule)
    target_error: Optional[float] = None  # stop early once best_f - f_opt <= this
    max_evals: Optional[int] = None       # objective-evaluation budget cap
    # ---- SLO / admission-control fields (see scheduler.py) ----
    deadline: Optional[float] = None  # max queueing delay in ticks before the
                                      # reject/degrade policies drop the
                                      # request (0 = admit now or never);
                                      # None defers to the scheduler default
    min_chains: Optional[int] = None  # degrade floor: never grant fewer
                                      # chains than this (None = one slot)
    on_overload: Optional[str] = None  # per-request-class overload policy:
                                       # 'none'|'reject'|'degrade'|'preempt';
                                       # None = scheduler-wide default
    # ---- completion-deadline SLO (control plane; see autoscaler.py) ----
    finish_deadline: Optional[float] = None  # finish-tick SLO: max end-to-end
                                             # latency (arrival -> end of the
                                             # completing level) in ticks.
                                             # Distinct from `deadline` (a
                                             # queueing-delay bound): this one
                                             # is met by *ladder truncation* —
                                             # the scheduler may shorten the
                                             # remaining temperature levels of
                                             # a running job, never below
                                             # min_levels.  None = no
                                             # completion SLO (never truncated)
    min_levels: int = 1         # truncation floor: the ladder is never cut
                                # below this many temperature levels, so a
                                # late job still does a minimum of annealing
                                # work instead of returning its init state
    family: str = "continuous"  # problem family: 'continuous' (registry
                                # objectives, float32 box states) |
                                # 'permutation' (QAP instances, int32
                                # permutation states)

    def __post_init__(self):
        fam = fam_mod.get_family(self.family)   # typed error on unknown name
        if self.dim < 1 or self.n_chains < 1 or self.N < 1:
            raise ValueError("dim, n_chains and N must be positive")
        if not (0.0 < self.rho < 1.0) or self.T_min <= 0 or self.T0 <= self.T_min:
            raise ValueError("need T0 > T_min > 0 and 0 < rho < 1")
        if self.exchange not in EXCHANGES:
            raise ValueError(
                f"exchange must be one of {tuple(sorted(EXCHANGES))}")
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}")
        if not (0.0 <= self.pa_ess_ratio < 1.0):
            raise ValueError("need 0 <= pa_ess_ratio < 1")
        if self.pa_ess_ratio > 0.0 and self.method != "pa":
            raise ValueError("pa_ess_ratio requires method 'pa'")
        if self.deadline is not None and self.deadline < 0:
            raise ValueError("deadline must be >= 0 ticks")
        if self.min_chains is not None and not (
                1 <= self.min_chains <= self.n_chains):
            raise ValueError("need 1 <= min_chains <= n_chains")
        if self.on_overload is not None \
                and self.on_overload not in OVERLOAD_POLICIES:
            raise ValueError(
                f"on_overload must be one of {OVERLOAD_POLICIES} or None")
        if self.finish_deadline is not None and self.finish_deadline <= 0:
            raise ValueError("finish_deadline must be > 0 ticks")
        if not (1 <= self.min_levels <= self.n_levels):
            raise ValueError(
                f"need 1 <= min_levels <= n_levels ({self.n_levels}); "
                f"got min_levels={self.min_levels}")
        # Family-specific validation last, so its typed errors see
        # structurally-sound generic fields: servable objective, matching
        # dim, and family-incompatible controls (e.g. pa_ess_ratio or a
        # replica method on a permutation request) all fail eagerly here —
        # at construction, never mid-tick.
        fam.validate(self)

    @property
    def prob_family(self) -> "fam_mod.ProblemFamily":
        """The request's problem-family singleton."""
        return fam_mod.get_family(self.family)

    @property
    def state_dtype(self) -> np.dtype:
        """Chain-state dtype of this request's slot blocks."""
        return self.prob_family.state_dtype

    @property
    def kid(self) -> int:
        """Runtime objective id within the family: the kernel registry id
        for continuous requests, the QAP instance id for permutation
        ones (both small stable ints; dispatch never mixes families in
        one program, so the id spaces may overlap)."""
        if self.family == fam_mod.FAMILY_PERMUTATION:
            return qap.INSTANCE_ID[self.objective]
        return om.KID_BY_NAME[self.objective]

    @property
    def f_opt(self) -> Optional[float]:
        """Known optimum of the objective (None if unregistered)."""
        return self.prob_family.f_opt(self)

    @property
    def instance(self) -> qap.QAPInstance:
        """The QAP instance (permutation-family requests only)."""
        return qap.get(self.objective)

    @property
    def n_levels(self) -> int:
        """Ladder length (the paper's do/while loop)."""
        return max(1, int(math.ceil(math.log(self.T_min / self.T0)
                                    / math.log(self.rho))))

    def slots_needed(self, chains_per_slot: int) -> int:
        return max(1, -(-self.n_chains // chains_per_slot))

    def slots_floor(self, chains_per_slot: int) -> int:
        """Smallest admissible footprint in slots (the degrade floor)."""
        if self.min_chains is None:
            return 1
        return max(1, -(-self.min_chains // chains_per_slot))

    def sample_x0(self, n_chains: int) -> np.ndarray:
        """Deterministic initial states, independent of slot placement
        (family-owned: box-uniform float32 for continuous, uniform random
        permutations int32 for QAP)."""
        return self.prob_family.sample_x0(self, n_chains)

    def pt_rungs(self, n_chains: int) -> np.ndarray:
        """Parallel-tempering rung temperatures for a granted width.

        A geometric ladder T_l = T0 * (T_min/T0)^(l/(n-1)) from the
        hottest rung (chain 0, T0) to the coldest (T_min), computed in
        float64 host math and cast once to f32 — serving and standalone
        replay the identical array, whatever width was granted.
        """
        n = max(1, int(n_chains))
        if n == 1:
            return np.asarray([self.T_min], np.float32)
        frac = np.arange(n, dtype=np.float64) / (n - 1)
        return np.asarray(self.T0 * (self.T_min / self.T0) ** frac,
                          np.float64).astype(np.float32)


@dataclasses.dataclass
class RequestResult:
    """Terminal record for a served request.

    Lifecycle timestamps come in two clocks:

    * **tick-time** (``arrival_time`` .. ``finish_tick``): deterministic
      under a fixed arrival seed — what latency *tests* assert on;
    * **wall-time** (``*_wall``, seconds since the engine epoch): what a
      deployment actually observes — surfaced by ``serve_sa --json``.

    Derived latencies (``queue_delay_ticks`` etc.) are properties so the
    definitions live in exactly one place; see docs/serving.md for the
    event diagram.

    A request dropped by SLO admission control terminates with
    ``finish_reason == 'rejected'``: it carries no solution
    (``x_best is None``) and its admission-anchored latencies are nan.
    A preempted-then-resumed request records every swap-out/swap-in tick;
    its champions are bit-exact with an uninterrupted run.
    """

    req_id: int
    objective: str
    dim: int
    x_best: Optional[np.ndarray]  # (dim,); None iff rejected
    f_best: float
    levels_run: int             # temperature levels actually executed
    n_evals: int                # objective evaluations spent
    submit_tick: int            # engine tick at submission
    start_tick: int             # engine tick at admission (-1 if rejected)
    finish_tick: int            # engine tick at completion/rejection
    finish_reason: str          # 'ladder' | 'target' | 'budget' | 'rejected'
    # ---- lifecycle events (streaming/open-loop serving) ----
    arrival_time: float = 0.0   # offered-load timestamp, in (fractional) ticks
    first_tick: int = -1        # tick of the first sweep (== start_tick today)
    submit_wall: float = float("nan")      # wall s since engine epoch
    admit_wall: float = float("nan")
    first_tick_wall: float = float("nan")
    finish_wall: float = float("nan")
    # ---- SLO / preemption metadata ----
    requested_chains: int = 0   # req.n_chains as submitted
    granted_chains: int = 0     # chains actually granted (0 if rejected;
                                # < requested under the degrade policy)
    preempted_ticks: List[int] = dataclasses.field(default_factory=list)
    resumed_ticks: List[int] = dataclasses.field(default_factory=list)
    champion_history: List[float] = dataclasses.field(default_factory=list)
    # ---- sharded-pool metadata ----
    home_shard: int = 0         # engine shard that retired the request
                                # (-1 if rejected: never placed)
    migrated_ticks: List[int] = dataclasses.field(default_factory=list)
    # ---- elastic-fleet metadata (proactive degrade) ----
    # One entry per mid-flight shrink: (ladder level at the shrink,
    # chains before, chains after).  ``granted_chains`` above is the
    # *final* width; the width at admission is the first event's
    # 'before' entry (or granted_chains when the job never shrank).
    shrunk_ticks: List[int] = dataclasses.field(default_factory=list)
    shrink_events: List[tuple] = dataclasses.field(default_factory=list)
    # ---- population-annealing metadata ----
    # Self-driven ESS shrinks (same (level, before, after) shape as
    # shrink_events) are recorded separately: they are *reproduced* by a
    # standalone replay from the identical fx stream, so the bit-exactness
    # oracle must not re-apply them as an external shrink schedule.
    pa_shrink_events: List[tuple] = dataclasses.field(default_factory=list)
    # ---- completion-deadline SLO metadata (ladder truncation) ----
    # One entry per mid-flight ladder truncation: (level at the decision,
    # total levels before, total levels after) — the *level-axis* analogue
    # of shrink_events.  ``run_standalone(truncate_schedule=[(level, to),
    # ...])`` replays it bit-exactly: truncation only moves the ladder's
    # end, never any level's arithmetic, so the packed champion history is
    # a prefix-exact match of the untruncated run.
    truncated_ticks: List[int] = dataclasses.field(default_factory=list)
    truncate_events: List[tuple] = dataclasses.field(default_factory=list)

    # ---- derived status ----
    @property
    def status(self) -> str:
        """Typed terminal status: 'completed' | 'rejected'."""
        return "rejected" if self.finish_reason == "rejected" else "completed"

    @property
    def completed(self) -> bool:
        return self.finish_reason != "rejected"

    @property
    def degraded(self) -> bool:
        """Admitted with fewer chains than requested (degrade policy)."""
        return self.completed and self.granted_chains < self.requested_chains

    @property
    def n_preemptions(self) -> int:
        return len(self.preempted_ticks)

    @property
    def n_migrations(self) -> int:
        """Cross-shard moves (checkpoint/restore between shard pools)."""
        return len(self.migrated_ticks)

    @property
    def n_shrinks(self) -> int:
        """Mid-flight width reductions (proactive degrade)."""
        return len(self.shrunk_ticks)

    @property
    def n_truncations(self) -> int:
        """Mid-flight ladder truncations (finish-deadline degrade)."""
        return len(self.truncated_ticks)

    @property
    def truncated(self) -> bool:
        """The ladder was shortened to meet a finish-deadline SLO."""
        return bool(self.truncate_events)

    @property
    def admitted_chains(self) -> int:
        """Chains granted at admission (before any mid-flight shrink).

        The widest 'before' across scheduler *and* PA self-shrinks: either
        list alone understates the admission width when the first shrink
        came from the other mechanism.
        """
        befores = [int(e[1]) for e in self.shrink_events]
        befores += [int(e[1]) for e in self.pa_shrink_events]
        if befores:
            return max([self.granted_chains] + befores)
        return self.granted_chains

    # ---- derived latencies: tick clock (deterministic) ----
    @property
    def queue_delay_ticks(self) -> float:
        """Arrival -> admission, in ticks (nan if never admitted)."""
        if self.start_tick < 0:
            return float("nan")
        return self.start_tick - self.arrival_time

    @property
    def ttft_ticks(self) -> float:
        """Arrival -> end of the first temperature level, in ticks
        (time-to-first-tick: first visible annealing progress)."""
        if self.first_tick < 0:
            return float("nan")
        return self.first_tick + 1 - self.arrival_time

    @property
    def latency_ticks(self) -> float:
        """Arrival -> end of the completing temperature level, in ticks.

        Same end-of-tick convention as ``ttft_ticks`` (progress at tick t
        is visible at t+1), so latency >= ttft always holds — a request
        finishing on its first tick has latency == ttft.
        """
        return self.finish_tick + 1 - self.arrival_time

    # ---- derived latencies: wall clock ----
    @property
    def queue_delay_wall_s(self) -> float:
        return self.admit_wall - self.submit_wall

    @property
    def ttft_wall_s(self) -> float:
        return self.first_tick_wall - self.submit_wall

    @property
    def latency_wall_s(self) -> float:
        return self.finish_wall - self.submit_wall

    def to_dict(self, include_x: bool = False) -> dict:
        """JSON-ready record (``serve_sa --json``)."""
        d = {
            "req_id": self.req_id, "objective": self.objective,
            "dim": self.dim, "f_best": float(self.f_best),
            "levels_run": self.levels_run, "n_evals": self.n_evals,
            "finish_reason": self.finish_reason, "status": self.status,
            "requested_chains": self.requested_chains,
            "granted_chains": self.granted_chains,
            "preempted_ticks": list(self.preempted_ticks),
            "resumed_ticks": list(self.resumed_ticks),
            "n_preemptions": self.n_preemptions,
            "home_shard": self.home_shard,
            "migrated_ticks": list(self.migrated_ticks),
            "n_migrations": self.n_migrations,
            "shrunk_ticks": list(self.shrunk_ticks),
            "shrink_events": [list(e) for e in self.shrink_events],
            "pa_shrink_events": [list(e) for e in self.pa_shrink_events],
            "n_shrinks": self.n_shrinks,
            "truncated_ticks": list(self.truncated_ticks),
            "truncate_events": [list(e) for e in self.truncate_events],
            "n_truncations": self.n_truncations,
            "admitted_chains": self.admitted_chains,
            "arrival_time": self.arrival_time,
            "submit_tick": self.submit_tick, "start_tick": self.start_tick,
            "first_tick": self.first_tick, "finish_tick": self.finish_tick,
            "queue_delay_ticks": self.queue_delay_ticks,
            "ttft_ticks": self.ttft_ticks,
            "latency_ticks": self.latency_ticks,
            "queue_delay_wall_s": self.queue_delay_wall_s,
            "ttft_wall_s": self.ttft_wall_s,
            "latency_wall_s": self.latency_wall_s,
        }
        if include_x:
            d["x_best"] = (None if self.x_best is None
                           else np.asarray(self.x_best).tolist())
            d["champion_history"] = [float(f) for f in self.champion_history]
        return d
