"""Admission/packing scheduler for the SA serving engine, the port's copy
of ``repro.service.scheduler`` (pure Python, imports repointed).

Continuous batching needs two decisions per tick: *which* queued requests to
admit, and *whether* to hold slots back for a large request that cannot fit
yet.  The base policy is priority-with-aging plus bounded backfill:

* effective priority = static priority + ``aging`` x ticks queued, so a
  low-priority request cannot starve forever (the fairness half of
  Russkov-style replica redistribution: the pool keeps being re-packed as
  ladders finish at different times);
* requests are scanned in effective-priority order and admitted greedily
  while they fit (*backfill*: a small request may overtake a large one that
  is short on slots, keeping occupancy high);
* once the head-of-line request has waited more than ``hol_patience`` ticks,
  backfill past it stops, letting freed slots accumulate until it fits —
  bounded head-of-line starvation instead of either extreme.

On top of that sit the **overload policies** (per request class via
``SARequest.on_overload``, defaulting to ``SchedulerConfig.overload``),
which decide what happens when a request cannot be admitted at full width:

* ``reject``  — SLO fast-fail: once the request has queued longer than its
  ``deadline`` (ticks; ``deadline=0`` means *admit now or never*) it is
  dropped with a typed 'rejected' status.  This bounds both queue length
  and the queueing delay of everything that *is* admitted.
* ``degrade`` — admit immediately with fewer chains, down to the request's
  ``min_chains`` floor (rounded up to whole slots; one slot if unset).
  Champion exchange scales with it automatically (the segmented reduce runs
  over whatever blocks the request holds), and the run is bit-exact with a
  standalone run at the granted chain count.  The ``reject`` deadline is
  kept as a backstop — if even the floor cannot be admitted in time the
  request is dropped — so degrade also bounds queue growth.
* ``preempt`` — evict the lowest-effective-priority active job(s) whose
  effective priority is *strictly* below the candidate's, bounded by
  ``preemption_budget`` evictions per tick, checkpoint them to host
  (:class:`~repro_torch.service.slots.SwappedJob`) and re-queue them for a
  bit-exact resume.  Because every job ages at the same rate, preemption
  order is stable — no eviction/resume thrash cycles.  Surplus slots an
  eviction frees beyond the urgent arrival's need are reserved for work
  that outranks the victims for the rest of the tick: eviction never
  directly funds a lower-priority admission (from the next tick on the
  ordinary backfill/aging/hol rules govern them again).

With the slot pool sharded over a device mesh (sharding.py), the
scheduler additionally owns the **placement layer**:

* :meth:`AdmissionScheduler.place` orders the shards for each tick's
  admission scans — least-loaded first, with a locality tie-break toward
  a shard already running the queue head's ``(family, dim, N)`` dispatch
  shape — so every admitted request's *home shard* is the emptiest
  compatible one, deterministically;
* :meth:`AdmissionScheduler.plan_migrations` rebalances à la Russkov
  et al. (arXiv:2006.00561): when the queue head fits on no single shard
  but the pool as a whole has room, it plans bounded cross-shard moves
  (checkpoint on the donor, restore on the recipient — bit-exact, since
  restore is placement-invariant) until the head is admissible.

The **elastic-fleet layer** (this PR) extends placement in three ways,
all riding the same bit-exact ``SwappedJob`` checkpoint/restore:

* :meth:`AdmissionScheduler.plan_evacuation` — shard drain.  Jobs on a
  draining shard are moved onto the survivors in effective-priority
  order (highest first: the most important work is off the doomed
  device soonest), bounded per tick.  A job no survivor can seat whole
  is *shrunk into* the roomiest survivor if its overload class allows
  (down to its ``min_chains`` floor), and swapped out to the queue as
  the last resort — drain always makes progress and never loses work.
* :meth:`AdmissionScheduler.plan_rebalance` — watermark rebalancing.
  Generalizes head-of-queue defrag into a *background* load balancer:
  every tick, narrow jobs are moved from shards whose utilization
  exceeds ``high_watermark`` onto shards below ``low_watermark``.
  Hysteresis is structural: a move is only planned when the donor stays
  at least as loaded as the recipient afterwards, so the load ordering
  never inverts and a later tick can never plan the reverse move.
* :meth:`AdmissionScheduler.plan_shrinks` — proactive degrade.  When
  the queue head fits on no shard and migration cannot help (the pool
  is genuinely full), *running* degrade-class jobs of strictly lower
  effective priority are shrunk in place (checkpoint -> restore at
  fewer slots, never below their floor) until the head seats — the
  admission-time 'degrade' policy applied to work already in flight.

Invariants
----------
* The scheduler never over-commits: the slots granted by one ``admit()``
  plan are <= the ``free_slots`` it was offered plus the slots released by
  the evictions in the same plan.
* Admission order is deterministic: effective-priority sort is stable with
  ties broken by submission order, so a fixed (request mix, arrival seed)
  reproduces the exact same packing — the foundation of the engine's
  reproducible latency distributions.
* Swapped (preempted) jobs are *admitted work*: they resume at exactly
  their granted width and are never rejected or degraded — only delayed.
* Scheduling is objective-blind.  Since the kernels dispatch the objective
  id at runtime, co-batching never constrains *which* requests may share a
  device program — only shape ``(family, dim, N)`` does (the family picks
  the sweep kernel and state dtype), and that grouping happens downstream
  in the engine.
* The scheduler holds only queue entries ``(request, submit_tick, swapped
  checkpoint)``; open-loop arrival timestamps live in the engine's
  lifecycle records (engine.py), so queue policy and load generation stay
  decoupled.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.service.request import OVERLOAD_POLICIES, SARequest
from repro_torch.service.slots import ActiveJob, SwappedJob
from repro_torch.service.telemetry import NULL as NULL_TELEMETRY


def _planned(kind: str):
    """Report a planner's action count to the scheduler's telemetry
    (``sa_scheduler_plans_total{plan=kind}``).  A no-op call when
    telemetry is off (the default ``NULL`` bundle)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            self.telemetry.plan(kind, len(out))
            return out
        return wrapper
    return deco


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    policy: str = "priority"    # 'priority' (aged) | 'fifo'
    aging: float = 0.05         # priority points per queued tick
    hol_patience: int = 16      # ticks the head may starve before backfill stops
    overload: str = "none"      # default overload policy for requests whose
                                # on_overload is None: 'none'|'reject'|
                                # 'degrade'|'preempt'
    default_deadline: Optional[float] = None  # deadline (ticks) for requests
                                              # that set none themselves
    preemption_budget: int = 1  # max swap-outs per tick
    # ---- elastic-fleet knobs (inert at the defaults) ----
    high_watermark: float = 1.0  # shard utilization above which the
                                 # background rebalancer moves work off
                                 # (1.0 = never: disabled)
    low_watermark: float = 0.0   # shard utilization below which a shard
                                 # may receive rebalanced work (0.0 =
                                 # never: disabled)
    proactive_degrade: bool = False  # shrink *running* degrade-class jobs
                                     # when the queue head fits nowhere
    shrink_budget: int = 1      # max in-place shrinks per tick

    def __post_init__(self):
        if self.policy not in ("priority", "fifo"):
            raise ValueError("policy must be 'priority' or 'fifo'")
        if self.overload not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload must be one of {OVERLOAD_POLICIES}")
        if self.default_deadline is not None and self.default_deadline < 0:
            raise ValueError("default_deadline must be >= 0 ticks")
        if self.preemption_budget < 0:
            raise ValueError("preemption_budget must be >= 0")
        if not (0.0 <= self.low_watermark <= self.high_watermark <= 1.0):
            raise ValueError(
                "need 0 <= low_watermark <= high_watermark <= 1")
        if self.shrink_budget < 0:
            raise ValueError("shrink_budget must be >= 0")


@dataclasses.dataclass
class QueueEntry:
    """One queued unit of work: a fresh request, or a preempted job's
    checkpoint waiting to resume (``swapped`` set)."""

    req: SARequest
    submit_tick: int            # original submission tick — the aging base
                                # survives preemption, so swapped jobs age
                                # ahead of newer arrivals
    swapped: Optional[SwappedJob] = None


@dataclasses.dataclass
class AdmissionPlan:
    """One tick's admission decisions, in execution order for the engine:
    reject, then evict (frees slots), then place."""

    admitted: List[Tuple[QueueEntry, int]] = dataclasses.field(
        default_factory=list)   # (entry, granted_slots)
    evict: List[int] = dataclasses.field(default_factory=list)  # rids
    rejected: List[QueueEntry] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ShardedAdmissionPlan:
    """One tick's admission decisions across every shard, in execution
    order for the engine: reject, then evict (frees slots), then place.
    ``admitted`` and ``evict`` entries carry their shard index — rids are
    shard-local."""

    admitted: List[Tuple[QueueEntry, int, int]] = dataclasses.field(
        default_factory=list)   # (entry, granted_slots, shard index)
    evict: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)   # (rid, shard index)
    rejected: List[QueueEntry] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ShardView:
    """Scheduler-facing snapshot of one engine shard — the placement
    layer's input.  The scheduler never touches pools or devices; the
    engine summarizes each shard into (free capacity, resident jobs,
    resident dispatch shapes) before asking for placement or migration
    decisions."""

    index: int                          # engine shard id
    free_slots: int
    active: Tuple[ActiveJob, ...]       # jobs resident on the shard
    shapes: FrozenSet[Tuple[str, int, int]]  # (family, dim, N) dispatch
                                             # shapes resident

    @property
    def used_slots(self) -> int:
        return sum(len(j.slots) for j in self.active)

    @property
    def capacity(self) -> int:
        """Total slots on the shard (free + held)."""
        return self.free_slots + self.used_slots


#: One planned cross-shard move: (rid on the donor shard, donor shard
#: index, recipient shard index).
Migration = Tuple[int, int, int]

#: One planned in-place shrink (proactive degrade): (rid, shard index,
#: slots to keep — strictly fewer than held, never below the floor).
Shrink = Tuple[int, int, int]

#: One planned finish-deadline ladder truncation: (rid, shard index,
#: total levels to keep — strictly fewer than the job's current limit,
#: never below the request's ``min_levels`` floor).
Truncation = Tuple[int, int, int]

#: One planned drain-evacuation action, in execution order — always a
#: 5-tuple ``(kind, rid, src, dst, width)``:
#: ('migrate', rid, src, dst, width) moves the job whole;
#: ('shrink', rid, src, dst, new_width) migrates keeping only the first
#: ``new_width`` slots; ('swap', rid, src, -1, 0) checkpoints the job to
#: the queue for a later bit-exact resume (no destination, no width).
Evacuation = Tuple[str, int, int, int, int]


class AdmissionScheduler:
    """FIFO/priority queue with aging, bounded backfill and SLO policies."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None):
        # A fresh default per instance: a shared default-argument config
        # instance would make every scheduler alias one object.
        self.cfg = SchedulerConfig() if cfg is None else cfg
        self._queue: List[QueueEntry] = []
        # The engine re-binds this to its own bundle; standalone
        # schedulers observe nothing.
        self.telemetry = NULL_TELEMETRY

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> List[SARequest]:
        return [e.req for e in self._queue]

    @property
    def entries(self) -> Tuple[QueueEntry, ...]:
        """Read-only snapshot of the queue (controller backlog signal:
        swapped entries expose their remaining-levels checkpoint)."""
        return tuple(self._queue)

    def submit(self, req: SARequest, tick: int) -> None:
        self._queue.append(QueueEntry(req, tick))

    def requeue(self, swapped: SwappedJob) -> None:
        """Put a preempted job back in the queue to await resume."""
        self._queue.append(QueueEntry(swapped.job.req,
                                      swapped.job.submit_tick, swapped))

    # ----------------------------------------------------------- policy bits
    def overload_policy(self, req: SARequest) -> str:
        return req.on_overload if req.on_overload is not None \
            else self.cfg.overload

    def _degradable(self, job) -> bool:
        """Mid-flight width-shrinkable: degrade-class, and not parallel
        tempering — a PT job's width *is* its temperature-ladder
        resolution, so truncating it in place would change the method
        rather than the budget (PA jobs stay shrinkable; their resampling
        composes with any width schedule).  Admission-time degrade is
        unaffected: granting a PT request fewer chains up front just
        builds a coarser ladder from level 0."""
        return (self.overload_policy(job.req) == "degrade"
                and job.req.method != "pt")

    def deadline_of(self, req: SARequest) -> Optional[float]:
        return req.deadline if req.deadline is not None \
            else self.cfg.default_deadline

    def effective_priority(self, req: SARequest, submit_tick: int,
                           tick: int) -> float:
        return req.priority + self.cfg.aging * (tick - submit_tick)

    def _ordered(self, tick: int) -> List[QueueEntry]:
        if self.cfg.policy == "fifo":
            return list(self._queue)
        # Stable sort: ties broken by submission order (list order).
        return sorted(self._queue, key=lambda e: -self.effective_priority(
            e.req, e.submit_tick, tick))

    def _expired(self, entry: QueueEntry, tick: int) -> bool:
        """Deadline fast-fail: reject/degrade-class requests are dropped the
        first admit scan after their queueing delay exceeds the deadline.
        Swapped jobs are admitted work and are never dropped."""
        if entry.swapped is not None:
            return False
        if self.overload_policy(entry.req) not in ("reject", "degrade"):
            return False
        deadline = self.deadline_of(entry.req)
        return deadline is not None and tick - entry.submit_tick > deadline

    # ------------------------------------------------------------- placement
    def _head(self, tick: int) -> Optional[QueueEntry]:
        """Highest-effective-priority queued entry that is not expired —
        the one whose placement the shard ordering optimizes for."""
        for entry in self._ordered(tick):
            if not self._expired(entry, tick):
                return entry
        return None

    @staticmethod
    def _shard_key(free: int, has_shape: bool, index: int):
        """Deterministic shard preference: least-loaded first (most free
        slots), then locality (a shard already running the request's
        ``(family, dim, N)`` dispatch shape dispatches it without opening
        a new per-shard device program), then lowest index."""
        return (-free, 0 if has_shape else 1, index)

    def place(self, shards: Sequence[ShardView], tick: int
              ) -> List[ShardView]:
        """Home-shard preference order for the queue head.

        The ordering primitive behind :meth:`admit_sharded` (which
        re-evaluates it per entry against live free counts): least-loaded
        first, locality tie-break toward the head's ``(family, dim, N)``
        shape, then index — fully deterministic, like the admission order
        itself.
        """
        head = self._head(tick)
        head_shape = (head.req.family, head.req.dim, head.req.N) \
            if head is not None else None
        return sorted(shards, key=lambda s: self._shard_key(
            s.free_slots, head_shape in s.shapes, s.index))

    @_planned("migrate")
    def plan_migrations(self, shards: Sequence[ShardView],
                        chains_per_slot: int, tick: int,
                        budget: int) -> List[Migration]:
        """Russkov-style rebalance: cross-shard moves that seat the head.

        Fires only when the queue head fits on *no* single shard but the
        pool as a whole has room: jobs are then checkpointed off one donor
        shard onto other shards' free slots until the donor can seat the
        head.  Moves are bounded by ``budget`` per tick, prefer the donor
        already closest to fitting, and move the narrowest jobs first
        (smallest checkpoints).  Migration never perturbs a trajectory —
        restore is placement-invariant — so no priority test guards it;
        thrash is impossible because a plan is only returned when it makes
        the head admissible, which removes the head from the queue.

        Returns ``(rid, donor shard, recipient shard)`` moves in execution
        order; empty when the head fits somewhere (or nothing can help).
        """
        if budget <= 0 or len(shards) < 2 or not self._queue:
            return []                   # one shard has no recipient
        head = self._head(tick)
        if head is None:
            return []
        need = head.swapped.n_slots if head.swapped is not None \
            else head.req.slots_needed(chains_per_slot)
        if max((s.free_slots for s in shards), default=0) >= need:
            return []                   # fits already: admission handles it
        # Donor candidates, closest-to-fitting first (fewest slots to
        # clear), ties by index.  Recipients absorb moved jobs into their
        # genuinely-free slots only.
        for donor in sorted(shards, key=lambda s: (-s.free_slots, s.index)):
            freed = donor.free_slots
            moves: List[Migration] = []
            rec_free = {s.index: s.free_slots for s in shards
                        if s.index != donor.index}
            # Narrowest jobs first: cheapest checkpoints, finest packing.
            for job in sorted(donor.active,
                              key=lambda j: (len(j.slots), j.rid)):
                if freed >= need or len(moves) >= budget:
                    break
                width = len(job.slots)
                target = min((i for i, f in rec_free.items() if f >= width),
                             key=lambda i: (-rec_free[i], i), default=None)
                if target is None:
                    continue
                moves.append((job.rid, donor.index, target))
                rec_free[target] -= width
                freed += width
            if freed >= need and moves:
                return moves
        return []

    # ---------------------------------------------------------- elastic fleet
    @_planned("evacuate")
    def plan_evacuation(self, draining: Sequence[ShardView],
                        survivors: Sequence[ShardView],
                        chains_per_slot: int, tick: int,
                        budget: int) -> List[Evacuation]:
        """Plan this tick's shard-drain moves (bounded by ``budget``).

        Jobs leave draining shards in effective-priority order (highest
        first — the most important work is off the retiring device
        soonest, and keeps annealing without a queue round-trip).  Per
        job, in preference order:

        1. **migrate** whole onto the survivor with the most free room
           (lowest index on ties) — zero trajectory perturbation;
        2. **shrink-migrate**: a degrade-class job that fits nowhere
           whole is restored on the roomiest survivor at the width that
           fits, never below its ``min_chains`` floor (the proactive-
           degrade pressure valve applied to drain);
        3. **swap** out to the queue — the job checkpoints to host and
           resumes bit-exactly on whichever survivor next has room
           (swapped jobs are admitted work: never rejected or degraded).

        Drain therefore always makes progress and never loses work.
        """
        if budget <= 0 or not survivors:
            return []
        free = {s.index: s.free_slots for s in survivors}
        actions: List[Evacuation] = []
        jobs = [(j, d.index) for d in sorted(draining, key=lambda s: s.index)
                for j in d.active]
        jobs.sort(key=lambda ji: (-self.effective_priority(
            ji[0].req, ji[0].submit_tick, tick), ji[1], ji[0].rid))
        for job, src in jobs:
            if len(actions) >= budget:
                break
            width = len(job.slots)
            dst = min((i for i, f in free.items() if f >= width),
                      key=lambda i: (-free[i], i), default=None)
            if dst is not None:
                actions.append(("migrate", job.rid, src, dst, width))
                free[dst] -= width
                continue
            floor = job.req.slots_floor(chains_per_slot)
            roomiest = min(free, key=lambda i: (-free[i], i))
            if (self._degradable(job)
                    and floor <= free[roomiest] and floor < width):
                keep = min(free[roomiest], width - 1)
                actions.append(("shrink", job.rid, src, roomiest, keep))
                free[roomiest] -= keep
                continue
            actions.append(("swap", job.rid, src, -1, 0))
        return actions

    @_planned("rebalance")
    def plan_rebalance(self, shards: Sequence[ShardView], tick: int,
                       budget: int) -> List[Migration]:
        """Watermark rebalancing: background load-driven moves each tick.

        Generalizes :meth:`plan_migrations` (which fires only for the
        queue head) into a continuous balancer: while some shard's
        utilization exceeds ``high_watermark`` and another sits below
        ``low_watermark``, the narrowest job on the most-loaded shard
        moves to the least-loaded one — checkpoint/restore, bit-exact —
        bounded by ``budget`` per tick.

        Hysteresis is structural, not temporal: a move is planned only
        if the donor remains at least as loaded as the recipient after
        it (``used_src - w >= used_dst + w``).  The load ordering never
        inverts, so no later tick can profitably plan the reverse move —
        thrash is impossible by construction, without cooldown state.
        """
        hi, lo = self.cfg.high_watermark, self.cfg.low_watermark
        if budget <= 0 or len(shards) < 2 or (hi >= 1.0 and lo <= 0.0):
            return []
        cap = {s.index: s.capacity for s in shards}
        used = {s.index: s.used_slots for s in shards}
        jobs = {s.index: sorted(s.active, key=lambda j: (len(j.slots), j.rid))
                for s in shards}
        moves: List[Migration] = []
        while len(moves) < budget:
            util = {i: used[i] / max(cap[i], 1) for i in cap}
            srcs = sorted((i for i in cap if util[i] > hi),
                          key=lambda i: (-util[i], i))
            dsts = sorted((i for i in cap if util[i] < lo),
                          key=lambda i: (util[i], i))
            planned = None
            for si in srcs:
                for job in jobs[si]:          # narrowest first
                    w = len(job.slots)
                    for di in dsts:
                        if di == si or cap[di] - used[di] < w:
                            continue
                        if used[si] - w < used[di] + w:
                            continue          # would invert the ordering
                        planned = (job, si, di)
                        break
                    if planned:
                        break
                if planned:
                    break
            if planned is None:
                break
            job, si, di = planned
            moves.append((job.rid, si, di))
            jobs[si].remove(job)
            used[si] -= len(job.slots)
            used[di] += len(job.slots)
        return moves

    @_planned("shrink")
    def plan_shrinks(self, shards: Sequence[ShardView],
                     chains_per_slot: int, tick: int,
                     budget: int) -> List[Shrink]:
        """Proactive degrade: shrink *running* jobs to seat the queue head.

        Fires only when the head fits on no shard at full width (the
        same trigger as the admission-time fallbacks) and the pool has
        no free room migration could consolidate.  Candidates are
        degrade-class jobs holding more than their floor whose effective
        priority is *strictly* below the head's (the preempt policy's
        inversion guard, applied to width instead of residency).  On one
        shard — cheapest victims first, largest reclaimable surplus on
        ties — widths are cut just enough for the head to seat there;
        all-or-nothing, bounded by ``budget`` per tick.

        Returns ``(rid, shard index, slots to keep)`` in execution
        order; empty when the head is seatable anyway or no shard can
        reclaim enough width.
        """
        if budget <= 0 or not self._queue:
            return []
        head = self._head(tick)
        if head is None:
            return []
        need = head.swapped.n_slots if head.swapped is not None \
            else head.req.slots_needed(chains_per_slot)
        if max((s.free_slots for s in shards), default=0) >= need:
            return []                   # admission will seat it
        head_eff = self.effective_priority(head.req, head.submit_tick, tick)
        for view in sorted(shards, key=lambda s: (-s.free_slots, s.index)):
            cands = []
            for job in view.active:
                floor = job.req.slots_floor(chains_per_slot)
                eff = self.effective_priority(job.req, job.submit_tick, tick)
                if (self._degradable(job)
                        and len(job.slots) > floor and eff < head_eff):
                    cands.append((eff, floor - len(job.slots), job.rid,
                                  job, floor))
            cands.sort()                # cheapest first, widest surplus ties
            avail = view.free_slots
            plan: List[Shrink] = []
            for eff, _, rid, job, floor in cands:
                if avail >= need or len(plan) >= budget:
                    break
                take = min(len(job.slots) - floor, need - avail)
                plan.append((rid, view.index, len(job.slots) - take))
                avail += take
            if avail >= need and plan:
                return plan
        return []

    @_planned("truncate")
    def plan_truncations(self, shards: Sequence[ShardView],
                         tick: int) -> List[Truncation]:
        """Finish-deadline degrade on the *level* axis: cut a running
        job's remaining temperature levels when, at one level per tick
        from now, it would finish past its ``finish_deadline``.

        The latest finish tick that still meets the SLO is
        ``D = arrival_time + finish_deadline - 1`` (completion latency is
        ``finish_tick + 1 - arrival_time``).  A job at ``level`` of
        ``limit`` total levels finishes at ``tick + (limit - level) - 1``;
        when that overshoots, the ladder is cut to
        ``level + floor(D - tick) + 1`` total levels, clamped to the
        request's ``min_levels`` floor — an over-late job keeps at least
        its floor and misses the SLO rather than returning garbage.

        Runs at macro-tick boundaries (the engine calls it right after
        admission), so recorded truncation levels are K-aligned for
        ``run_standalone`` replay, exactly like shrink schedules.  Unlike
        width shrinks, truncation is method-agnostic: it moves the
        ladder's end without touching any level's arithmetic, so PT and
        PA jobs are as cuttable as plain SA.

        Returns ``(rid, shard index, total levels to keep)`` in
        execution order.
        """
        plan: List[Truncation] = []
        for view in shards:
            for job in view.active:
                fd = job.req.finish_deadline
                if fd is None:
                    continue
                limit = job.levels_limit or job.req.n_levels
                latest = job.arrival_time + fd - 1     # last OK finish tick
                if tick + (limit - job.level) - 1 <= latest:
                    continue                            # on time as-is
                allowed = math.floor(latest - tick) + 1  # levels from now
                new_total = max(int(job.req.min_levels),
                                job.level + max(0, allowed))
                if new_total < limit:
                    plan.append((job.rid, view.index, new_total))
        return plan

    # ------------------------------------------------------------- admission
    def admit(self, free_slots: int, chains_per_slot: int, tick: int,
              active: Sequence[ActiveJob] = (),
              preemption_budget: Optional[int] = None) -> AdmissionPlan:
        """Plan this tick's admissions into ``free_slots`` slots.

        ``active`` is the engine's in-residence job list — the eviction
        candidates for the preempt policy.  Returns an
        :class:`AdmissionPlan`; planned entries are removed from the queue
        (the engine re-queues evicted jobs via :meth:`requeue`).  The plan
        never over-commits: granted slots <= free + evicted slots.

        The single-pool view of :meth:`admit_sharded` — one shard holding
        the whole pool; exactly the pre-sharding admission semantics.
        """
        view = ShardView(
            index=0, free_slots=free_slots, active=tuple(active),
            shapes=frozenset((j.req.family, j.req.dim, j.req.N)
                             for j in active))
        plan = self.admit_sharded([view], chains_per_slot, tick,
                                  preemption_budget=preemption_budget)
        return AdmissionPlan(
            admitted=[(e, granted) for e, granted, _ in plan.admitted],
            evict=[rid for rid, _ in plan.evict],
            rejected=plan.rejected)

    def admit_sharded(self, shards: Sequence[ShardView],
                      chains_per_slot: int, tick: int,
                      preemption_budget: Optional[int] = None
                      ) -> ShardedAdmissionPlan:
        """Plan one tick's admissions across every shard of the pool.

        One queue walk in effective-priority order; **each entry is tried
        at full width on every shard** (least-loaded first, locality
        tie-break) before its overload fallback may fire — a request is
        degraded, or a tenant evicted for it, only when *no* shard can
        seat it whole.  Lower-priority entries therefore can never
        pre-empt slots a higher-priority entry's fallback would have
        used: the walk order is the priority order, exactly as in the
        single-pool scheduler.  The preemption budget bounds evictions
        per *tick* across all shards.
        """
        plan = ShardedAdmissionPlan()
        budget = self.cfg.preemption_budget if preemption_budget is None \
            else preemption_budget
        # Per-shard live state.  Slots freed by evictions are tracked
        # separately from genuinely-free slots: surplus eviction capacity
        # may only seat entries whose effective priority is >= that of
        # every job evicted from that shard this tick (``evict_floor``) —
        # otherwise evicting a mid-priority job for an urgent one could
        # hand its leftover slots to a *lower*-priority queued request in
        # the same pass, a priority inversion against the victim.
        free = {s.index: s.free_slots for s in shards}
        evicted_free = {s.index: 0 for s in shards}
        evict_floor = {s.index: float("-inf") for s in shards}
        shapes = {s.index: set(s.shapes) for s in shards}
        # Eviction candidates per shard, cheapest first: lowest effective
        # priority, ties broken by most-recent admission (LIFO — the job
        # that has annealed least loses least progress).
        candidates = {
            s.index: sorted(s.active, key=lambda j: (self.effective_priority(
                j.req, j.submit_tick, tick), -j.start_tick, j.rid))
            for s in shards}
        blocked_head = False
        for entry in self._ordered(tick):
            if self._expired(entry, tick):
                plan.rejected.append(entry)
                continue
            req = entry.req
            need = entry.swapped.n_slots if entry.swapped is not None \
                else req.slots_needed(chains_per_slot)
            if blocked_head:
                continue
            eff = self.effective_priority(req, entry.submit_tick, tick)
            shape = (req.family, req.dim, req.N)

            def usable(si):
                outranks = eff >= evict_floor[si]
                return free[si] + (evicted_free[si] if outranks else 0)

            order = sorted(free, key=lambda si: self._shard_key(
                usable(si), shape in shapes[si], si))
            placed = False
            for si in order:                 # full width, on any shard
                if need <= usable(si):
                    plan.admitted.append((entry, need, si))
                    free[si], evicted_free[si] = self._consume(
                        need, free[si], evicted_free[si])
                    shapes[si].add(shape)
                    placed = True
                    break
            policy = self.overload_policy(req) if not placed else "none"
            if policy == "preempt" and budget > 0:
                for si in order:             # fewest evictions first
                    if not candidates[si]:
                        continue
                    outranks = eff >= evict_floor[si]
                    avail = usable(si)
                    victims, gain, vmax = self._select_victims(
                        eff, need, avail, budget, candidates[si], tick)
                    if victims is None:
                        continue
                    for job in victims:
                        plan.evict.append((job.rid, si))
                        candidates[si].remove(job)
                    budget -= len(victims)
                    plan.admitted.append((entry, need, si))
                    # The entry drained `avail` and the evictions' gain
                    # down to `surplus` slots, which stay in the
                    # eviction-reserved pool (floored at the priciest
                    # victim so far — conservative across rounds).
                    surplus = avail + gain - need
                    if outranks:
                        free[si], evicted_free[si] = 0, surplus
                    else:
                        free[si], evicted_free[si] = \
                            0, evicted_free[si] + surplus
                    evict_floor[si] = max(evict_floor[si], vmax)
                    shapes[si].add(shape)
                    placed = True
                    break
            if not placed and policy == "degrade" and entry.swapped is None:
                floor_slots = req.slots_floor(chains_per_slot)
                si = order[0]                # most usable: widest grant
                grant = usable(si)
                if floor_slots <= grant:     # all that fits, down to floor
                    plan.admitted.append((entry, grant, si))
                    free[si], evicted_free[si] = self._consume(
                        grant, free[si], evicted_free[si])
                    shapes[si].add(shape)
                    placed = True
            if not placed and tick - entry.submit_tick > self.cfg.hol_patience:
                # Head-of-line starved past patience: stop backfilling so
                # freed slots can accumulate for it.
                blocked_head = True
        taken = {id(e) for e, _, _ in plan.admitted}
        taken.update(id(e) for e in plan.rejected)
        self._queue = [e for e in self._queue if id(e) not in taken]
        self.telemetry.plan("admit", len(plan.admitted))
        return plan

    @staticmethod
    def _consume(need: int, free: int, evicted_free: int):
        """Drain the plain free pool first, then eviction-freed slots."""
        from_free = min(free, need)
        return free - from_free, evicted_free - (need - from_free)

    def _select_victims(self, mine: float, need: int, usable: int,
                        budget: int, candidates: List[ActiveJob],
                        tick: int):
        """Pick strictly-lower-effective-priority victims until ``need``
        slots are reachable, if the preemption budget allows;
        all-or-nothing.  Returns (victims | None, slot gain, max victim
        effective priority)."""
        victims: List[ActiveJob] = []
        gain = 0
        floor = float("-inf")
        for job in candidates:
            if usable + gain >= need or len(victims) >= budget:
                break
            eff = self.effective_priority(job.req, job.submit_tick, tick)
            if eff >= mine:
                break               # sorted ascending: no cheaper victims left
            victims.append(job)
            gain += len(job.slots)
            floor = max(floor, eff)
        if usable + gain < need:
            return None, 0, floor   # insufficient: evict nothing
        return victims, gain, floor
