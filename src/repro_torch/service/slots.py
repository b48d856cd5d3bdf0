"""Slot pool: the annealing analogue of a decode batch's KV-cache slots,
the counterpart of ``repro.service.slots``.

The engine owns a fixed pool of ``n_slots`` chain-block *slots*.  One slot
holds one block of ``chains_per_slot`` chains — exactly one kernel
block — belonging to at most one request at a time.  A request spanning
multiple slots keeps one slot per contiguous chunk of its chain budget;
``chain_base`` records the chunk's global chain offset *within the request*
so RNG streams are invariant to which physical slots the scheduler picked
(launch/serve.py's SlotCache, with (x, T-ladder position, best) instead of
KV rows).

Slot state is *logically* host-side numpy; device arrays are packed per
dispatch group by the engine each tick.  Under macro-tick fusion the
engine leaves chain state device-resident between launches: a slot may
hold a :class:`DeviceBlockRef` — a lazy view into the group's packed
device output — instead of a numpy block.  ``get_block`` materializes the
ref to host on demand (checkpoint, migration, shrink, repack), so every
consumer of the pool keeps its host-numpy contract while the steady-state
dispatch path skips the host round-trip entirely.

The pool is **dtype-polymorphic**: a slot's block carries whatever dtype
the owning request's family sampled (float32 coordinates for continuous
requests, int32 permutations for QAP), and every lifecycle operation —
assign, checkpoint, restore, shrink repack, device-ref materialization —
is a copy or a view that preserves dtype and bits exactly.  Mixed-family
residency in one pool is therefore free; the engine's per-group packing
(which allocates the packed device array) is the only place a dtype is
ever chosen.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.service.request import SARequest


class DeviceBlockRef:
    """Lazy slot content: rows ``[start, stop)`` of a packed state tensor
    on the engine shard's device.

    Created by the engine's fused launch path (the buffer that holds the
    group's state after the macro-tick), materialized to host numpy on
    first ``get_block``.  Identity of ``buf`` is what the engine's dispatch
    cache keys on: if every slot of a group still references the same
    buffer at the same rows, the packed state on device is current and the
    host repack + transfer can be skipped.
    """

    __slots__ = ("buf", "start", "stop")

    def __init__(self, buf, start: int, stop: int):
        self.buf = buf
        self.start = start
        self.stop = stop

    def materialize(self) -> np.ndarray:
        # A copy: the engine writes the next macro-tick into this buffer.
        return self.buf[self.start:self.stop].to("cpu", copy=True).numpy()


@dataclasses.dataclass
class ActiveJob:
    """Runtime state of an admitted request (one per tenant in residence).

    Every field is host-side and serializable, so a job can be checkpointed
    into a :class:`SwappedJob` (preemption) and resumed later bit-exactly:
    the RNG is counter-based on ``(seed, chain_base + c, steps_done)``, so
    slot state + the two cursors (``steps_done``, ``level``/``T``) are the
    *complete* trajectory state.  Mutable per-job fields must use
    ``default_factory`` — instances are long-lived and must never alias.
    """

    req: SARequest
    rid: int                    # segment id in [0, n_slots): tenant mask key
    slots: List[int]            # pool slots held, in chain-offset order
    level: int = 0              # temperature levels completed
    T: float = 0.0              # current temperature
    steps_done: int = 0         # Metropolis steps completed (RNG step cursor)
    evals: int = 0              # objective evaluations spent
    best_x: Optional[np.ndarray] = None
    best_f: float = float("inf")
    submit_tick: int = 0
    start_tick: int = 0
    granted_chains: int = 0     # chains actually granted (may be < requested
                                # under the 'degrade' overload policy)
    # Lifecycle timestamps (see docs/serving.md): arrival on the tick axis
    # (fractional under open-loop Poisson load), the rest wall-clock seconds
    # since the engine epoch.  first_tick is the tick of the job's first
    # sweep (-1 until it runs).
    arrival_time: float = 0.0
    first_tick: int = -1
    submit_wall: float = float("nan")
    admit_wall: float = float("nan")
    first_tick_wall: float = float("nan")
    # Preemption lifecycle: ticks at which the job was swapped out / back
    # in, and the per-level champion trajectory (best_f after each completed
    # temperature level — the bit-exactness witness for resume).
    preempted_ticks: List[int] = dataclasses.field(default_factory=list)
    resumed_ticks: List[int] = dataclasses.field(default_factory=list)
    history: List[float] = dataclasses.field(default_factory=list)
    # Sharded-pool lifecycle: the engine shard currently hosting the job
    # and the ticks at which it migrated between shards (Russkov-style
    # rebalancing: checkpoint on the old shard, restore on the new one —
    # bit-exact, because restore is placement-invariant).
    home_shard: int = 0
    migrated_ticks: List[int] = dataclasses.field(default_factory=list)
    # Proactive-degrade lifecycle: ticks at which the running job was
    # shrunk (checkpoint -> restore at fewer slots), and the shrink
    # schedule on the *level* axis — ``(level, from_chains, to_chains)``
    # per shrink — which is what a standalone replay needs to reproduce
    # the trajectory bit-exactly (the surviving chains keep their logical
    # indices [0, to_chains), so only the width schedule matters).
    shrunk_ticks: List[int] = dataclasses.field(default_factory=list)
    shrink_events: List[tuple] = dataclasses.field(default_factory=list)
    # Population-annealing ESS shrinks, same (level, from, to) shape but
    # kept apart from ``shrink_events``: a standalone replay re-derives
    # them from the identical fx stream, so the bit-exactness oracle must
    # not feed them back in as an external shrink schedule.
    pa_shrink_events: List[tuple] = dataclasses.field(default_factory=list)
    # Completion-deadline lifecycle (ladder truncation): the job's
    # *effective* ladder length — starts at ``req.n_levels`` and only ever
    # decreases (never below ``req.min_levels``) when the scheduler
    # shortens the remaining levels to meet ``req.finish_deadline``.  The
    # level-axis twin of the shrink machinery: ``truncate_events`` records
    # ``(level, from_levels, to_levels)`` per cut, which is exactly what a
    # standalone replay needs (truncation moves the ladder's end, never
    # any level's arithmetic, so champions are prefix-exact).  0 means
    # "not yet placed"; the engine sets it to req.n_levels at admission.
    levels_limit: int = 0
    truncated_ticks: List[int] = dataclasses.field(default_factory=list)
    truncate_events: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SwappedJob:
    """Host-side checkpoint of a preempted :class:`ActiveJob`.

    Wraps the job itself (all cursors, champion state and lifecycle stamps
    travel with it — nothing is copied out, so new ActiveJob fields can
    never be forgotten here) plus its chain blocks in chain-offset order.
    ``chain_base`` is *not* stored: it is recomputed as ``j * chains_per
    slot`` on restore, which is exactly the placement-invariant RNG base —
    the resumed job may land on different physical slots and still produce
    a bit-identical trajectory.
    """

    job: ActiveJob
    blocks: List[np.ndarray]    # one (chains_per_slot, dim) block per slot

    @property
    def n_slots(self) -> int:
        return len(self.blocks)


class SlotPool:
    """Fixed pool of chain-block slots with per-slot ownership."""

    def __init__(self, n_slots: int, chains_per_slot: int):
        if n_slots < 1 or chains_per_slot < 1:
            raise ValueError("n_slots and chains_per_slot must be positive")
        self.n_slots = n_slots
        self.chains_per_slot = chains_per_slot
        self.owner = np.full((n_slots,), -1, np.int32)       # rid or -1
        self.chain_base = np.zeros((n_slots,), np.uint32)    # request chain offset
        self._x: List[Optional[np.ndarray]] = [None] * n_slots

    # ------------------------------------------------------------- queries
    @property
    def n_free(self) -> int:
        return int(np.sum(self.owner < 0))

    @property
    def n_active(self) -> int:
        return self.n_slots - self.n_free

    def free_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.owner < 0)]

    def slots_of(self, rid: int) -> List[int]:
        return [int(s) for s in np.flatnonzero(self.owner == rid)]

    def get_block(self, slot: int) -> np.ndarray:
        x = self._x[slot]
        assert x is not None, f"slot {slot} is empty"
        if isinstance(x, DeviceBlockRef):
            # Materialize the device-resident block to host and cache it:
            # checkpoint/migrate/shrink and cache-miss repacks all come
            # through here, and repeated reads must not re-transfer.
            x = x.materialize()
            self._x[slot] = x
        return x

    def set_block(self, slot: int, x: np.ndarray) -> None:
        self._x[slot] = x

    def set_device_block(self, slot: int, buf, start: int, stop: int) -> None:
        """Point ``slot`` at rows [start, stop) of a packed device array
        (the fused launch's output) instead of a host copy."""
        self._x[slot] = DeviceBlockRef(buf, start, stop)

    def device_ref(self, slot: int) -> Optional[DeviceBlockRef]:
        """The slot's un-materialized device ref, or None if host-resident."""
        x = self._x[slot]
        return x if isinstance(x, DeviceBlockRef) else None

    # ---------------------------------------------------------- lifecycle
    def assign(self, rid: int, req: SARequest,
               n_slots: Optional[int] = None) -> List[int]:
        """Pack ``req`` into free slots; returns the slot list (chain order).

        Splits the request's initial states into ``chains_per_slot`` blocks:
        slot j of the request holds chains [j*cps, (j+1)*cps) and carries
        ``chain_base = j*cps`` — the placement-invariant RNG index base.
        ``n_slots`` overrides the full-width footprint (the 'degrade'
        overload policy admits with fewer slots, down to the request's
        ``min_chains`` floor); the trajectory is then bit-exact with a
        standalone run of the same request at the granted chain count.
        """
        need = req.slots_needed(self.chains_per_slot) \
            if n_slots is None else n_slots
        cps = self.chains_per_slot
        x0 = req.sample_x0(need * cps)  # budget rounded up to whole slots
        return self._place(rid, req,
                           [x0[j * cps:(j + 1) * cps] for j in range(need)])

    def restore(self, rid: int, blocks: List[np.ndarray]) -> List[int]:
        """Swap a checkpointed job's blocks back in (see :class:`SwappedJob`).

        The physical slots may differ from the ones held before preemption;
        ``chain_base`` is re-derived from block order, which is all the RNG
        keys off — resume is placement-invariant like first admission.
        """
        return self._place(rid, None, [b.copy() for b in blocks])

    def _place(self, rid: int, req: Optional[SARequest],
               blocks: List[np.ndarray]) -> List[int]:
        need = len(blocks)
        free = self.free_slots()
        if need > len(free):
            who = f"request {req.req_id}" if req is not None else f"rid {rid}"
            raise RuntimeError(f"{who} needs {need} slots, {len(free)} free")
        chosen = free[:need]
        for j, s in enumerate(chosen):
            self.owner[s] = rid
            self.chain_base[s] = np.uint32(j * self.chains_per_slot)
            self._x[s] = blocks[j]
        return chosen

    def checkpoint(self, rid: int) -> List[np.ndarray]:
        """Copy ``rid``'s chain blocks out, in chain-offset order.

        Host-side snapshot for preemption: block j holds chains
        [j*cps, (j+1)*cps) of the request regardless of which physical
        slots it occupied.
        """
        slots = sorted(self.slots_of(rid), key=lambda s: self.chain_base[s])
        return [self.get_block(s).copy() for s in slots]

    def release(self, rid: int) -> None:
        for s in self.slots_of(rid):
            self.owner[s] = -1
            self.chain_base[s] = 0
            self._x[s] = None


class RidTable:
    """Recyclable request-id (segment-id) allocator, bounded by pool size."""

    def __init__(self, capacity: int):
        self._free = list(range(capacity - 1, -1, -1))
        self.jobs: Dict[int, ActiveJob] = {}

    def alloc(self, job: ActiveJob) -> int:
        rid = self._free.pop()
        job.rid = rid
        self.jobs[rid] = job
        return rid

    def free(self, rid: int) -> None:
        del self.jobs[rid]
        self._free.append(rid)
