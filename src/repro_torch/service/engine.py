"""Continuous-batching SA serving engine, the counterpart of
``repro.service.engine`` on one card.

* A pool of chain-block *slots* (slots.py) on one engine shard
  (sharding.py); an admission scheduler (scheduler.py) packs queued
  requests into free slots.
* One engine **tick** advances every active slot by ``macro_k``
  temperature levels.  A level is one N-step sweep of every slot at its
  own temperature (kernel B1 for the continuous family, B3 for QAP), then
  a champion exchange masked per request (core/exchange.py).
* A request whose ladder, budget or accuracy target completes frees its
  slots at once, and the next queued request takes them.

Invariants kept from the reference:

* The tick clock counts ladder levels at any K; admission lands only on
  macro-tick boundaries (the top of ``tick()``).
* Active slots are grouped by ``(family, dim, N)`` and each group is one
  launch per level; objective ids and QAP instances are per-block kernel
  inputs.  Groups are padded to a power of two of blocks: pad blocks
  replicate block 0, claim segment ``n_slots`` and never adopt.
* Counter-based RNG on logical chain coordinates plus the segmented
  exchange make a packed request's trajectory bit-identical to its
  standalone run (:func:`run_standalone`).

On the card (``EngineConfig.device``, default ``cuda``):

* ``macro_k == 1``: each level uploads the group's state and controls,
  launches, and brings the state and the champions back to the host, as
  the reference does.
* ``macro_k > 1``: a host loop of K levels of launches with no host
  synchronisation between levels.  The group's state stays on the card in
  two buffers that alternate, level by level, as the sweep's input and
  output (the counterpart of ``donate_argnums``); a group whose membership
  is unchanged since its last macro-tick is neither repacked nor
  uploaded.  Each level's champions stack on the card, and each group
  makes one device-to-host copy per macro-tick.
* Every upload of a group's controls is one pinned, non-blocking copy.

The elastic half, as the reference's:

* ``EngineConfig.n_devices`` shards each own ``n_slots`` slots
  (sharding.py); on one card they all live on it.  The scheduler homes
  each request on the least-loaded shard and moves jobs between shards by
  checkpoint and restore through host numpy (migration, watermark
  rebalancing, drain evacuation).
* Preemption checkpoints a job to a host
  :class:`~repro_torch.service.slots.SwappedJob` and resumes it later,
  possibly on other slots of another shard; proactive and admission-time
  degrade run a job at fewer slots; ladder truncation meets a request's
  ``finish_deadline``.  Every such trajectory is bit-exact against
  :func:`run_standalone` with the same width and ladder schedules,
  because the RNG keys on logical (chain, step) coordinates.
* A checkpoint at a boundary reads the buffer that holds the state after
  the last macro-tick (``SlotPool.get_block``), before the next launch
  writes into it; a restored slot holds host arrays, so its group misses
  the buffer cache and is repacked.
* :meth:`SAServeEngine.run_stream` admits from an arrival process while
  ticking, and scripted operations (:meth:`SAServeEngine.schedule_op`)
  land on their tick; no decision reads the wall clock.

The replica-exchange workload classes, as the reference's:

* A parallel-tempering (``pt``) request's chains each hold one rung of its
  temperature ladder (``SARequest.pt_rungs``, computed once on the host):
  kernel B1 sweeps them at their rung (``t_chain``), and after the
  exchange an even/odd swap pass alternates parity with the job's level.
  Partners are packed rows, so the device pass is a gather.  A PT job's
  width is its ladder's resolution: it is never shrunk mid-flight.
* A population-annealing (``pa``) request's chains are resampled from
  their own request's rows at each level transition; with
  ``pa_ess_ratio > 0`` the job halves its own width when the effective
  sample size of the next reweighting falls below that share, from its
  post-exchange f read back at the boundary.  A standalone run re-derives
  those shrinks (``RequestResult.pa_shrink_events``).

Observability and control, as the reference's:

* ``SAServeEngine(cfg, telemetry=Telemetry(...))`` turns on the metrics
  registry, the per-phase tick spans (wall and thread CPU seconds), the
  decision event log and the Perfetto trace (telemetry.py, trace.py).  The
  default ``NULL`` bundle makes every hook a no-op.  On the card, each
  group's launch is followed by a CUDA event, and the ``device_wait``
  span of its shard waits on it, in launch order: every shard launches on
  the card's one current stream, so a device-wide synchronise would charge
  every shard's device time to the first.  With telemetry off no event is
  recorded and nothing is synchronised.
* :meth:`SAServeEngine.attach_controller` attaches the closed-loop
  autoscaler (autoscaler.py), sampled at the top of each tick; the idle
  jump of ``run_stream`` never passes its next sampling tick.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import exchange as exch
from repro_torch.kernels import objective_math as om
from repro_torch.kernels import ops
from repro_torch.kernels import rng
from repro_torch.objectives import families as fam_mod
from repro_torch.service.arrivals import ArrivalProcess
from repro_torch.service.request import RequestResult, SARequest
from repro_torch.service.scheduler import (AdmissionScheduler, QueueEntry,
                                           SchedulerConfig, ShardView)
from repro_torch.service.sharding import EngineShard, make_shard, make_shards
from repro_torch.service.slots import ActiveJob, SwappedJob
from repro_torch.service.telemetry import NULL as NULL_TELEMETRY

#: Known optima of the servable continuous objectives, keyed by kernel id,
#: derived from the family layer's name-keyed table.  QAP requests read
#: their instance's ``best_known`` instead.
F_OPT = {om.KID_BY_NAME[name]: v
         for name, v in fam_mod.F_OPT_BY_NAME.items()}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8            # slots per shard
    chains_per_slot: int = 64   # chains per slot == kernel block size
    n_devices: int = 1          # engine shards; logical shards share the
                                # cards round-robin (sharding.py)
    variant: str = "delta"      # continuous sweep: 'delta' | 'full'
    device: object = None       # None = the card; "cpu" runs the plain
                                # versions of the kernels
    migration_budget: int = 1   # max cross-shard moves per tick (0 = no
                                # automatic rebalancing)
    macro_k: int = 1            # ladder levels per tick; trajectories are
                                # bit-exact at any K
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {self.n_devices}")
        if self.migration_budget < 0:
            raise ValueError("migration_budget must be >= 0")
        if self.macro_k < 1:
            raise ValueError(f"macro_k must be >= 1, got {self.macro_k}")


# ------------------------------------------------------------ device side
@dataclasses.dataclass
class _GroupControls:
    """One dispatch group's controls on its device.  Per-block arrays are
    ``(n_blocks,)``; per-level ones ``(k, n_blocks)``; per-chain ones
    ``(n_blocks * blk,)``.  uint32 values travel as int32 bit patterns."""

    T: torch.Tensor             # (k, n_blocks) float32 ladder temperatures
    step0: torch.Tensor         # (k, n_blocks) RNG step cursor of each level
    lvl: torch.Tensor           # (k, n_blocks) absolute ladder level
    live: Optional[torch.Tensor]  # (k, n_blocks) int32 level cursor, or None
    seed: torch.Tensor          # (n_blocks,)
    base: torch.Tensor          # (n_blocks,) global chain-index base
    seg: torch.Tensor           # (chains,) segment (request) id
    adopt: torch.Tensor         # (chains,) bool: sync adoption
    # Each class's masks and operands are None when the group has no
    # chain of that class, so its stage is skipped (and a group of plain
    # chains uploads no class codes at all).
    is_sos: Optional[torch.Tensor]    # (chains,) bool
    is_pt: Optional[torch.Tensor]     # (chains,) bool
    t_rung: Optional[torch.Tensor]    # (chains,) float32 PT rung
    partner: Optional[torch.Tensor]   # (2, chains) int32 packed partner
                                      # row, row j at parity level + j
    pairlo: Optional[torch.Tensor]    # (2, chains) lower logical rung
    is_pa: Optional[torch.Tensor]     # (chains,) bool
    seg_lo: Optional[torch.Tensor]    # (chains,) int32 PA request rows
    seg_hi: Optional[torch.Tensor]    #   [seg_lo, seg_hi)
    dbeta: Optional[torch.Tensor]     # (k, n_blocks) float32 PA increment

    @property
    def replicas(self) -> bool:
        return self.is_pt is not None or self.is_pa is not None


def _chain_controls(T_blk, seed_blk, base_blk, lvl0, blk: int):
    """Expand per-block controls to the per-chain arrays the SOS, PT and
    PA stages of the exchange consume: the schedule temperature, the
    request seed, the logical chain index and the absolute ladder level."""
    lane = torch.arange(blk, device=T_blk.device).repeat(T_blk.shape[0])
    sched = T_blk.repeat_interleave(blk)
    seed_c = seed_blk.repeat_interleave(blk)
    cidx = (rng.as_u32(base_blk).repeat_interleave(blk) + lane) & rng.MASK32
    lvl_abs = rng.as_u32(lvl0).repeat_interleave(blk)
    return sched, seed_c, cidx, lvl_abs


def _t_chain(ctl: _GroupControls, i: int, blk: int):
    """Level ``i``'s per-chain sweep temperature when the group holds PT
    chains (each at its rung, the rest at their block's ladder value),
    else None: B1 then reads the per-block temperature."""
    if ctl.is_pt is None:
        return None
    return torch.where(ctl.is_pt, ctl.t_rung, ctl.T[i].repeat_interleave(blk))


def _exchange(x, fx, ctl: _GroupControls, i: int, live_c, blk: int,
              num_segments: int, out=None):
    per_chain = (None,) * 4
    if ctl.is_sos is not None or ctl.replicas:
        per_chain = _chain_controls(ctl.T[i], ctl.seed, ctl.base, ctl.lvl[i],
                                    blk)
    pt = pa = None
    if ctl.is_pt is not None:
        pt = (ctl.t_rung, ctl.partner[i % 2], ctl.pairlo[i % 2],
              ctl.is_pt & live_c)
    if ctl.is_pa is not None:
        pa = (ctl.seg_lo, ctl.seg_hi, ctl.dbeta[i].repeat_interleave(blk),
              ctl.is_pa & live_c)
    return exch._serving_exchange(x, fx, ctl.seg, num_segments, ctl.adopt,
                                  ctl.is_sos, *per_chain, live_c, pt=pt,
                                  pa=pa, out=out)


def _group_tick(x, sweep, ctl: _GroupControls, *, blk: int,
                num_segments: int):
    """One temperature level for one dispatch group: ``sweep`` (kernel B1
    or B3 over every block at its own temperature and step cursor, PT
    chains at their rungs), then the segmented exchange.  Returns (x, fx,
    xb, fb): the post-exchange states and values and the champions of
    every segment."""
    x, fx = sweep(x, ctl.T[0], ctl.step0[0], None, None, _t_chain(ctl, 0, blk))
    live = torch.ones(fx.shape, dtype=torch.bool, device=fx.device)
    return _exchange(x, fx, ctl, 0, live, blk, num_segments)


def _group_tick_fused(x, spare, sweep, ctl: _GroupControls, *, k: int,
                      blk: int, num_segments: int, keep_fx: bool = False):
    """K temperature levels for one dispatch group, with no host
    synchronisation: exactly the :func:`_group_tick` body K times, so each
    level computes what K separate ticks would.

    ``x`` holds the group's state and ``spare`` is a second buffer of its
    shape: each level sweeps ``x`` into ``spare`` and the exchange writes
    its adoption back into ``x``, so the state ends in ``x`` with no copy
    and no allocation of its size.  A block whose request has fewer than
    K planned levels goes dead (``ctl.live``): the kernel passes its state
    through and the exchange leaves its chains alone.  Returns (champ,
    fx_keep): the champions ``(k, num_segments, dim + 1)`` float32 on the
    card (each level's champion states, bit-cast to float32, and their
    values in the last column) and, with ``keep_fx``, each chain's
    post-exchange value at its last live level (the PA width controller
    reads it), else None."""
    dim = x.shape[1]
    champ = torch.empty((k, num_segments, dim + 1), dtype=torch.float32,
                        device=x.device)
    fx_keep = None
    for i in range(k):
        swept, fx = sweep(x, ctl.T[i], ctl.step0[i], ctl.live[i], spare,
                          _t_chain(ctl, i, blk))
        live_c = ctl.live[i].repeat_interleave(blk) != 0
        _, fx, xb, fb = _exchange(swept, fx, ctl, i, live_c, blk,
                                  num_segments, out=x)
        champ[i, :, :dim] = xb.view(torch.float32)
        champ[i, :, dim] = fb
        if keep_fx:
            fx_keep = fx if fx_keep is None else torch.where(live_c, fx,
                                                             fx_keep)
    return champ, fx_keep


def _upload(arrays: Dict[str, np.ndarray], device: torch.device):
    """Host arrays of 4-byte types -> tensors on ``device`` in one copy
    (pinned and non-blocking on the card).  Returns name -> tensor."""
    flat = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.int32)
                           for a in arrays.values()])
    t = torch.from_numpy(flat)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    out, off = {}, 0
    for name, a in arrays.items():
        v = t[off:off + a.size]
        if a.dtype == np.float32:
            v = v.view(torch.float32)
        out[name] = v.reshape(a.shape)
        off += a.size
    return out


class SAServeEngine:
    """Multi-tenant annealing server: one launch per level per group."""

    def __init__(self, cfg: Optional[EngineConfig] = None, telemetry=None):
        cfg = EngineConfig() if cfg is None else cfg
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.shards: List[EngineShard] = make_shards(
            cfg.n_devices, cfg.n_slots, cfg.chains_per_slot, self.device)
        self.scheduler = AdmissionScheduler(cfg.scheduler)
        # Observability is opt-in and host-side only: the NULL bundle
        # no-ops every hook, and an enabled one changes no state on the
        # card and no decision, so trajectories stay bit-exact.
        self.telemetry = NULL_TELEMETRY if telemetry is None else telemetry
        self.scheduler.telemetry = self.telemetry
        self.results: List[RequestResult] = []
        self.tick_count = 0
        self.n_submitted = 0          # requests offered via submit()
        self.sweeps_done = 0          # block-sweeps (slot x level)
        self.group_launches = 0
        self.preemptions = 0          # swap-outs performed
        self.rejections = 0           # SLO admission-control drops
        self.migrations = 0           # cross-shard moves
        self.shrinks = 0              # width reductions of running jobs
        self.truncations = 0          # finish-deadline ladder truncations
        self.slot_ticks = 0           # occupancy denominator: the sum over
                                      # ticks of the fleet's slot count
        self.retired_shards: List[Tuple[int, int]] = []  # (index, tick)
        self._next_shard_index = cfg.n_devices   # shard ids are never reused
        self._ops: List[Tuple[int, int, object]] = []  # (tick, seq, fn)
        self._op_seq = 0
        # The closed-loop controller (autoscaler.py), sampled at the top of
        # each tick; None = no control plane.
        self.controller = None
        self._epoch = time.perf_counter()
        self._pt = self.telemetry.make_phase_timer(self._now)
        if self.telemetry.trace is not None:
            self.telemetry.trace.bind_clock(self._now)
        #: req_id -> (arrival_time in ticks, submit wall time)
        self._submit_info: Dict[int, Tuple[float, float]] = {}

    def _now(self) -> float:
        """Monotonic wall seconds since engine construction: every wall
        stamp and ``wall_s`` share this epoch."""
        return time.perf_counter() - self._epoch

    # ------------------------------------------------------------ frontend
    def submit(self, req: SARequest, arrival_time: Optional[float] = None
               ) -> None:
        """Enqueue ``req``.  ``arrival_time`` (in ticks, may be fractional)
        is the offered-load timestamp of open-loop runs; it defaults to the
        submit tick."""
        need = req.slots_needed(self.cfg.chains_per_slot)
        if need > self.cfg.n_slots:
            raise ValueError(
                f"request {req.req_id} needs {need} slots > the per-shard "
                f"pool of {self.cfg.n_slots}; requests never span shards — "
                "lower n_chains or grow n_slots")
        if (req.target_error is not None
                and req.family == fam_mod.FAMILY_CONTINUOUS
                and req.kid not in F_OPT):
            raise ValueError(
                f"request {req.req_id} sets target_error but objective "
                f"{req.objective!r} has no registered optimum in "
                "engine.F_OPT; register one or drop target_error")
        if (req.req_id in self._submit_info
                or any(job.req.req_id == req.req_id
                       for _, job in self._iter_jobs())
                or any(r.req_id == req.req_id
                       for r in self.scheduler.pending)):
            raise ValueError(
                f"request id {req.req_id} is already queued, swapped out or "
                "in flight; req_ids must be unique among live requests")
        self._submit_info[req.req_id] = (
            float(self.tick_count if arrival_time is None else arrival_time),
            self._now())
        self.scheduler.submit(req, self.tick_count)
        self.n_submitted += 1
        if self.telemetry.trace is not None:
            self.telemetry.trace.request_begin(
                req.req_id, objective=req.objective, dim=req.dim,
                n_chains=req.n_chains, tick=self.tick_count)

    # ----------------------------------------------------------- shard views
    def _iter_jobs(self) -> Iterator[Tuple[EngineShard, ActiveJob]]:
        for shard in self.shards:
            for job in shard.rids.jobs.values():
                yield shard, job

    def _view(self, shard: EngineShard) -> ShardView:
        jobs = tuple(shard.rids.jobs.values())
        return ShardView(
            index=shard.index, free_slots=shard.pool.n_free, active=jobs,
            shapes=frozenset((j.req.family, j.req.dim, j.req.N)
                             for j in jobs))

    def _shard(self, index: int) -> EngineShard:
        """Shard by stable index: a retired shard leaves a gap and added
        shards get fresh ids."""
        for shard in self.shards:
            if shard.index == index:
                return shard
        raise ValueError(f"no live shard with index {index}")

    @property
    def live_shards(self) -> List[EngineShard]:
        """Shards accepting new placements (not draining)."""
        return [s for s in self.shards if not s.draining]

    @property
    def n_active(self) -> int:
        return sum(len(s.rids.jobs) for s in self.shards)

    @property
    def done(self) -> bool:
        return self.n_active == 0 and len(self.scheduler) == 0

    # ----------------------------------------------------------- admission
    def _admit(self) -> None:
        """Plan this boundary's moves and admissions, then execute them, in
        the reference's order: drain evacuation (first claim on the move
        budget), head defrag by migration, proactive shrinks (only when no
        migration fired), watermark rebalancing (only when neither did),
        then one queue walk across the live shards: rejections, evictions,
        placements."""
        cps = self.cfg.chains_per_slot
        budget = self.cfg.migration_budget
        pt = self._pt
        if any(s.draining for s in self.shards):
            budget -= self._evacuate_draining(budget)
            self._retire_drained()
        with pt("schedule"):
            views = {s.index: self._view(s) for s in self.live_shards}
            moves = self.scheduler.plan_migrations(
                list(views.values()), cps, self.tick_count, budget)
        with pt("admit"):
            for rid, src, dst in moves:
                self._migrate_job(self._shard(src), rid, self._shard(dst))
        budget -= len(moves)
        for si in {si for move in moves for si in move[1:]}:
            views[si] = self._view(self._shard(si))
        shrinks = []
        if not moves and self.cfg.scheduler.proactive_degrade:
            with pt("schedule"):
                shrinks = self.scheduler.plan_shrinks(
                    list(views.values()), cps, self.tick_count,
                    self.cfg.scheduler.shrink_budget)
            with pt("admit"):
                for rid, si, keep_slots in shrinks:
                    self._shrink_job(self._shard(si), rid, keep_slots)
                    views[si] = self._view(self._shard(si))
        # The slots a defrag or a shrink freed are the head's: no
        # rebalance move may land on them before admission seats it.
        if not moves and not shrinks:
            with pt("schedule"):
                rmoves = self.scheduler.plan_rebalance(
                    list(views.values()), self.tick_count, budget)
            with pt("admit"):
                for rid, src, dst in rmoves:
                    self._migrate_job(self._shard(src), rid,
                                      self._shard(dst))
            for si in {si for move in rmoves for si in move[1:]}:
                views[si] = self._view(self._shard(si))
        with pt("schedule"):
            plan = self.scheduler.admit_sharded(
                list(views.values()), cps, self.tick_count)
        with pt("admit"):
            for entry in plan.rejected:
                self._reject(entry)
            for rid, si in plan.evict:
                self._swap_out(self._shard(si), rid)
            for entry, granted_slots, si in plan.admitted:
                self._place(self._shard(si), entry, granted_slots)

    def _place(self, shard: EngineShard, entry: QueueEntry,
               granted_slots: int) -> None:
        tel = self.telemetry
        if entry.swapped is not None:       # swap-in: bit-exact resume
            job = entry.swapped.job
            job.resumed_ticks.append(self.tick_count)
            shard.rids.alloc(job)
            job.slots = shard.pool.restore(job.rid, entry.swapped.blocks)
            job.home_shard = shard.index
            if tel.enabled:
                tel.decision(self.tick_count, "resume",
                             req_id=job.req.req_id, shard=shard.index,
                             slots=len(job.slots))
                if tel.trace is not None:
                    tel.trace.request_instant(
                        job.req.req_id, "resume", shard=shard.index,
                        tick=self.tick_count)
            return
        req = entry.req
        arrival, submit_wall = self._submit_info.pop(
            req.req_id, (float(entry.submit_tick), float("nan")))
        job = ActiveJob(req=req, rid=-1, slots=[], T=req.T0,
                        submit_tick=entry.submit_tick,
                        start_tick=self.tick_count,
                        arrival_time=arrival,
                        submit_wall=submit_wall,
                        admit_wall=self._now(),
                        home_shard=shard.index,
                        levels_limit=req.n_levels)
        shard.rids.alloc(job)
        job.slots = shard.pool.assign(job.rid, req, n_slots=granted_slots)
        job.granted_chains = granted_slots * self.cfg.chains_per_slot
        if tel.enabled:
            tel.decision(self.tick_count, "admit", req_id=req.req_id,
                         shard=shard.index, granted_slots=granted_slots,
                         requested_chains=req.n_chains,
                         granted_chains=job.granted_chains)
            if tel.trace is not None:
                tel.trace.request_instant(
                    req.req_id, "admit", shard=shard.index,
                    granted_chains=job.granted_chains,
                    tick=self.tick_count)

    @staticmethod
    def _checkpoint_release(shard: EngineShard, rid: int, keep_slots=None):
        """Checkpoint ``rid``'s first ``keep_slots`` blocks (all when None)
        to the host and free its slots on ``shard``."""
        blocks = shard.pool.checkpoint(rid)[:keep_slots]
        shard.pool.release(rid)
        return blocks

    def _take(self, shard: EngineShard, rid: int, keep_slots=None):
        """Take ``rid`` off ``shard``: its checkpointed blocks, its slots
        and its rid freed; the job keeps its cursors.  Returns (job,
        blocks)."""
        job = shard.rids.jobs[rid]
        blocks = self._checkpoint_release(shard, rid, keep_slots)
        shard.rids.free(rid)
        return job, blocks

    def _swap_out(self, shard: EngineShard, rid: int) -> None:
        """Preempt: checkpoint a job to the host, free its slots and
        re-queue it for a bit-exact resume on whichever shard next has
        room."""
        job, blocks = self._take(shard, rid)
        job.slots = []
        job.rid = -1
        job.preempted_ticks.append(self.tick_count)
        self.scheduler.requeue(SwappedJob(job=job, blocks=blocks))
        self.preemptions += 1
        tel = self.telemetry
        if tel.enabled:
            tel.decision(self.tick_count, "preempt",
                         req_id=job.req.req_id, shard=shard.index,
                         level=job.level)
            if tel.trace is not None:
                tel.trace.request_instant(
                    job.req.req_id, "preempt", shard=shard.index,
                    level=job.level, tick=self.tick_count)

    def _migrate_job(self, src: EngineShard, rid: int, dst: EngineShard,
                     keep_slots: Optional[int] = None) -> None:
        """Move a resident job between shards in one boundary: checkpoint
        on ``src``, restore on ``dst`` (only the first ``keep_slots``
        blocks when set: the drain's shrink-migrate)."""
        job, blocks = self._take(src, rid, keep_slots)
        from_chains = job.granted_chains
        dst.rids.alloc(job)
        job.slots = dst.pool.restore(job.rid, blocks)
        job.home_shard = dst.index
        job.migrated_ticks.append(self.tick_count)
        self.migrations += 1
        if keep_slots is not None:      # the shrink records the move
            self._record_shrink(job, from_chains)
            return
        tel = self.telemetry
        if tel.enabled:
            tel.decision(self.tick_count, "migrate",
                         req_id=job.req.req_id, src=src.index,
                         dst=dst.index, level=job.level)
            if tel.trace is not None:
                tel.trace.request_instant(
                    job.req.req_id, "migrate", src=src.index,
                    dst=dst.index, tick=self.tick_count)

    def migrate(self, req_id: int, to_shard: int) -> bool:
        """Move the in-flight request ``req_id`` to shard ``to_shard``.
        False if the request is not active, already there, the target
        lacks room or is draining; ValueError for an unknown shard."""
        dst = self._shard(to_shard)
        if dst.draining:
            return False
        for shard, job in self._iter_jobs():
            if job.req.req_id == req_id:
                if shard.index == to_shard \
                        or dst.pool.n_free < len(job.slots):
                    return False
                self._migrate_job(shard, job.rid, dst)
                return True
        return False

    def preempt(self, req_id: int) -> bool:
        """Swap out the in-flight request ``req_id`` (False if not
        active)."""
        for shard, job in list(self._iter_jobs()):
            if job.req.req_id == req_id:
                self._swap_out(shard, job.rid)
                return True
        return False

    # -------------------------------------------------------- elastic fleet
    def _record_shrink(self, job: ActiveJob, from_chains: int,
                       self_driven: bool = False) -> None:
        """Record a width cut.  A PA job's own ESS shrink goes to
        ``pa_shrink_events``: a standalone run re-derives it from the same
        f stream, so it must not be replayed as an external schedule."""
        job.granted_chains = len(job.slots) * self.cfg.chains_per_slot
        job.shrunk_ticks.append(self.tick_count)
        event = (job.level, from_chains, job.granted_chains)
        (job.pa_shrink_events if self_driven else job.shrink_events).append(
            event)
        self.shrinks += 1
        tel = self.telemetry
        if tel.enabled:
            kind = "pa_shrink" if self_driven else "shrink"
            tel.decision(self.tick_count, kind,
                         req_id=job.req.req_id, shard=job.home_shard,
                         level=job.level, from_chains=from_chains,
                         to_chains=job.granted_chains)
            if tel.trace is not None:
                tel.trace.request_instant(
                    job.req.req_id, kind, from_chains=from_chains,
                    to_chains=job.granted_chains, tick=self.tick_count)

    def _shrink_job(self, shard: EngineShard, rid: int, keep_slots: int,
                    self_driven: bool = False) -> None:
        """Degrade in place: checkpoint, drop the tail blocks, restore
        ``keep_slots`` blocks on the same shard.  The surviving chains
        keep logical indices [0, keep_slots * cps), so only the width
        schedule changes, which ``run_standalone`` replays."""
        job = shard.rids.jobs[rid]
        if not 0 < keep_slots < len(job.slots):
            raise ValueError(
                f"keep_slots must be in [1, {len(job.slots) - 1}], "
                f"got {keep_slots}")
        from_chains = job.granted_chains
        blocks = self._checkpoint_release(shard, rid, keep_slots)
        job.slots = shard.pool.restore(rid, blocks)
        self._record_shrink(job, from_chains, self_driven=self_driven)

    def degrade_active(self, req_id: int, n_chains: int) -> bool:
        """Shrink the running request ``req_id`` to ``n_chains`` chains
        (rounded up to whole slots).  False if it is not active, already at
        or below that width, or a parallel-tempering job (its width is its
        temperature ladder's resolution; the scheduler skips PT too)."""
        slots_new = max(1, -(-n_chains // self.cfg.chains_per_slot))
        for shard, job in self._iter_jobs():
            if job.req.req_id == req_id:
                if slots_new >= len(job.slots) or job.req.method == "pt":
                    return False
                self._shrink_job(shard, job.rid, slots_new)
                return True
        return False

    # -------------------------------------------- completion-deadline SLO
    def _truncate_job(self, job: ActiveJob, to_levels: int) -> None:
        """Cut the job's ladder to ``to_levels`` total levels (never below
        ``min_levels`` or the levels already run).  No level's arithmetic
        changes, only where the ladder ends."""
        limit = self._levels_limit(job)
        floor = max(int(job.req.min_levels), min(job.level, limit))
        to_levels = max(int(to_levels), floor)
        if to_levels >= limit:
            return
        job.truncated_ticks.append(self.tick_count)
        job.truncate_events.append((job.level, limit, to_levels))
        job.levels_limit = to_levels
        self.truncations += 1
        tel = self.telemetry
        if tel.enabled:
            tel.decision(self.tick_count, "truncate",
                         req_id=job.req.req_id, shard=job.home_shard,
                         level=job.level, from_levels=limit,
                         to_levels=to_levels)
            if tel.trace is not None:
                tel.trace.request_instant(
                    job.req.req_id, "truncate", from_levels=limit,
                    to_levels=to_levels, tick=self.tick_count)

    def truncate_active(self, req_id: int, n_levels: int) -> bool:
        """Shorten the running request ``req_id``'s ladder to ``n_levels``
        total levels, clamped to its ``min_levels``.  False if it is not
        active or the cut shortens nothing."""
        for _shard, job in self._iter_jobs():
            if job.req.req_id == req_id:
                before = self._levels_limit(job)
                self._truncate_job(job, n_levels)
                return self._levels_limit(job) < before
        return False

    def _plan_truncations(self) -> None:
        """Apply this boundary's finish-deadline truncations."""
        if all(job.req.finish_deadline is None
               for _, job in self._iter_jobs()):
            # The planner would plan nothing: count its empty plan, as the
            # reference's planner does.
            self.telemetry.plan("truncate", 0)
            return
        views = [self._view(s) for s in self.shards]
        with self._pt("schedule"):
            plan = self.scheduler.plan_truncations(views, self.tick_count)
        with self._pt("admit"):
            for rid, si, to_levels in plan:
                self._truncate_job(self._shard(si).rids.jobs[rid],
                                   to_levels)

    def _evacuate_draining(self, budget: int) -> int:
        """Execute this boundary's drain plan; returns the actions taken."""
        with self._pt("schedule"):
            draining = [self._view(s) for s in self.shards if s.draining]
            survivors = [self._view(s) for s in self.live_shards]
            actions = self.scheduler.plan_evacuation(
                draining, survivors, self.cfg.chains_per_slot,
                self.tick_count, budget)
        with self._pt("admit"):
            for kind, rid, src, dst, width in actions:
                if kind == "migrate":
                    self._migrate_job(self._shard(src), rid,
                                      self._shard(dst))
                elif kind == "shrink":
                    self._migrate_job(self._shard(src), rid,
                                      self._shard(dst), keep_slots=width)
                else:
                    self._swap_out(self._shard(src), rid)
        return len(actions)

    def _retire_drained(self) -> None:
        """Remove empty draining shards from the fleet; their state
        buffers on the card go with their group cache."""
        for shard in [s for s in self.shards
                      if s.draining and not s.rids.jobs]:
            shard.group_cache.clear()
            self.shards.remove(shard)
            self.retired_shards.append((shard.index, self.tick_count))
            self.telemetry.decision(self.tick_count, "shard_retired",
                                    shard=shard.index)

    def drain(self, shard_index: int) -> None:
        """Begin draining shard ``shard_index``: no new placements, its
        jobs evacuate at each boundary (``migration_budget`` actions) and
        it retires once empty.  Idempotent; raises if it would leave no
        live shard."""
        shard = self._shard(shard_index)
        if shard.draining:
            return
        if len(self.live_shards) <= 1:
            raise ValueError(
                "cannot drain the last live shard; resize up first")
        shard.draining = True
        self.telemetry.decision(self.tick_count, "drain", shard=shard_index,
                                resident_jobs=len(shard.rids.jobs))
        if not shard.rids.jobs:
            self._retire_drained()

    def add_shards(self, n: int) -> List[int]:
        """Grow the fleet by ``n`` fresh shards; returns their (never
        reused) indices."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        new = []
        for _ in range(n):
            idx = self._next_shard_index
            self._next_shard_index += 1
            self.shards.append(make_shard(
                idx, self.cfg.n_slots, self.cfg.chains_per_slot,
                self.device))
            new.append(idx)
            self.telemetry.decision(self.tick_count, "shard_added",
                                    shard=idx)
        return new

    def resize(self, n_devices: int) -> None:
        """Resize the fleet to ``n_devices`` live shards.  Growing first
        cancels drains in progress, then adds shards; shrinking drains the
        emptiest live shards (ties to the highest index)."""
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        live = self.live_shards
        if n_devices > len(live):
            grow = n_devices - len(live)
            for shard in sorted((s for s in self.shards if s.draining),
                                key=lambda s: s.index):
                if grow == 0:
                    break
                shard.draining = False
                grow -= 1
            self.add_shards(grow)
        elif n_devices < len(live):
            doomed = sorted(live, key=lambda s: (s.pool.n_active, -s.index))
            for shard in doomed[:len(live) - n_devices]:
                self.drain(shard.index)

    def attach_controller(self, controller) -> None:
        """Attach a closed-loop controller (autoscaler.py): an object with
        ``maybe_sample(engine)``, called at the top of every tick before
        admission, and ``next_sample_tick``, which ``run_stream``'s idle
        jump never passes."""
        self.controller = controller

    def schedule_op(self, tick: int, fn) -> None:
        """Run ``fn()`` at the start of the first tick >= ``tick`` (the
        hook of ``serve_sa --drain-at/--resize``)."""
        self._ops.append((int(tick), self._op_seq, fn))
        self._op_seq += 1
        self._ops.sort(key=lambda op: op[:2])

    @property
    def _next_op_tick(self) -> float:
        return self._ops[0][0] if self._ops else float("inf")

    def _run_due_ops(self) -> None:
        while self._ops and self._ops[0][0] <= self.tick_count:
            _, _, fn = self._ops.pop(0)
            fn()

    def _reject(self, entry: QueueEntry) -> None:
        """SLO fast-fail: terminal 'rejected' result, no solution."""
        req = entry.req
        arrival, submit_wall = self._submit_info.pop(
            req.req_id, (float(entry.submit_tick), float("nan")))
        self.results.append(RequestResult(
            req_id=req.req_id, objective=req.objective, dim=req.dim,
            x_best=None, f_best=float("inf"), levels_run=0, n_evals=0,
            submit_tick=entry.submit_tick, start_tick=-1,
            finish_tick=self.tick_count, finish_reason="rejected",
            arrival_time=arrival, submit_wall=submit_wall,
            finish_wall=self._now(), requested_chains=req.n_chains,
            granted_chains=0, home_shard=-1))
        self.rejections += 1
        tel = self.telemetry
        if tel.enabled:
            tel.decision(self.tick_count, "reject", req_id=req.req_id,
                         waited=self.tick_count - entry.submit_tick)
            if tel.trace is not None:
                tel.trace.request_end(req.req_id, reason="rejected",
                                      tick=self.tick_count)

    def _maybe_pa_shrink(self, shard: EngineShard, job: ActiveJob,
                         fx_job: np.ndarray) -> None:
        """Population annealing's own width controller, at a boundary:
        estimate the effective sample size of the job's population under
        the next level transition's reweighting (``job.T`` has advanced,
        so the increment is ``1/(T rho) - 1/T``) and halve the job's slots
        when ``ESS / width`` falls below ``pa_ess_ratio``.  A function of
        the job's own bit-exact f stream in float64 host math, so a
        standalone run re-derives every such shrink at the same level."""
        req = job.req
        if req.method != "pa" or len(job.slots) <= 1:
            return
        db = _pa_dbeta(job.T, req.rho)
        w = np.exp(-db * (fx_job.astype(np.float64) - float(fx_job.min())))
        ess = float(w.sum()) ** 2 / float((w * w).sum())
        if ess / fx_job.shape[0] < req.pa_ess_ratio:
            self._shrink_job(shard, job.rid, max(1, len(job.slots) // 2),
                             self_driven=True)

    def _pa_shrinks(self, shard: EngineShard, jobs: List[ActiveJob],
                    fx: Optional[np.ndarray], finished) -> None:
        """Run the PA width controller of each unfinished job of a group,
        on its rows of the group's post-exchange values ``fx``."""
        if fx is None:
            return
        done = {id(job) for _, job, _, _ in finished}
        row0 = 0
        for job in jobs:
            rows = slice(row0, row0 + job.granted_chains)
            row0 += job.granted_chains
            if id(job) not in done:
                self._maybe_pa_shrink(shard, job, fx[rows])

    # ---------------------------------------------------------------- tick
    def tick(self) -> None:
        """Admit, then advance every active slot by ``macro_k`` temperature
        levels (one when K = 1).

        The top of a tick is a macro-tick boundary: scripted operations,
        then admission (with evacuation, migration, shrinks and
        evictions), then finish-deadline truncations.  Then two passes:
        *launch* every group's work first (launches are asynchronous),
        then *collect*: bring results to the host, fold champions and
        retire finished requests.  ``tick_count`` advances on the
        ladder-level clock by the most levels any job consumed (1 on an
        idle tick).

        With telemetry on, each phase runs inside a span (``schedule /
        admit / dispatch / device_wait / materialize / retire``); on the
        card each group's launch is followed by a CUDA event, and
        ``device_wait`` waits on the events in launch order, so the host's
        launch cost and the device time it then waits on land in separate
        spans.  Waiting earlier changes when the host sees the results,
        never what was computed."""
        self._run_due_ops()
        if self.controller is not None:
            # The controller may resize before this boundary's admission
            # sees the fleet, like a scripted operation.
            with self._pt("schedule"):
                self.controller.maybe_sample(self)
        for shard in self.shards:
            shard.resident_ticks += 1
            self.slot_ticks += shard.pool.n_slots
        self._admit()
        self._plan_truncations()
        if self.n_active == 0:
            self._retire_drained()
            self._end_tick_telemetry()
            self.tick_count += 1
            return
        K = self.cfg.macro_k
        fence = self.telemetry.enabled and self.device.type == "cuda"
        launches = []
        waits = []      # with fence: one CUDA event per launch
        for shard in self.shards:
            groups: Dict[Tuple[str, int, int], List[ActiveJob]] = \
                defaultdict(list)
            for job in shard.rids.jobs.values():
                groups[(job.req.family, job.req.dim, job.req.N)].append(job)
            with self._pt("dispatch", shard.index):
                for (family, dim, n_steps), jobs in sorted(groups.items()):
                    launches.append(
                        self._launch_group(shard, family, dim, n_steps, jobs)
                        if K == 1 else
                        self._launch_group_fused(shard, family, dim,
                                                 n_steps, jobs))
                    self.group_launches += 1
                    if fence:
                        waits.append(_launch_done(shard.device))
        if self.telemetry.enabled:
            self.telemetry.m_launches.inc(len(launches))
            for i, launch in enumerate(launches):
                with self._pt("device_wait", launch[0].index):
                    if fence:
                        waits[i].synchronize()
        finished = []
        advance = 1
        for launch in launches:
            with self._pt("materialize", launch[0].index):
                if K == 1:
                    finished.extend(self._collect_group(*launch))
                else:
                    got, levels = self._collect_group_fused(*launch)
                    finished.extend(got)
                    advance = max(advance, levels)
        if advance > 1:
            for shard in self.shards:
                shard.resident_ticks += advance - 1
                self.slot_ticks += shard.pool.n_slots * (advance - 1)
        with self._pt("retire"):
            for shard, job, reason, finish_tick in finished:
                self._retire(shard, job, reason, finish_tick=finish_tick)
        # A draining shard whose last job just retired leaves now, so a
        # run that ends this tick leaves no empty draining shard behind.
        self._retire_drained()
        self._end_tick_telemetry(levels=advance)
        self.tick_count += advance

    def _end_tick_telemetry(self, levels: int = 1) -> None:
        """Fold this tick's spans into the registry, the shards' phase
        seconds and the trace (nothing when telemetry is off).  ``levels``
        is the tick's advance on the ladder-level clock."""
        tel = self.telemetry
        if not tel.enabled:
            return
        acc, shard_acc, raw, cpu = self._pt.drain()
        for (shard_idx, phase), secs in shard_acc.items():
            shard = next((s for s in self.shards if s.index == shard_idx),
                         None)
            if shard is not None:
                shard.phase_seconds[phase] = \
                    shard.phase_seconds.get(phase, 0.0) + secs
        tel.end_tick(self.tick_count, acc, shard_acc, raw, self.shards,
                     len(self.scheduler), self.n_active, levels=levels,
                     cpu=cpu)

    def _fold_level(self, shard: EngineShard, job: ActiveJob, n_steps: int,
                    f: float, xb: np.ndarray) -> Optional[str]:
        """Count one completed level of ``job``: fold its champion, advance
        its cursors, and return its finish reason (None to go on)."""
        if f < job.best_f:
            job.best_f = f
            job.best_x = xb.copy()
        self.sweeps_done += len(job.slots)
        shard.sweeps_done += len(job.slots)
        job.level += 1
        job.steps_done += n_steps
        job.evals += n_steps * job.granted_chains
        job.T *= job.req.rho
        job.history.append(job.best_f)       # champion trajectory/level
        if self.telemetry.enabled:
            self.telemetry.tenant_slot_ticks(job.req.req_id, len(job.slots))
        return self._finish_reason(job)

    @staticmethod
    def _champions(champ: torch.Tensor, state_dtype):
        """(k, S, dim + 1) float32 champions on the card -> host
        (values (k, S), states (k, S, dim) in the family's dtype)."""
        h = champ.cpu().numpy()
        return h[..., -1], np.ascontiguousarray(h[..., :-1]).view(state_dtype)

    def _collect_group(self, shard: EngineShard, n_steps: int,
                       jobs: List[ActiveJob], slot_list, outs):
        """Bring one group's level back to the host: its state (as the
        reference does at K = 1) and its champions; advance its jobs one
        level.  Returns the finished ``(shard, job, reason, tick)``."""
        cps = self.cfg.chains_per_slot
        x2, fx, fb, xb = outs
        x2 = x2.cpu().numpy()
        fb, xb = fb.cpu().numpy(), xb.cpu().numpy()
        fxh = fx.cpu().numpy() if self._needs_fx(jobs) else None
        for b, (s, _job) in enumerate(slot_list):
            # Copy: a bare slice would alias the whole padded buffer.
            shard.pool.set_block(s, x2[b * cps:(b + 1) * cps].copy())
        finished = []
        for job in jobs:
            if job.first_tick < 0:
                job.first_tick = self.tick_count
                job.first_tick_wall = self._now()
            reason = self._fold_level(shard, job, n_steps,
                                      float(fb[job.rid]), xb[job.rid])
            if reason is not None:
                finished.append((shard, job, reason, self.tick_count))
        self._pa_shrinks(shard, jobs, fxh, finished)
        return finished

    @staticmethod
    def _needs_fx(jobs: List[ActiveJob]) -> bool:
        """Whether the group's post-exchange f must come to the host: a
        PA job with the ESS controller on."""
        return any(j.req.pa_ess_ratio > 0 for j in jobs)

    def _collect_group_fused(self, shard: EngineShard, n_steps: int,
                             jobs: List[ActiveJob], slot_list, outs,
                             planned: Dict[int, int]):
        """Fold one macro-tick's per-level champions on the host (the
        chain state stays on the card).  Each job counts its levels as K
        ticks would, stopping at its first terminal level; ``finish_tick``
        is boundary + counted - 1.  Returns (finished, most levels any job
        consumed)."""
        boundary = self.tick_count
        champ, fx_keep = outs
        fb_all, xb_all = self._champions(champ, jobs[0].req.state_dtype)
        fxh = None if fx_keep is None else fx_keep.cpu().numpy()
        finished = []
        max_counted = 1
        for job in jobs:
            if job.first_tick < 0:
                job.first_tick = boundary
                job.first_tick_wall = self._now()
            counted = 0
            reason = None
            for i in range(planned[job.rid]):
                counted += 1
                reason = self._fold_level(shard, job, n_steps,
                                          float(fb_all[i, job.rid]),
                                          xb_all[i, job.rid])
                if reason is not None:
                    break
            max_counted = max(max_counted, counted)
            if reason is not None:
                finished.append((shard, job, reason, boundary + counted - 1))
        self._pa_shrinks(shard, jobs, fxh, finished)
        return finished, max_counted

    def _pack(self, shard: EngineShard, family: str, dim: int, n_steps: int,
              jobs: List[ActiveJob], k: int, planned: Optional[Dict[int, int]]):
        """Host arrays of one group's controls for ``k`` levels.  Returns
        (slot_list, n_padded, arrays); ``planned`` None means every block
        is live at its one level (the K = 1 path)."""
        cps = self.cfg.chains_per_slot
        is_qap = family == fam_mod.FAMILY_PERMUTATION
        slot_list: List[Tuple[int, ActiveJob]] = [
            (s, job) for job in jobs for s in job.slots]
        n_blocks = len(slot_list)
        n_padded = 1
        while n_padded < n_blocks:
            n_padded *= 2
        a = {}
        if is_qap:
            # Per-block instance operands, packed (n_padded * dim, dim):
            # block b reads rows [b*dim, (b+1)*dim).
            a["F"] = np.empty((n_padded * dim, dim), np.float32)
            a["D"] = np.empty((n_padded * dim, dim), np.float32)
        else:
            a["kid"] = np.empty((n_padded,), np.int32)
        a["T"] = np.empty((k, n_padded), np.float32)
        a["step0"] = np.empty((k, n_padded), np.uint32)
        a["lvl"] = np.empty((k, n_padded), np.uint32)
        if planned is not None:
            a["live"] = np.empty((k, n_padded), np.int32)
        a["seed"] = np.empty((n_padded,), np.uint32)
        a["base"] = np.empty((n_padded,), np.uint32)
        a["seg"] = np.empty((n_padded * cps,), np.int32)
        a["adopt"] = np.zeros((n_padded * cps,), np.int32)
        methods = {job.req.method for job in jobs}
        if "pa" in methods:
            a["dbeta"] = np.zeros((k, n_padded), np.float32)
        for b, (s, job) in enumerate(slot_list):
            req = job.req
            if is_qap:
                inst = req.instance
                a["F"][b * dim:(b + 1) * dim] = inst.F
                a["D"][b * dim:(b + 1) * dim] = inst.D
            else:
                a["kid"][b] = req.kid
            t = job.T
            for i in range(k):
                # float64 iteration, float32 per level: identical to K
                # ticks' pack-then-advance of the float ``job.T`` cursor.
                a["T"][i, b] = t
                if req.method == "pa":
                    a["dbeta"][i, b] = _pa_dbeta(t, req.rho)
                t *= req.rho
                a["step0"][i, b] = (job.steps_done + i * n_steps) & rng.MASK32
                a["lvl"][i, b] = (job.level + i) & rng.MASK32
            if planned is not None:
                a["live"][:, b] = np.arange(k) < planned[job.rid]
            a["seed"][b] = req.seed & rng.MASK32
            a["base"][b] = shard.pool.chain_base[s]
            a["seg"][b * cps:(b + 1) * cps] = job.rid
            a["adopt"][b * cps:(b + 1) * cps] = (req.method == "sa"
                                                 and req.exchange == "sync")
        a.update(self._pack_class_controls(jobs, n_padded))
        # Pad blocks replicate block 0, claim the reserved segment n_slots
        # and never adopt; in the fused path they are dead.
        for b in range(n_blocks, n_padded):
            if is_qap:
                a["F"][b * dim:(b + 1) * dim] = a["F"][:dim]
                a["D"][b * dim:(b + 1) * dim] = a["D"][:dim]
            else:
                a["kid"][b] = a["kid"][0]
            for name in ("T", "step0", "lvl"):
                a[name][:, b] = a[name][:, 0]
            if planned is not None:
                a["live"][:, b] = 0
            a["seed"][b] = a["seed"][0]
            a["base"][b] = a["base"][0]
            a["seg"][b * cps:(b + 1) * cps] = self.cfg.n_slots
        return slot_list, n_padded, a

    def _pack_class_controls(self, jobs: List[ActiveJob], n_padded: int):
        """Per-chain workload-class arrays of one packed group.

        A request's chains are contiguous in the packed buffer in logical
        order, so PT partner rows and PA row ranges are offsets from its
        first row.  Only the operands of the classes present are built;
        defaults are the identity of every stage (plain code, self
        partner, self range), so pads and other tenants pass through bit
        for bit.  Partner row ``j`` holds each PT chain's partner at the
        parity of its job's ``level + j``: the fused loop's level ``i``
        reads row ``i % 2``."""
        nc = n_padded * self.cfg.chains_per_slot
        rows = np.arange(nc, dtype=np.int32)
        a = {"mcode": np.zeros((nc,), np.int32)}
        methods = {job.req.method for job in jobs}
        if "pt" in methods:
            a["t_rung"] = np.ones((nc,), np.float32)
            a["partner"] = np.tile(rows, (2, 1))
            a["pairlo"] = np.zeros((2, nc), np.uint32)
        if "pa" in methods:
            a["seg_lo"] = rows.copy()
            a["seg_hi"] = rows + 1
        row0 = 0
        for job in jobs:
            n = job.granted_chains
            a["mcode"][row0:row0 + n] = _job_mcode(job.req)
            if job.req.method == "pt":
                a["t_rung"][row0:row0 + n] = job.req.pt_rungs(n)
                for j in range(2):
                    prt, plo = _pt_partners(n, (job.level + j) % 2)
                    a["partner"][j, row0:row0 + n] = row0 + prt
                    a["pairlo"][j, row0:row0 + n] = plo
            elif job.req.method == "pa":
                a["seg_lo"][row0:row0 + n] = row0
                a["seg_hi"][row0:row0 + n] = row0 + n
            row0 += n
        if not a["mcode"].any():
            del a["mcode"]        # plain chains only: no stage to mask
        return a

    @staticmethod
    def _controls(d: Dict[str, torch.Tensor], a: Dict[str, np.ndarray]
                  ) -> _GroupControls:
        """The uploaded controls ``d``; the host arrays ``a`` say which
        classes the group holds, so no mask is read back from the card."""
        codes = (set(np.unique(a["mcode"]).tolist()) if "mcode" in a
                 else set())

        def mask(code):
            return d["mcode"] == code if code in codes else None

        return _GroupControls(
            T=d["T"], step0=d["step0"], lvl=d["lvl"], live=d.get("live"),
            seed=d["seed"], base=d["base"], seg=d["seg"],
            adopt=d["adopt"] != 0, is_sos=mask(exch.MCODE_SOS),
            is_pt=mask(exch.MCODE_PT), t_rung=d.get("t_rung"),
            partner=d.get("partner"),
            pairlo=d.get("pairlo"), is_pa=mask(exch.MCODE_PA),
            seg_lo=d.get("seg_lo"), seg_hi=d.get("seg_hi"),
            dbeta=d.get("dbeta"))

    def _sweep(self, family: str, d: Dict[str, torch.Tensor], n_steps: int,
               dev: torch.device):
        """The group's sweep on ``dev``, ``sweep(x, T, step0, live, out,
        t_chain)``: kernel B1 for the continuous family (per-chain
        temperatures ``t_chain`` when the group holds PT chains), B3 for
        QAP (SA only, so never a ``t_chain``)."""
        cps = self.cfg.chains_per_slot
        seed, base = d["seed"], d["base"]
        if family == fam_mod.FAMILY_PERMUTATION:
            F, D = d["F"], d["D"]

            def sweep(x, T, step0, live, out, t_chain):
                return ops.qap_sweep_slots(
                    x, F, D, T, seed, step0, base, n_steps=n_steps, blk=cps,
                    live=live, device=dev, out=out)
        else:
            kid, variant = d["kid"], self.cfg.variant

            def sweep(x, T, step0, live, out, t_chain):
                return ops.metropolis_sweep_slots(
                    x, kid, T, seed, step0, base, n_steps=n_steps, blk=cps,
                    variant=variant, live=live, T_chain=t_chain, device=dev,
                    out=out, kid_checked=True)
        return sweep

    def _host_state(self, shard: EngineShard, slot_list, n_padded: int,
                    dtype) -> np.ndarray:
        """The group's packed state on the host; pad blocks copy block 0."""
        cps = self.cfg.chains_per_slot
        x = np.empty((n_padded * cps, slot_list[0][1].req.dim), dtype)
        for b, (s, _job) in enumerate(slot_list):
            x[b * cps:(b + 1) * cps] = shard.pool.get_block(s)
        for b in range(len(slot_list), n_padded):
            x[b * cps:(b + 1) * cps] = x[:cps]
        return x

    def _launch_group_fused(self, shard: EngineShard, family: str, dim: int,
                            n_steps: int, jobs: List[ActiveJob]):
        """Pack the group's controls, reuse (or rebuild) its state buffers
        and launch K levels (asynchronously).

        Per-job level planning: ``min(K, remaining ladder, remaining eval
        budget)``, so budget and ladder finishes land on exactly the K = 1
        level.  If every slot of the group still references the buffer
        that holds the group's state, at its packed rows, the host repack
        and the state upload are skipped."""
        cps = self.cfg.chains_per_slot
        K = self.cfg.macro_k
        planned: Dict[int, int] = {}
        for job in jobs:
            p = min(K, max(1, self._levels_limit(job) - job.level))
            if job.req.max_evals is not None:
                per_level = max(1, n_steps * job.granted_chains)
                remaining = job.req.max_evals - job.evals
                p = min(p, max(1, -(-remaining // per_level)))
            planned[job.rid] = p
        slot_list, n_padded, a = self._pack(shard, family, dim, n_steps,
                                            jobs, K, planned)
        key = (family, dim, n_steps)
        cache = shard.group_cache.get(key)
        hit = cache is not None and cache["n_padded"] == n_padded
        if hit:
            for b, (s, _job) in enumerate(slot_list):
                ref = shard.pool.device_ref(s)
                if ref is None or ref.buf is not cache["x"] \
                        or ref.start != b * cps:
                    hit = False
                    break
        if not hit:
            a["x"] = self._host_state(shard, slot_list, n_padded,
                                      jobs[0].req.state_dtype)
        d = _upload(a, shard.device)
        if hit:
            x, spare = cache["x"], cache["spare"]
        else:
            x, spare = d["x"], torch.empty_like(d["x"])
        outs = _group_tick_fused(
            x, spare, self._sweep(family, d, n_steps, shard.device),
            self._controls(d, a),
            k=K, blk=cps, num_segments=self.cfg.n_slots + 1,
            keep_fx=self._needs_fx(jobs))
        # The group's state lives in x: point every slot there
        # (materialized only on a cache-miss repack) for the next boundary.
        for b, (s, _job) in enumerate(slot_list):
            shard.pool.set_device_block(s, x, b * cps, (b + 1) * cps)
        shard.group_cache[key] = {"x": x, "spare": spare,
                                  "n_padded": n_padded}
        return shard, n_steps, jobs, slot_list, outs, planned

    def _launch_group(self, shard: EngineShard, family: str, dim: int,
                      n_steps: int, jobs: List[ActiveJob]):
        """Pack the group's state and controls, upload them and launch one
        level (asynchronously); returns the collect pass's arguments."""
        slot_list, n_padded, a = self._pack(shard, family, dim, n_steps,
                                            jobs, 1, None)
        a["x"] = self._host_state(shard, slot_list, n_padded,
                                  jobs[0].req.state_dtype)
        d = _upload(a, shard.device)
        x2, fx, xb, fb = _group_tick(
            d["x"], self._sweep(family, d, n_steps, shard.device),
            self._controls(d, a),
            blk=self.cfg.chains_per_slot, num_segments=self.cfg.n_slots + 1)
        return shard, n_steps, jobs, slot_list, (x2, fx, fb, xb)

    def _finish_reason(self, job: ActiveJob) -> Optional[str]:
        req = job.req
        if req.target_error is not None:
            f_opt = (F_OPT.get(req.kid)
                     if req.family == fam_mod.FAMILY_CONTINUOUS
                     else req.f_opt)
            if f_opt is not None and job.best_f <= f_opt + req.target_error:
                return "target"
        if req.max_evals is not None and job.evals >= req.max_evals:
            return "budget"
        if job.level >= self._levels_limit(job):
            # 'truncated' only when a finish-deadline cut moved the end.
            return "truncated" if job.truncate_events else "ladder"
        return None

    @staticmethod
    def _levels_limit(job: ActiveJob) -> int:
        """The job's ladder length (``levels_limit`` once placed)."""
        return job.levels_limit or job.req.n_levels

    def _retire(self, shard: EngineShard, job: ActiveJob, reason: str,
                finish_tick: Optional[int] = None) -> None:
        if finish_tick is None:
            finish_tick = self.tick_count
        self.results.append(RequestResult(
            req_id=job.req.req_id, objective=job.req.objective,
            dim=job.req.dim, x_best=job.best_x, f_best=job.best_f,
            levels_run=job.level, n_evals=job.evals,
            submit_tick=job.submit_tick, start_tick=job.start_tick,
            finish_tick=finish_tick, finish_reason=reason,
            arrival_time=job.arrival_time, first_tick=job.first_tick,
            submit_wall=job.submit_wall, admit_wall=job.admit_wall,
            first_tick_wall=job.first_tick_wall, finish_wall=self._now(),
            requested_chains=job.req.n_chains,
            granted_chains=job.granted_chains,
            preempted_ticks=list(job.preempted_ticks),
            resumed_ticks=list(job.resumed_ticks),
            champion_history=list(job.history),
            home_shard=job.home_shard,
            migrated_ticks=list(job.migrated_ticks),
            shrunk_ticks=list(job.shrunk_ticks),
            shrink_events=list(job.shrink_events),
            pa_shrink_events=list(job.pa_shrink_events),
            truncated_ticks=list(job.truncated_ticks),
            truncate_events=list(job.truncate_events)))
        shard.pool.release(job.rid)
        shard.rids.free(job.rid)
        tel = self.telemetry
        if tel.enabled:
            tel.decision(self.tick_count, "retire", req_id=job.req.req_id,
                         shard=shard.index, reason=reason, level=job.level,
                         best_f=job.best_f)
            if tel.trace is not None:
                tel.trace.request_end(job.req.req_id, reason=reason,
                                      tick=self.tick_count,
                                      levels=job.level, best_f=job.best_f)

    # ----------------------------------------------------------------- run
    def run(self, max_ticks: Optional[int] = None) -> List[RequestResult]:
        """Drive ticks until queue and pool drain (or ``max_ticks``):
        closed-loop serving of whatever was submitted, the open-loop run
        of an exhausted arrival stream."""
        return self.run_stream(ArrivalProcess.batch([]), max_ticks=max_ticks)

    def run_stream(self, arrivals, max_ticks: Optional[int] = None
                   ) -> List[RequestResult]:
        """Open-loop serving: submit each request of ``arrivals`` (an
        :class:`~repro_torch.service.arrivals.ArrivalProcess`, or anything
        with ``due(now)`` and ``exhausted``) when its arrival time comes
        due, while ticking.  With nothing in flight the clock jumps to the
        next arrival (``next_time``), never past a scheduled operation, so
        arrival timestamps stay on the tick axis."""
        t0 = self._now()
        while True:
            if max_ticks is not None and self.tick_count >= max_ticks:
                break
            for t_arr, req in arrivals.due(self.tick_count):
                self.submit(req, arrival_time=t_arr)
            if self.done:
                if arrivals.exhausted:
                    break
                nxt = getattr(arrivals, "next_time", None)
                if nxt is not None and math.isfinite(nxt):
                    jump = int(math.ceil(nxt))
                    if max_ticks is not None:
                        jump = min(jump, max_ticks)
                    if self._ops:
                        jump = min(jump, int(self._next_op_tick))
                    if self.controller is not None:
                        # Nor past the controller's next sample: idle gaps
                        # are when scale-down decisions fire.
                        jump = min(jump,
                                   int(self.controller.next_sample_tick))
                    if jump > self.tick_count:
                        # The fleet held its slots across the jumped ticks.
                        delta = jump - self.tick_count
                        for shard in self.shards:
                            shard.resident_ticks += delta
                            self.slot_ticks += delta * shard.pool.n_slots
                        self.tick_count = jump
                        continue
            self.tick()
        self.wall_s = self._now() - t0
        return self.results

    def stats(self) -> dict:
        wall = getattr(self, "wall_s", float("nan"))
        evals = sum(r.n_evals for r in self.results)

        def per_s(v):
            return v / wall if wall and wall > 0 else 0.0

        return {
            "ticks": self.tick_count,
            "devices": len(self.shards),
            "draining": sum(s.draining for s in self.shards),
            "shards_retired": len(self.retired_shards),
            "group_launches": self.group_launches,
            "submitted": self.n_submitted,
            "completed": sum(r.completed for r in self.results),
            "rejected": self.rejections,
            "preemptions": self.preemptions,
            "migrations": self.migrations,
            "shrinks": self.shrinks,
            "truncations": self.truncations,
            "sweeps": self.sweeps_done,
            "occupancy": self.sweeps_done / max(self.slot_ticks, 1),
            "shard_occupancy": [s.occupancy() for s in self.shards],
            "wall_s": wall,
            "requests_per_s": per_s(len(self.results)),
            "sweeps_per_s": per_s(self.sweeps_done),
            "chain_steps_per_s": per_s(evals),
            # Per-phase wall seconds, aggregate and per shard, and CPU
            # seconds (empty unless telemetry is on).
            "phases": self._phase_stats(),
        }

    def _phase_stats(self) -> dict:
        if not self.telemetry.enabled:
            return {}
        hist = self.telemetry.m_tick_phase
        agg = {phase: hist.summary(phase)
               for (phase,) in sorted(hist.series)}
        per_shard = {
            str(s.index): dict(sorted(s.phase_seconds.items()))
            for s in self.shards if s.phase_seconds}
        cpu = {phase: secs for (phase,), secs
               in sorted(self.telemetry.m_phase_cpu.series.items())}
        return {"aggregate": agg, "per_shard": per_shard,
                "cpu_seconds": cpu}


def _launch_done(device: torch.device) -> torch.cuda.Event:
    """A CUDA event recorded on ``device``'s current stream behind the
    work enqueued so far: the ``device_wait`` fence of one launch."""
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return done


def _pt_partners(n: int, parity: int):
    """Logical even/odd swap partners of an ``n``-rung PT ladder.

    Parity 0 pairs rungs (0,1)(2,3)..., parity 1 pairs (1,2)(3,4)...; a
    rung without a partner at this parity is its own partner (no swap
    proposed).  Returns ``(partner int32, pairlo uint32)``, ``pairlo`` the
    lower logical rung of each pair: the shared key of both partners'
    accept uniform."""
    lg = np.arange(n, dtype=np.int64)
    if parity == 0:
        p = lg ^ 1
    else:
        p = np.where(lg == 0, lg, ((lg - 1) ^ 1) + 1)
    p = np.where(p < n, p, lg)
    return p.astype(np.int32), np.minimum(lg, p).astype(np.uint32)


def _job_mcode(req: SARequest) -> int:
    """Per-chain workload-class code (core/exchange) of a request."""
    if req.method == "pt":
        return exch.MCODE_PT
    if req.method == "pa":
        return exch.MCODE_PA
    return exch.MCODE_SOS if req.exchange == "sos" else exch.MCODE_PLAIN


def _pa_dbeta(t: float, rho: float) -> float:
    """PA inverse-temperature increment across one cooling step, in
    float64 host math (cast to float32 at upload): the reweighting
    exponent between level temperature ``t`` and the next."""
    return 1.0 / (t * rho) - 1.0 / t


def run_standalone(req: SARequest, cfg: EngineConfig,
                   shrink_schedule=None,
                   truncate_schedule=None) -> RequestResult:
    """Serve ``req`` alone on a dedicated one-shard pool: the per-tenant
    baseline.

    Placement-invariant RNG and the segmented exchange make the packed
    engine produce the same trajectory as this single-tenant run, bit for
    bit, at any macro-K, on any shard, across preemption and migration.

    ``shrink_schedule`` replays width cuts as ``(level, n_chains)`` pairs
    and ``truncate_schedule`` ladder cuts as ``(level, n_levels)`` pairs,
    each applied once the job has completed ``level`` levels
    (``RequestResult.shrink_events`` and ``truncate_events`` record them
    as ``(level, from, to)``).  They apply at macro-tick boundaries, so at
    ``cfg.macro_k > 1`` the levels must be K-aligned, which the engine's
    recorded events always are."""
    alone = SAServeEngine(dataclasses.replace(
        cfg, n_slots=req.slots_needed(cfg.chains_per_slot), n_devices=1))
    alone.submit(req)
    pending = sorted((int(lvl), int(chains))
                     for lvl, chains in (shrink_schedule or ()))
    cuts = sorted((int(lvl), int(levels))
                  for lvl, levels in (truncate_schedule or ()))
    guard = 0
    while not alone.done:
        guard += 1
        if guard >= 100000:
            raise RuntimeError("standalone replay failed to drain")
        job = next((j for _, j in alone._iter_jobs()), None)
        while pending and job is not None and job.level >= pending[0][0]:
            alone.degrade_active(req.req_id, pending[0][1])
            pending.pop(0)
        while cuts and job is not None and job.level >= cuts[0][0]:
            alone.truncate_active(req.req_id, cuts[0][1])
            cuts.pop(0)
        alone.tick()
    return alone.results[0]
