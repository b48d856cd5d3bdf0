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

Not ported yet, each raising ``NotImplementedError``: parallel tempering
and population annealing requests, completion deadlines, preemption,
migration, drain and resize, proactive and admission-time degrade, the
autoscaler hook, open-loop ``run_stream``, enabled telemetry and several
shards.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.service.request import RequestResult, SARequest
from repro_torch.service.scheduler import (AdmissionScheduler, QueueEntry,
                                           SchedulerConfig, ShardView)
from repro_torch.service.sharding import EngineShard, make_shards
from repro_torch.service.slots import ActiveJob
from repro_torch.service.telemetry import NULL as NULL_TELEMETRY

#: Known optima of the servable continuous objectives, keyed by kernel id,
#: derived from the family layer's name-keyed table.  QAP requests read
#: their instance's ``best_known`` instead.
F_OPT = {om.KID_BY_NAME[name]: v
         for name, v in fam_mod.F_OPT_BY_NAME.items()}


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               "engine yet")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8            # slots per shard
    chains_per_slot: int = 64   # chains per slot == kernel block size
    n_devices: int = 1          # engine shards; only 1 is ported
    variant: str = "delta"      # continuous sweep: 'delta' | 'full'
    device: object = None       # None = the card; "cpu" runs the plain
                                # versions of the kernels
    migration_budget: int = 1   # max cross-shard moves per tick
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
    is_sos: Optional[torch.Tensor]  # (chains,) bool, None if no SOS chain


def _chain_controls(T_blk, seed_blk, base_blk, lvl0, blk: int):
    """Expand per-block controls to the per-chain arrays the SOS stage of
    the exchange consumes: the schedule temperature, the request seed, the
    logical chain index and the absolute ladder level."""
    lane = torch.arange(blk, device=T_blk.device).repeat(T_blk.shape[0])
    sched = T_blk.repeat_interleave(blk)
    seed_c = seed_blk.repeat_interleave(blk)
    cidx = (rng.as_u32(base_blk).repeat_interleave(blk) + lane) & rng.MASK32
    lvl_abs = rng.as_u32(lvl0).repeat_interleave(blk)
    return sched, seed_c, cidx, lvl_abs


def _exchange(x, fx, ctl: _GroupControls, i: int, live_c, blk: int,
              num_segments: int, out=None):
    sos = (None,) * 4 if ctl.is_sos is None else _chain_controls(
        ctl.T[i], ctl.seed, ctl.base, ctl.lvl[i], blk)
    return exch._serving_exchange(x, fx, ctl.seg, num_segments, ctl.adopt,
                                  ctl.is_sos, *sos, live_c, out=out)


def _group_tick(x, sweep, ctl: _GroupControls, *, blk: int,
                num_segments: int):
    """One temperature level for one dispatch group: ``sweep`` (kernel B1
    or B3 over every block at its own temperature and step cursor), then
    the segmented exchange.  Returns (x, fx, xb, fb), the champions of
    every segment."""
    x, fx = sweep(x, ctl.T[0], ctl.step0[0], None, None)
    live = torch.ones(fx.shape, dtype=torch.bool, device=fx.device)
    return _exchange(x, fx, ctl, 0, live, blk, num_segments)


def _group_tick_fused(x, spare, sweep, ctl: _GroupControls, *, k: int,
                      blk: int, num_segments: int):
    """K temperature levels for one dispatch group, with no host
    synchronisation: exactly the :func:`_group_tick` body K times, so each
    level computes what K separate ticks would.

    ``x`` holds the group's state and ``spare`` is a second buffer of its
    shape: each level sweeps ``x`` into ``spare`` and the exchange writes
    its adoption back into ``x``, so the state ends in ``x`` with no copy
    and no allocation of its size.  A block whose request has fewer than
    K planned levels goes dead (``ctl.live``): the kernel passes its state
    through and the exchange leaves its chains alone.  Returns the
    champions ``(k, num_segments, dim + 1)`` float32 on the card: each
    level's champion states, bit-cast to float32, and their values in the
    last column."""
    dim = x.shape[1]
    champ = torch.empty((k, num_segments, dim + 1), dtype=torch.float32,
                        device=x.device)
    for i in range(k):
        swept, fx = sweep(x, ctl.T[i], ctl.step0[i], ctl.live[i], spare)
        live_c = ctl.live[i].repeat_interleave(blk) != 0
        _, _, xb, fb = _exchange(swept, fx, ctl, i, live_c, blk,
                                 num_segments, out=x)
        champ[i, :, :dim] = xb.view(torch.float32)
        champ[i, :, dim] = fb
    return champ


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

    def __init__(self, cfg: Optional[EngineConfig] = None):
        cfg = EngineConfig() if cfg is None else cfg
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.shards: List[EngineShard] = make_shards(
            cfg.n_devices, cfg.n_slots, cfg.chains_per_slot, self.device)
        self.scheduler = AdmissionScheduler(cfg.scheduler)
        self.telemetry = NULL_TELEMETRY
        self.results: List[RequestResult] = []
        self.tick_count = 0
        self.n_submitted = 0          # requests offered via submit()
        self.sweeps_done = 0          # block-sweeps (slot x level)
        self.group_launches = 0
        self.rejections = 0           # SLO admission-control drops
        self.slot_ticks = 0           # occupancy denominator
        self._epoch = time.perf_counter()
        self._pt = self.telemetry.make_phase_timer(self._now)
        #: req_id -> (arrival_time in ticks, submit wall time)
        self._submit_info: Dict[int, Tuple[float, float]] = {}

    def _now(self) -> float:
        """Monotonic wall seconds since engine construction."""
        return time.perf_counter() - self._epoch

    # ------------------------------------------------------------ frontend
    def submit(self, req: SARequest, arrival_time: Optional[float] = None
               ) -> None:
        """Enqueue ``req``.  ``arrival_time`` (in ticks) defaults to the
        submit tick."""
        if req.method != "sa":
            raise _not_ported(f"method {req.method!r}")
        if req.finish_deadline is not None:
            raise _not_ported("finish_deadline (ladder truncation)")
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
        for shard in self.shards:
            if shard.index == index:
                return shard
        raise ValueError(f"no live shard with index {index}")

    @property
    def n_active(self) -> int:
        return sum(len(s.rids.jobs) for s in self.shards)

    @property
    def done(self) -> bool:
        return self.n_active == 0 and len(self.scheduler) == 0

    # ----------------------------------------------------------- admission
    def _admit(self) -> None:
        """Plan this boundary's admissions and execute them.  Plans that
        would shrink, preempt or degrade running or queued work need
        features of a later slice and raise before anything changes.  The
        cross-shard plans (migration, watermark rebalancing) are not run:
        on the one shard this slice serves they never return a move."""
        cps = self.cfg.chains_per_slot
        pt = self._pt
        with pt("schedule"):
            views = [self._view(s) for s in self.shards]
            if self.cfg.scheduler.proactive_degrade and \
                    self.scheduler.plan_shrinks(
                        views, cps, self.tick_count,
                        self.cfg.scheduler.shrink_budget):
                raise _not_ported("proactive degrade")
            plan = self.scheduler.admit_sharded(views, cps, self.tick_count)
        if plan.evict:
            raise _not_ported("preemption")
        for entry, granted_slots, _si in plan.admitted:
            if granted_slots < entry.req.slots_needed(cps):
                raise _not_ported("admission at reduced width (degrade)")
        with pt("admit"):
            for entry in plan.rejected:
                self._reject(entry)
            for entry, granted_slots, si in plan.admitted:
                self._place(self._shard(si), entry, granted_slots)

    def _place(self, shard: EngineShard, entry: QueueEntry,
               granted_slots: int) -> None:
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

    # -------------------------------------------------- not ported yet
    def preempt(self, req_id: int) -> bool:
        raise _not_ported("preempt")

    def migrate(self, req_id: int, to_shard: int) -> bool:
        raise _not_ported("migrate")

    def drain(self, shard_index: int) -> None:
        raise _not_ported("drain")

    def resize(self, n_devices: int) -> None:
        raise _not_ported("resize")

    def add_shards(self, n: int) -> List[int]:
        raise _not_ported("add_shards")

    def degrade_active(self, req_id: int, n_chains: int) -> bool:
        raise _not_ported("degrade_active")

    def truncate_active(self, req_id: int, n_levels: int) -> bool:
        raise _not_ported("truncate_active")

    def attach_controller(self, controller) -> None:
        raise _not_ported("attach_controller (the autoscaler)")

    def run_stream(self, arrivals, max_ticks: Optional[int] = None):
        raise _not_ported("run_stream (open-loop arrivals)")

    def _maybe_pa_shrink(self, shard, job, fx_job) -> None:
        raise _not_ported("population annealing")

    # ---------------------------------------------------------------- tick
    def tick(self) -> None:
        """Admit, then advance every active slot by ``macro_k`` temperature
        levels (one when K = 1).

        Two passes: *launch* every group's work first (launches are
        asynchronous), then *collect*: bring results to the host, fold
        champions and retire finished requests.  ``tick_count`` advances
        on the ladder-level clock by the most levels any job consumed."""
        for shard in self.shards:
            shard.resident_ticks += 1
            self.slot_ticks += shard.pool.n_slots
        self._admit()
        if self.n_active == 0:
            self.tick_count += 1
            return
        K = self.cfg.macro_k
        launches = []
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
        self.tick_count += advance

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
        x2, fb, xb = outs
        x2 = x2.cpu().numpy()
        fb, xb = fb.cpu().numpy(), xb.cpu().numpy()
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
        return finished

    def _collect_group_fused(self, shard: EngineShard, n_steps: int,
                             jobs: List[ActiveJob], slot_list, champ,
                             planned: Dict[int, int]):
        """Fold one macro-tick's per-level champions on the host (the
        chain state stays on the card).  Each job counts its levels as K
        ticks would, stopping at its first terminal level; ``finish_tick``
        is boundary + counted - 1.  Returns (finished, most levels any job
        consumed)."""
        boundary = self.tick_count
        fb_all, xb_all = self._champions(champ, jobs[0].req.state_dtype)
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
        # The reference's per-chain class codes reduce to the SOS mask here:
        # parallel tempering and population annealing are not ported.
        a["is_sos"] = np.zeros((n_padded * cps,), np.int32)
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
                t *= req.rho
                a["step0"][i, b] = (job.steps_done + i * n_steps) & rng.MASK32
                a["lvl"][i, b] = (job.level + i) & rng.MASK32
            if planned is not None:
                a["live"][:, b] = np.arange(k) < planned[job.rid]
            a["seed"][b] = req.seed & rng.MASK32
            a["base"][b] = shard.pool.chain_base[s]
            a["seg"][b * cps:(b + 1) * cps] = job.rid
            a["adopt"][b * cps:(b + 1) * cps] = req.exchange == "sync"
            a["is_sos"][b * cps:(b + 1) * cps] = req.exchange == "sos"
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
        if not a["is_sos"].any():
            del a["is_sos"]   # the SOS stage is skipped, not masked off
        return slot_list, n_padded, a

    def _controls(self, d: Dict[str, torch.Tensor]) -> _GroupControls:
        return _GroupControls(
            T=d["T"], step0=d["step0"], lvl=d["lvl"], live=d.get("live"),
            seed=d["seed"], base=d["base"], seg=d["seg"],
            adopt=d["adopt"] != 0,
            is_sos=d["is_sos"] != 0 if "is_sos" in d else None)

    def _sweep(self, family: str, d: Dict[str, torch.Tensor], n_steps: int):
        """The group's sweep, ``sweep(x, T, step0, live, out)``: kernel B1
        for the continuous family, B3 for QAP."""
        cps, dev = self.cfg.chains_per_slot, self.device
        seed, base = d["seed"], d["base"]
        if family == fam_mod.FAMILY_PERMUTATION:
            F, D = d["F"], d["D"]

            def sweep(x, T, step0, live, out):
                return ops.qap_sweep_slots(
                    x, F, D, T, seed, step0, base, n_steps=n_steps, blk=cps,
                    live=live, device=dev, out=out)
        else:
            kid, variant = d["kid"], self.cfg.variant

            def sweep(x, T, step0, live, out):
                return ops.metropolis_sweep_slots(
                    x, kid, T, seed, step0, base, n_steps=n_steps, blk=cps,
                    variant=variant, live=live, device=dev, out=out,
                    kid_checked=True)
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
        d = _upload(a, self.device)
        if hit:
            x, spare = cache["x"], cache["spare"]
        else:
            x, spare = d["x"], torch.empty_like(d["x"])
        champ = _group_tick_fused(
            x, spare, self._sweep(family, d, n_steps), self._controls(d),
            k=K, blk=cps, num_segments=self.cfg.n_slots + 1)
        # The group's state lives in x: point every slot there
        # (materialized only on a cache-miss repack) for the next boundary.
        for b, (s, _job) in enumerate(slot_list):
            shard.pool.set_device_block(s, x, b * cps, (b + 1) * cps)
        shard.group_cache[key] = {"x": x, "spare": spare,
                                  "n_padded": n_padded}
        return shard, n_steps, jobs, slot_list, champ, planned

    def _launch_group(self, shard: EngineShard, family: str, dim: int,
                      n_steps: int, jobs: List[ActiveJob]):
        """Pack the group's state and controls, upload them and launch one
        level (asynchronously); returns the collect pass's arguments."""
        slot_list, n_padded, a = self._pack(shard, family, dim, n_steps,
                                            jobs, 1, None)
        a["x"] = self._host_state(shard, slot_list, n_padded,
                                  jobs[0].req.state_dtype)
        d = _upload(a, self.device)
        x2, _, xb, fb = _group_tick(
            d["x"], self._sweep(family, d, n_steps), self._controls(d),
            blk=self.cfg.chains_per_slot, num_segments=self.cfg.n_slots + 1)
        return shard, n_steps, jobs, slot_list, (x2, fb, xb)

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
            return "ladder"
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
            champion_history=list(job.history),
            home_shard=job.home_shard))
        shard.pool.release(job.rid)
        shard.rids.free(job.rid)

    # ----------------------------------------------------------------- run
    def run(self, max_ticks: Optional[int] = None) -> List[RequestResult]:
        """Drive ticks until queue and pool drain (or ``max_ticks``):
        closed-loop serving of whatever was submitted."""
        t0 = self._now()
        while not self.done and (max_ticks is None
                                 or self.tick_count < max_ticks):
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
            "draining": 0,
            "shards_retired": 0,
            "group_launches": self.group_launches,
            "submitted": self.n_submitted,
            "completed": sum(r.completed for r in self.results),
            "rejected": self.rejections,
            "preemptions": 0,
            "migrations": 0,
            "shrinks": 0,
            "truncations": 0,
            "sweeps": self.sweeps_done,
            "occupancy": self.sweeps_done / max(self.slot_ticks, 1),
            "shard_occupancy": [s.occupancy() for s in self.shards],
            "wall_s": wall,
            "requests_per_s": per_s(len(self.results)),
            "sweeps_per_s": per_s(self.sweeps_done),
            "chain_steps_per_s": per_s(evals),
            "phases": {},
        }


def _pt_partners(n: int, parity: int):
    raise _not_ported("parallel tempering")


def _pa_dbeta(t: float, rho: float) -> float:
    raise _not_ported("population annealing")


def run_standalone(req: SARequest, cfg: EngineConfig) -> RequestResult:
    """Serve ``req`` alone on a dedicated pool: the per-tenant baseline.

    Placement-invariant RNG and the segmented exchange make the packed
    engine produce the same trajectory as this single-tenant run, bit for
    bit, at any macro-K; the tests and ``serve_sa --check`` hold it."""
    alone = SAServeEngine(dataclasses.replace(
        cfg, n_slots=req.slots_needed(cfg.chains_per_slot), n_devices=1))
    alone.submit(req)
    return alone.run()[0]
