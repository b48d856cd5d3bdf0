"""Closed-loop fleet autoscaler, the serving engine's control plane: the
counterpart of ``repro.service.autoscaler``, pure host arithmetic.

It composes the elastic fleet (``engine.resize``: drain-based shrink,
instant grow) and completion deadlines (ladder truncation) into a
controller that samples the fleet on a fixed tick cadence, grows before a
predicted deadline miss and shrinks only after sustained idleness.

Control law, per sample:

* **Demand** is outstanding work in slot-levels: each queued request adds
  ``slots_needed x n_levels`` (a swapped checkpoint its held slots x the
  levels left), each resident job ``slots_held x levels left``.  One
  occupied slot retires one slot-level per tick.
* **Window** is the tightest completion budget: the least
  ``arrival + finish_deadline - now`` over outstanding work (at least 1);
  work without a finish deadline counts its remaining ladder.
* **Scale up** when ``demand x headroom > capacity_slots x window``, to
  ``ceil(demand x headroom / (window x slots_per_shard))`` shards within
  ``[min_shards, max_shards]``, in one decision.
* **Scale down** by one shard only after ``window`` consecutive samples
  with utilization below ``low_util`` and an empty queue, and never below
  what current demand needs.
* **Cooldown**: at most one fleet-size change per ``cooldown`` ticks.

The engine samples the controller at the top of ``tick()``, before
admission, and ``run_stream``'s idle jump never passes
``next_sample_tick``, so decisions land on the tick axis: a seeded trace
replays to the same scaling history, and trajectories stay bit-exact
(grows add empty shards; shrinks drain through checkpoint and restore).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Control-plane knobs (defaults are deliberately conservative)."""

    min_shards: int = 1         # floor: never drain below this
    max_shards: int = 8         # ceiling: never grow beyond this
    sample_every: int = 8       # ticks between control samples
    headroom: float = 1.25      # demand safety multiplier on scale-up
                                # (covers packing loss + arrivals between
                                # samples)
    low_util: float = 0.35      # utilization low watermark
    window: int = 3             # consecutive low samples before scale-down
    cooldown: int = 32          # min ticks between fleet-size changes

    def __post_init__(self):
        if not 1 <= self.min_shards <= self.max_shards:
            raise ValueError(
                f"need 1 <= min_shards <= max_shards; got "
                f"{self.min_shards}..{self.max_shards}")
        if self.sample_every < 1:
            raise ValueError("sample_every must be >= 1 tick")
        if self.headroom < 1.0:
            raise ValueError("headroom must be >= 1.0")
        if not 0.0 <= self.low_util <= 1.0:
            raise ValueError("low_util must be in [0, 1]")
        if self.window < 1:
            raise ValueError("window must be >= 1 sample")
        if self.cooldown < 0:
            raise ValueError("cooldown must be >= 0 ticks")


class Autoscaler:
    """Attach with ``engine.attach_controller(Autoscaler(cfg))``; the
    engine calls :meth:`maybe_sample` every tick."""

    def __init__(self, cfg: Optional[AutoscalerConfig] = None):
        self.cfg = AutoscalerConfig() if cfg is None else cfg
        #: Next tick at which the controller will sample.  run_stream's
        #: idle fast-forward caps its jumps here so sparse traces cannot
        #: leap over a scale-down decision.
        self.next_sample_tick = 0
        self.samples = 0
        #: Decision log: (tick, kind, from_shards, to_shards) — 'grow'
        #: and 'shrink' entries only; benches and tests replay it.
        self.decisions: List[Tuple[int, str, int, int]] = []
        self._low_streak = 0
        self._last_action_tick = -(10 ** 9)   # first action never blocked

    # ---------------------------------------------------------------- signals
    @staticmethod
    def _levels_left(job) -> int:
        limit = job.levels_limit or job.req.n_levels
        return max(0, limit - job.level)

    def signals(self, engine) -> dict:
        """One sample of the fleet, host-side only.

        ``demand`` in slot-levels, ``window`` in ticks (the tightest
        completion budget), ``util`` in [0, 1], ``headroom_min`` the
        worst per-request slack (window - remaining levels; negative
        means a predicted SLO miss at one level per tick).
        """
        now = engine.tick_count
        live = engine.live_shards
        capacity = sum(s.pool.n_slots for s in live)
        used = sum(s.pool.n_active for s in live)
        cps = engine.cfg.chains_per_slot

        demand = 0          # outstanding slot-levels
        windows = []        # (window ticks, remaining levels) per unit
        for shard in engine.shards:
            for job in shard.rids.jobs.values():
                left = self._levels_left(job)
                demand += len(job.slots) * left
                fd = job.req.finish_deadline
                win = (job.arrival_time + fd - now) if fd is not None \
                    else float(left)
                windows.append((win, left))
        for entry in engine.scheduler.entries:
            req = entry.req
            if entry.swapped is not None:
                left = self._levels_left(entry.swapped.job)
                slots = entry.swapped.n_slots
                job = entry.swapped.job
                fd = req.finish_deadline
                win = (job.arrival_time + fd - now) if fd is not None \
                    else float(left)
            else:
                left = req.n_levels
                slots = req.slots_needed(cps)
                fd = req.finish_deadline
                arrival, _ = engine._submit_info.get(
                    req.req_id, (float(entry.submit_tick), float("nan")))
                win = (arrival + fd - now) if fd is not None \
                    else float(left)
            demand += slots * left
            windows.append((win, left))

        window = max(1.0, min((w for w, _ in windows),
                              default=float("inf")))
        headroom_min = min((w - left for w, left in windows),
                           default=float("inf"))
        return {
            "tick": now,
            "live_shards": len(live),
            "capacity_slots": capacity,
            "used_slots": used,
            "util": used / capacity if capacity else 0.0,
            "queued": len(engine.scheduler),
            "demand_slot_levels": demand,
            "window": window,
            "headroom_min": headroom_min,
        }

    # ------------------------------------------------------------------ loop
    def maybe_sample(self, engine) -> None:
        """Engine hook: sample + act if this tick is a sampling tick."""
        if engine.tick_count < self.next_sample_tick:
            return
        self.next_sample_tick = engine.tick_count + self.cfg.sample_every
        self.samples += 1
        self._control(engine, self.signals(engine))

    def _control(self, engine, sig: dict) -> None:
        cfg = self.cfg
        now = sig["tick"]
        n_live = sig["live_shards"]
        slots_per_shard = engine.cfg.n_slots
        # Smallest fleet that clears outstanding demand inside the
        # tightest completion window at one slot-level per slot-tick.
        if math.isfinite(sig["window"]):
            need = max(cfg.min_shards, math.ceil(
                sig["demand_slot_levels"] * cfg.headroom
                / (sig["window"] * slots_per_shard)))
        else:               # no outstanding work at all
            need = cfg.min_shards
        need = min(need, cfg.max_shards)

        tel = engine.telemetry
        if tel.enabled:
            tel.decision(now, "autoscale_sample", **{
                k: v for k, v in sig.items() if k != "tick"})

        cooled = now - self._last_action_tick >= cfg.cooldown
        if need > n_live:
            self._low_streak = 0
            if cooled:
                self._act(engine, now, "grow", n_live, need)
            return
        low = (sig["util"] < cfg.low_util and sig["queued"] == 0)
        self._low_streak = self._low_streak + 1 if low else 0
        if (low and self._low_streak >= cfg.window and cooled
                and n_live > max(cfg.min_shards, need)):
            self._low_streak = 0
            self._act(engine, now, "shrink", n_live, n_live - 1)

    def _act(self, engine, tick: int, kind: str, n_from: int,
             n_to: int) -> None:
        self._last_action_tick = tick
        self.decisions.append((tick, kind, n_from, n_to))
        engine.resize(n_to)     # grow adds shards; shrink drains emptiest
        if engine.telemetry.enabled:
            engine.telemetry.decision(tick, "autoscale_" + kind,
                                      from_shards=n_from, to_shards=n_to)
