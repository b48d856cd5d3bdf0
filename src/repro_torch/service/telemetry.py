"""Telemetry of the serving engine, off: the part of
``repro.service.telemetry`` that the engine and the scheduler call when
observability is disabled.

Every hook is a no-op and nothing is allocated, so the engine's spans and
the scheduler's plan counters cost nothing.  The enabled bundle (metrics
registry, phase timer, event log, trace) is not ported yet.
"""
from __future__ import annotations


class NullPhaseTimer:
    """No-op spans: one shared instance, no state, no allocation."""

    __slots__ = ()

    def __call__(self, phase, shard=None):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drain(self):
        return {}, {}, [], {}


NULL_PHASE_TIMER = NullPhaseTimer()


class NullTelemetry:
    """Telemetry off: every hook is a no-op, nothing is allocated."""

    enabled = False
    trace = None
    events = None
    registry = None

    __slots__ = ()

    def make_phase_timer(self, clock):
        return NULL_PHASE_TIMER

    def decision(self, tick, kind, **fields):
        pass

    def plan(self, kind, n_actions):
        pass

    def end_tick(self, tick, acc, shard_acc, raw, shards, queue_depth,
                 n_active, levels=1, cpu=None):
        pass

    def tenant_slot_ticks(self, req_id, n_slots):
        pass


#: The default for every engine: observability off, zero overhead.
NULL = NullTelemetry()
