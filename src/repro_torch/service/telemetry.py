"""Telemetry of the serving engine: metrics registry, phase timers,
structured events.  The counterpart of ``repro.service.telemetry``.

* :class:`MetricsRegistry`: typed counters, gauges and histograms with
  labels, streaming p50/p90/p99 (exponential buckets: O(1) memory,
  deterministic), a Prometheus text exposition and a JSON snapshot.
  Per-shard series are labelled by the stable shard index, so a retired
  shard's series survive drain and resize.
* :class:`PhaseTimer` / :class:`NullPhaseTimer`: spans of the engine
  tick's phases (``schedule / admit / dispatch / device_wait /
  materialize / retire``), per shard and in aggregate, each on two clocks:
  wall time and the host thread's CPU time.  The null timer is one shared
  no-op: telemetry off allocates no span (:attr:`PhaseTimer.spans_entered`
  does not move).
* :class:`EventLog`: one-line JSON records of every scheduler and engine
  decision with tick-clock fields only, so a seeded stream replays to a
  byte-identical log (``serve_sa --events``).
* :func:`kernel_builds`: the process-wide count of ``nvcc`` builds and
  ``ctypes.CDLL`` loads of the kernel library (``kernels/_build.py``), the
  witness that telemetry builds nothing.  It stands where the reference
  counts XLA compiles through ``jax.monitoring`` (``compile_events``); the
  port compiles nothing at run time, so its metric is
  ``sa_kernel_builds_total`` in place of ``sa_jax_compile_events_total``.
  Every other metric keeps the reference's name and help string.
* ``repro_torch/spans.py``: the port's span vocabulary on the profiler's
  clock (``sa.level``, ``sa.pack``), ranges that open only while a torch
  profiler records.  The ladder and the kernels use it without importing
  this package; the tick's phases stay :class:`PhaseTimer`'s.

All of this is host-side observation: turning telemetry on touches no
state on the card, no RNG stream and no admission decision, so every
trajectory stays bit-exact.  The one change of timing is deliberate: with
telemetry on, the engine records a CUDA event after each group's launch
and waits on those events, in launch order, inside ``device_wait`` spans,
so the host's launch cost (``dispatch``) separates from the device time it
waits on.  On the CPU that span holds no wait.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels import _build

#: The engine tick's phases, in execution order:
#:   schedule     - scheduler planning (placement, migration, shrink, admit)
#:   admit        - executing the plans (checkpoint/restore, slot assignment)
#:   dispatch     - host packing, uploads and asynchronous kernel launches
#:   device_wait  - waiting on each group's CUDA event: the device time left
#:   materialize  - device-to-host copies and folding champions into jobs
#:   retire       - finish checks, result records, slot release
TICK_PHASES = ("schedule", "admit", "dispatch", "device_wait",
               "materialize", "retire")


# --------------------------------------------------------------------- metrics
class Counter:
    """Monotonic counter, optionally labelled."""

    kind = "counter"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.series: Dict[Tuple, float] = {}

    def _key(self, labelvalues: Tuple) -> Tuple:
        if len(labelvalues) != len(self.labels):
            raise ValueError(
                f"{self.name} expects labels {self.labels}, "
                f"got {labelvalues}")
        return labelvalues

    def inc(self, value: float = 1.0, *labelvalues) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labelvalues)
        self.series[key] = self.series.get(key, 0.0) + value

    def value(self, *labelvalues) -> float:
        return self.series.get(self._key(labelvalues), 0.0)

    def snapshot(self) -> dict:
        return {self._fmt(k): v for k, v in sorted(self.series.items())}

    def _fmt(self, key: Tuple) -> str:
        if not self.labels:
            return ""
        return ",".join(f"{n}={v}" for n, v in zip(self.labels, key))

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, v in sorted(self.series.items()):
            lines.append(f"{self.name}{_promlabels(self.labels, key)} {_num(v)}")
        return lines


class Gauge(Counter):
    """Point-in-time value, optionally labelled."""

    kind = "gauge"

    def set(self, value: float, *labelvalues) -> None:
        self.series[self._key(labelvalues)] = float(value)

    def inc(self, value: float = 1.0, *labelvalues) -> None:
        key = self._key(labelvalues)
        self.series[key] = self.series.get(key, 0.0) + value


class Histogram:
    """Streaming distribution: exponential buckets + count/sum/min/max.

    Quantiles are estimated by log-linear interpolation inside the bucket
    the cumulative count lands in — O(n_buckets) memory regardless of how
    many observations stream through, and fully deterministic (no
    reservoir sampling).  Bucket error is bounded by ``growth`` (default
    1.25: <= 12% relative error on any quantile), which is ample for
    localizing where milliseconds go.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (),
                 lo: float = 1e-6, hi: float = 1e3, growth: float = 1.25):
        if not (0 < lo < hi and growth > 1):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.lo, self.growth = lo, growth
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        #: bucket b spans [lo*growth^(b-1), lo*growth^b); bucket 0 is
        #: (-inf, lo); bucket n+1 is the +inf overflow.
        self.n_buckets = n + 2
        self.series: Dict[Tuple, dict] = {}

    def _state(self, labelvalues: Tuple) -> dict:
        if len(labelvalues) != len(self.labels):
            raise ValueError(
                f"{self.name} expects labels {self.labels}, "
                f"got {labelvalues}")
        st = self.series.get(labelvalues)
        if st is None:
            st = self.series[labelvalues] = {
                "buckets": [0] * self.n_buckets, "count": 0, "sum": 0.0,
                "min": float("inf"), "max": float("-inf")}
        return st

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        b = 1 + int(math.log(v / self.lo) / math.log(self.growth))
        return min(b, self.n_buckets - 1)

    def _edge(self, b: int) -> float:
        """Upper edge of bucket ``b``."""
        if b == 0:
            return self.lo
        return self.lo * self.growth ** b

    def observe(self, value: float, *labelvalues) -> None:
        st = self._state(labelvalues)
        st["buckets"][self._bucket(value)] += 1
        st["count"] += 1
        st["sum"] += value
        st["min"] = min(st["min"], value)
        st["max"] = max(st["max"], value)

    def quantile(self, q: float, *labelvalues) -> float:
        """Estimated q-quantile (q in [0, 1]); nan with no observations."""
        st = self.series.get(tuple(labelvalues))
        if st is None or not st["count"]:
            return float("nan")
        rank = q * st["count"]
        seen = 0
        for b, n in enumerate(st["buckets"]):
            if n and seen + n >= rank:
                lo_edge = self._edge(b - 1) if b else st["min"]
                hi_edge = self._edge(b)
                frac = (rank - seen) / n
                est = lo_edge + (hi_edge - lo_edge) * frac
                return float(min(max(est, st["min"]), st["max"]))
            seen += n
        return float(st["max"])

    def summary(self, *labelvalues) -> dict:
        st = self.series.get(tuple(labelvalues))
        if st is None or not st["count"]:
            return {"count": 0, "sum": 0.0}
        return {
            "count": st["count"], "sum": st["sum"],
            "min": st["min"], "max": st["max"],
            "mean": st["sum"] / st["count"],
            "p50": self.quantile(0.50, *labelvalues),
            "p90": self.quantile(0.90, *labelvalues),
            "p99": self.quantile(0.99, *labelvalues),
        }

    def snapshot(self) -> dict:
        out = {}
        for key in sorted(self.series):
            label = ",".join(f"{n}={v}" for n, v in zip(self.labels, key))
            out[label] = self.summary(*key)
        return out

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} summary"]
        for key, st in sorted(self.series.items()):
            for q in (0.5, 0.9, 0.99):
                qlabels = _promlabels(
                    self.labels + ("quantile",), key + (f"{q:g}",))
                lines.append(
                    f"{self.name}{qlabels} {_num(self.quantile(q, *key))}")
            base = _promlabels(self.labels, key)
            lines.append(f"{self.name}_sum{base} {_num(st['sum'])}")
            lines.append(f"{self.name}_count{base} {st['count']}")
        return lines


def _promlabels(names: Sequence[str], values: Tuple) -> str:
    if not names:
        return ""
    body = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + body + "}"


def _num(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return f"{v:.9g}" if isinstance(v, float) else str(v)


class MetricsRegistry:
    """Named metric store with Prometheus text + JSON export.

    Metric creation is idempotent (``counter(name)`` returns the existing
    series on a repeat call) so engine layers can declare what they need
    without coordinating.  Per-shard series carry the stable shard index
    as a label — shard retirement never deletes a series, which is how
    metrics survive drain/resize (tests assert it).
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, labels: Sequence[str], **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, labels, **kw)
        elif not isinstance(m, cls) or m.labels != tuple(labels):
            raise ValueError(f"metric {name} re-registered with a different "
                             "type or label set")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (), **kw) -> Histogram:
        return self._get(Histogram, name, help, labels, **kw)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-ready dump: name -> {kind, series} (``serve_sa --json``)."""
        return {name: {"kind": m.kind, "help": m.help,
                       "series": m.snapshot()}
                for name, m in sorted(self._metrics.items())}

    def exposition(self) -> str:
        """Prometheus text format (one scrape page)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- phase timers
class PhaseTimer:
    """Accumulates monotonic spans per (phase, shard) within one tick.

    Used as a reusable context manager::

        with timer("dispatch", shard=3):
            ...

    Spans never nest (the tick's phases are sequential), so one instance
    re-enters itself — no object allocation per span.  ``drain()`` returns
    and resets the accumulated (aggregate, per-shard, raw span, host-CPU)
    state; the engine folds it into histograms / trace events at tick end.

    Each span records **two** clocks: monotonic wall time and the host
    thread's CPU time (``time.thread_time``).  On a host core dedicated to
    the engine loop the two agree; when the host shares cores with device
    compute threads (CPU backend, oversubscribed CI runners) wall spans
    absorb whatever work the OS timesliced in, while thread-CPU counts
    only cycles the engine loop itself burned — the durable measure of
    host-side cost per phase.
    """

    #: Class-wide count of spans ever entered — the zero-overhead witness:
    #: with telemetry disabled this must not move (tests assert it).
    spans_entered = 0

    __slots__ = ("_clock", "acc", "shard_acc", "raw", "cpu_acc", "keep_raw",
                 "_phase", "_shard", "_t0", "_c0")

    def __init__(self, clock, keep_raw: bool = False):
        self._clock = clock         # monotonic epoch-relative seconds
        self.keep_raw = keep_raw    # record (phase, shard, t0, t1) spans
        self.acc: Dict[str, float] = {}
        self.shard_acc: Dict[Tuple[int, str], float] = {}
        self.raw: List[Tuple[str, Optional[int], float, float]] = []
        self.cpu_acc: Dict[str, float] = {}

    def __call__(self, phase: str, shard: Optional[int] = None):
        self._phase, self._shard = phase, shard
        return self

    def __enter__(self):
        PhaseTimer.spans_entered += 1
        self._t0 = self._clock()
        self._c0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        dc = time.thread_time() - self._c0
        t1 = self._clock()
        dt = t1 - self._t0
        self.acc[self._phase] = self.acc.get(self._phase, 0.0) + dt
        self.cpu_acc[self._phase] = self.cpu_acc.get(self._phase, 0.0) + dc
        if self._shard is not None:
            key = (self._shard, self._phase)
            self.shard_acc[key] = self.shard_acc.get(key, 0.0) + dt
        if self.keep_raw:
            self.raw.append((self._phase, self._shard, self._t0, t1))
        return False

    def drain(self):
        acc, shard_acc, raw, cpu = (self.acc, self.shard_acc, self.raw,
                                    self.cpu_acc)
        self.acc, self.shard_acc, self.raw, self.cpu_acc = {}, {}, [], {}
        return acc, shard_acc, raw, cpu


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


# ------------------------------------------------------------------ event log
class EventLog:
    """Deterministic one-line-JSON decision log.

    Every record is ``{"tick": int, "event": str, ...}`` with tick-clock
    fields only — no wall time, no object ids — so the same seeded stream
    produces byte-identical logs run-to-run (the scheduler-decision
    regression oracle).  Keys are emitted sorted; one record per line
    (JSONL, ``serve_sa --events out.jsonl``).
    """

    def __init__(self):
        self.records: List[dict] = []

    def emit(self, tick: int, event: str, **fields) -> None:
        rec = {"tick": int(tick), "event": event}
        rec.update(fields)
        self.records.append(rec)

    def lines(self) -> List[str]:
        return [json.dumps(r, sort_keys=True, separators=(",", ":"))
                for r in self.records]

    def dumps(self) -> str:
        return "\n".join(self.lines()) + ("\n" if self.records else "")

    @staticmethod
    def loads(text: str) -> List[dict]:
        """Parse a JSONL log back into records (the replay side)."""
        return [json.loads(line) for line in text.splitlines() if line]


# ------------------------------------------------------------ kernel builds
def kernel_builds() -> int:
    """Process-wide count of ``nvcc`` builds and ``ctypes.CDLL`` loads of
    the kernel library so far.  Compare before and after a run to show
    that a feature built and loaded nothing."""
    return _build.builds_and_loads


# ------------------------------------------------------------------- facade
class Telemetry:
    """The engine's observability bundle: metrics, spans, trace, events.

    Hand one to :class:`~repro_torch.service.engine.SAServeEngine`; the
    default is the module-level :data:`NULL`, whose every hook is a no-op
    (no span object, no metric, behaviour bit for bit the same).

    ``trace`` is an optional :class:`~repro_torch.service.trace.TraceBuilder`
    for per-phase spans and request lifecycles (Perfetto); ``events`` an
    optional :class:`EventLog`.  ``enabled`` also turns on the engine's
    ``device_wait`` fence on CUDA events.
    """

    enabled = True

    def __init__(self, trace=None, events: Optional[EventLog] = None):
        self.registry = MetricsRegistry()
        self.trace = trace
        self.events = events
        self.kernel_builds_start = kernel_builds()
        # Declared up front so an exposition before the first tick is
        # well-formed, and so layer code can .inc() without re-declaring.
        r = self.registry
        self.m_tick_phase = r.histogram(
            "sa_tick_phase_seconds",
            "Wall seconds per engine tick phase", ("phase",))
        self.m_shard_phase = r.counter(
            "sa_shard_phase_seconds_total",
            "Cumulative wall seconds per shard per tick phase",
            ("shard", "phase"))
        self.m_phase_cpu = r.counter(
            "sa_tick_phase_cpu_seconds_total",
            "Cumulative host-thread CPU seconds per tick phase "
            "(thread_time: excludes time the OS gave to other threads)",
            ("phase",))
        self.m_tick = r.histogram(
            "sa_tick_seconds", "Wall seconds per engine tick")
        self.m_ticks = r.counter("sa_ticks_total", "Engine ticks executed")
        self.m_queue_depth = r.gauge(
            "sa_queue_depth", "Requests waiting in the admission queue")
        self.m_active = r.gauge(
            "sa_active_requests", "Requests resident in slots")
        self.m_slot_occupancy = r.gauge(
            "sa_slot_occupancy", "Fraction of fleet slots held by tenants")
        self.m_shard_slots_used = r.gauge(
            "sa_shard_slots_used", "Slots held per shard", ("shard",))
        self.m_decisions = r.counter(
            "sa_scheduler_decisions_total",
            "Scheduler/engine lifecycle decisions", ("decision",))
        self.m_tenant_slot_ticks = r.counter(
            "sa_tenant_slot_ticks_total",
            "Slot-ticks consumed per tenant (the fairness currency)",
            ("req_id",))
        self.m_kernel_builds = r.counter(
            "sa_kernel_builds_total",
            "Kernel library builds (nvcc) and loads (ctypes.CDLL) observed "
            "since engine construction")
        self.m_launches = r.counter(
            "sa_group_launches_total", "Device-program launches")
        self.m_plans = r.counter(
            "sa_scheduler_plans_total",
            "Actions planned per scheduler planner", ("plan",))

    # -- hooks the engine calls (every one a no-op on NullTelemetry) --
    def make_phase_timer(self, clock) -> PhaseTimer:
        return PhaseTimer(clock, keep_raw=self.trace is not None)

    def decision(self, tick: int, kind: str, **fields) -> None:
        """Record one scheduler or engine decision: counter and event
        record.  (Trace instants go on the request's own async track,
        emitted by the engine.)"""
        self.m_decisions.inc(1, kind)
        if self.events is not None:
            self.events.emit(tick, kind, **fields)

    def plan(self, kind: str, n_actions: int) -> None:
        """Scheduler hook: ``n_actions`` planned by planner ``kind``."""
        self.m_plans.inc(n_actions, kind)

    def end_tick(self, tick: int, acc, shard_acc, raw, shards,
                 queue_depth: int, n_active: int, levels: int = 1,
                 cpu=None) -> None:
        """Fold one tick's drained spans and the fleet's state into the
        registry and the trace.

        ``levels`` is how many ladder levels the tick advanced (K for an
        active macro-tick, else 1), so ``sa_ticks_total`` stays equal to
        the engine's ``tick_count`` at any K.  ``cpu`` is the tick's
        host-thread CPU seconds per phase (the PhaseTimer's second
        clock)."""
        total = 0.0
        for phase, secs in acc.items():
            self.m_tick_phase.observe(secs, phase)
            total += secs
        for (shard, phase), secs in shard_acc.items():
            self.m_shard_phase.inc(secs, str(shard), phase)
        for phase, secs in (cpu or {}).items():
            self.m_phase_cpu.inc(secs, phase)
        if total:
            self.m_tick.observe(total)
        self.m_ticks.inc(levels)
        self.m_queue_depth.set(queue_depth)
        self.m_active.set(n_active)
        used = held = 0
        for s in shards:
            used += s.pool.n_active
            held += s.pool.n_slots
            self.m_shard_slots_used.set(s.pool.n_active, str(s.index))
        self.m_slot_occupancy.set(used / held if held else 0.0)
        self.m_kernel_builds.series[()] = float(
            kernel_builds() - self.kernel_builds_start)
        if self.trace is not None:
            for phase, shard, t0, t1 in raw:
                self.trace.span(phase, t0, t1, shard=shard, tick=tick)

    def tenant_slot_ticks(self, req_id: int, n_slots: int) -> None:
        self.m_tenant_slot_ticks.inc(n_slots, str(req_id))


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
