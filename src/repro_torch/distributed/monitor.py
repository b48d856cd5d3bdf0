"""Straggler / liveness monitoring for long-running training jobs, the
port's own copy of ``repro.distributed.monitor`` (pure Python).

On a real multi-pod deployment every host runs a ``Heartbeat`` thread that
appends (host, step, t) records to shared storage; the lead host's
``StragglerMonitor`` flags hosts whose step-time z-score exceeds a threshold
(slow HBM, thermal throttling, failing NIC) so the orchestrator can
drain+replace them before they stall the synchronous collective.  In this
single-process container the same code paths run with host_count=1 and are
unit-tested with synthetic timings.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class StepTimer:
    """EWMA step timing with deadline detection (single host)."""
    alpha: float = 0.1
    deadline_factor: float = 3.0
    _ewma: Optional[float] = None
    _last: Optional[float] = None

    def start(self):
        self._last = time.monotonic()

    def stop(self) -> float:
        dt = time.monotonic() - self._last
        self._ewma = dt if self._ewma is None else \
            (1 - self.alpha) * self._ewma + self.alpha * dt
        return dt

    @property
    def mean(self) -> Optional[float]:
        return self._ewma

    def exceeded_deadline(self, elapsed: float) -> bool:
        """True if an in-flight step has run deadline_factor × EWMA."""
        return self._ewma is not None and elapsed > self.deadline_factor * self._ewma


class Heartbeat:
    """Append-only heartbeat file per host (shared FS / object store)."""

    def __init__(self, root: str | Path, host: int):
        self.path = Path(root) / f"heartbeat_{host:05d}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.host = host

    def beat(self, step: int, step_time: float):
        with self.path.open("a") as f:
            f.write(json.dumps({"host": self.host, "step": step,
                                "t": time.time(), "dt": step_time}) + "\n")


class StragglerMonitor:
    """Lead-host view: per-host step-time stats, straggler + dead detection."""

    def __init__(self, window: int = 32, zscore: float = 3.0,
                 dead_after_s: float = 120.0):
        self.window = window
        self.zscore = zscore
        self.dead_after_s = dead_after_s
        self.times: dict[int, deque] = defaultdict(lambda: deque(maxlen=window))
        self.last_seen: dict[int, float] = {}

    def record(self, host: int, step_time: float, now: Optional[float] = None):
        self.times[host].append(step_time)
        self.last_seen[host] = now if now is not None else time.time()

    def ingest(self, root: str | Path):
        for p in Path(root).glob("heartbeat_*.jsonl"):
            for line in p.read_text().splitlines():
                r = json.loads(line)
                self.record(r["host"], r["dt"], r["t"])

    def stragglers(self) -> list[int]:
        """Hosts whose mean step time is a z-score outlier vs the fleet."""
        import numpy as np
        means = {h: float(np.mean(t)) for h, t in self.times.items() if t}
        if len(means) < 3:
            return []
        vals = np.array(list(means.values()))
        mu, sd = vals.mean(), vals.std() + 1e-9
        return [h for h, m in means.items() if (m - mu) / sd > self.zscore]

    def dead(self, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.time()
        return [h for h, t in self.last_seen.items()
                if now - t > self.dead_after_s]
