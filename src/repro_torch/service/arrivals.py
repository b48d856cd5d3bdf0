"""Arrival processes for open-loop serving, the port's copy of
``repro.service.arrivals`` (numpy only).

Open-loop serving offers requests on a timeline: the load generator does
not wait for the system, which is how serving systems are benchmarked.

Time is measured in **engine ticks**, temperature levels, the engine's
natural clock (one macro-tick advances it by the levels it consumed, so
the unit is K-invariant).  Arrival timestamps may be fractional; a
request with arrival time ``t`` becomes visible to the scheduler at the
first tick ``>= t``.  Everything here is host-side numpy and
deterministic under a fixed seed, so latency distributions are
reproducible bit for bit.

Constructors: :meth:`ArrivalProcess.poisson` (exponential gaps at
``rate`` requests/tick), :meth:`~ArrivalProcess.bursty` (groups landing
at one instant), :meth:`~ArrivalProcess.diurnal` (sinusoidal intensity),
:meth:`~ArrivalProcess.trace` (explicit timestamps) and
:meth:`~ArrivalProcess.batch` (everything at t=0, the closed-loop case).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.service.request import RequestResult, SARequest


class ArrivalProcess:
    """A time-ordered stream of ``(arrival_time, SARequest)`` pairs."""

    def __init__(self, requests: Sequence[SARequest],
                 times: Sequence[float]):
        if len(requests) != len(times):
            raise ValueError(
                f"{len(requests)} requests vs {len(times)} arrival times")
        order = np.argsort(np.asarray(times, np.float64), kind="stable")
        self._items: List[Tuple[float, SARequest]] = [
            (float(times[i]), requests[i]) for i in order]
        self._next = 0

    # ------------------------------------------------------------- factories
    @classmethod
    def poisson(cls, requests: Sequence[SARequest], rate: float,
                seed: int = 0) -> "ArrivalProcess":
        """Seeded Poisson arrivals at ``rate`` requests per engine tick."""
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / rate, size=len(requests))
        return cls(requests, np.cumsum(gaps))

    @classmethod
    def bursty(cls, requests: Sequence[SARequest], rate: float,
               burst: int = 4, seed: int = 0) -> "ArrivalProcess":
        """Seeded bursty arrivals: groups of ``burst`` requests land at one
        instant, with exponential gaps between instants scaled so the
        long-run offered load is still ``rate`` requests/tick.  The
        overload generator for admission-control tests: micro-bursts force
        transient saturation even when the mean load is sustainable.
        """
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        rng = np.random.default_rng(seed)
        n_bursts = -(-len(requests) // burst)
        starts = np.cumsum(rng.exponential(burst / rate, size=n_bursts))
        return cls(requests,
                   [float(starts[i // burst]) for i in range(len(requests))])

    @classmethod
    def diurnal(cls, requests: Sequence[SARequest], rate: float,
                period: float = 200.0, amplitude: float = 0.8,
                seed: int = 0) -> "ArrivalProcess":
        """Seeded diurnal load: an inhomogeneous Poisson process whose
        intensity swings sinusoidally around ``rate`` —
        ``lambda(t) = rate * (1 + amplitude * sin(2*pi*t/period))`` —
        the day/night envelope autoscaler benchmarks provision against
        (peak demand is ``(1+amplitude)x`` the mean, the trough
        ``(1-amplitude)x``).

        Sampled by time-warping a unit-rate Poisson process through the
        inverse cumulative intensity: with
        ``Lambda(t) = rate*t + rate*amplitude*period/(2*pi)
        * (1 - cos(2*pi*t/period))`` (non-decreasing for amplitude <= 1),
        unit-exponential cumulative sums ``s_i`` map to arrivals
        ``t_i = Lambda^{-1}(s_i)`` — inverted numerically on a fine grid,
        deterministic under ``seed``.
        """
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        if period <= 0:
            raise ValueError(f"period must be positive, got {period}")
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1], got {amplitude}")
        rng = np.random.default_rng(seed)
        s = np.cumsum(rng.exponential(1.0, size=len(requests)))
        # Grid out to where Lambda certainly exceeds the last event (the
        # trough can run as slow as rate*(1-amplitude), but Lambda over a
        # whole period always averages `rate`, so s_max/rate + one period
        # bounds the horizon), 64 points per period for interp accuracy.
        horizon = (float(s[-1]) / rate if len(s) else 1.0) + period
        grid = np.linspace(0.0, horizon,
                           max(2, int(64 * horizon / period)))
        big_l = rate * grid + (rate * amplitude * period / (2 * np.pi)
                               * (1.0 - np.cos(2 * np.pi * grid / period)))
        return cls(requests, np.interp(s, big_l, grid))

    @classmethod
    def trace(cls, requests: Sequence[SARequest],
              times: Iterable[float]) -> "ArrivalProcess":
        """Replay explicit arrival timestamps (ticks)."""
        return cls(requests, list(times))

    @classmethod
    def batch(cls, requests: Sequence[SARequest]) -> "ArrivalProcess":
        """All requests offered at t=0 — the closed-loop special case."""
        return cls(requests, [0.0] * len(requests))

    # --------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._items)

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self._items)

    @property
    def next_time(self) -> float:
        """Arrival time of the next undelivered request (inf if none)."""
        if self.exhausted:
            return float("inf")
        return self._items[self._next][0]

    def due(self, now: float) -> List[Tuple[float, SARequest]]:
        """Pop every request with ``arrival_time <= now`` (time order)."""
        out: List[Tuple[float, SARequest]] = []
        while not self.exhausted and self._items[self._next][0] <= now:
            out.append(self._items[self._next])
            self._next += 1
        return out


def percentile(values: Sequence[float], q: float) -> float:
    """np.percentile with an empty-input guard (returns nan)."""
    arr = np.asarray([v for v in values if np.isfinite(v)], np.float64)
    return float(np.percentile(arr, q)) if arr.size else float("nan")


def latency_summary(results: Sequence[RequestResult],
                    ticks: int = 0,
                    n_submitted: Optional[int] = None) -> Dict[str, float]:
    """Aggregate open-loop latency metrics over completed requests.

    Tick-clock percentiles (p50/p99 queueing delay, time-to-first-tick,
    end-to-end latency) are deterministic under a fixed arrival seed;
    goodput is completed requests per tick.  Wall-clock medians ride along
    for operators (nan when requests were submitted without wall stamps).

    Only *completed* requests enter the latency percentiles and goodput —
    a rejected request has no admission to measure; it is counted (and its
    preemptions summed) separately, so the reject policy cannot launder its
    drops into better-looking latency numbers unnoticed.

    Terminal accounting is **typed**: ``rejected`` counts only results
    whose status is the 'rejected' terminal — never a complement like
    ``len(results) - completed``, which would lump any future non-rejected
    terminal in with SLO drops.  Requests still in flight (or queued, or
    swapped out) when a ``--max-ticks`` horizon cut the run short have no
    terminal result at all; pass ``n_submitted`` (e.g.
    ``engine.n_submitted``) to surface them as ``incomplete`` instead of
    letting overload benchmarks overstate drops.
    """
    done = [r for r in results if r.completed]
    rejected = [r for r in results if r.status == "rejected"]
    qd = [r.queue_delay_ticks for r in done]
    tt = [r.ttft_ticks for r in done]
    lat = [r.latency_ticks for r in done]
    return {
        "completed": len(done),
        "rejected": len(rejected),
        "incomplete": (max(0, n_submitted - len(results))
                       if n_submitted is not None else 0),
        # Preemptions over ALL terminated requests: evicted-then-rejected
        # work is real preemption churn and must stay visible.
        "preemptions": sum(r.n_preemptions for r in results),
        "migrations": sum(r.n_migrations for r in results),
        "truncations": sum(r.n_truncations for r in results),
        "queue_delay_p50": percentile(qd, 50),
        "queue_delay_p99": percentile(qd, 99),
        "ttft_p50": percentile(tt, 50),
        "ttft_p99": percentile(tt, 99),
        "latency_p50": percentile(lat, 50),
        "latency_p99": percentile(lat, 99),
        "goodput_req_per_tick": (len(done) / ticks) if ticks else
        float("nan"),
        "queue_delay_wall_p50_s": percentile(
            [r.queue_delay_wall_s for r in done], 50),
        "latency_wall_p50_s": percentile(
            [r.latency_wall_s for r in done], 50),
    }
