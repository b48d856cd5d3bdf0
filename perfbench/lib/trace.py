"""A ``torch.profiler`` trace of one stretch of the window, reduced to
what the per-layer readers take.

The stretch runs inside a ``record_function("measured")`` span; only the
device work of launches made inside it counts, matched by correlation
id, as ``chip_smoke.profile_calls`` does (a trace loses the kernels of
launches made before it warmed).  Device time is the union of the
device's intervals; an idle gap is a stretch of the span with no device
work, named by the innermost host operation running at its middle.
NCCL's kernels spin while a rank waits, so they are kept apart: they
count as neither busy nor idle.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import Counter
from dataclasses import dataclass, field

# The host calls that put work on the card, as the trace names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
SPAN = "measured"


@dataclass
class Stretch:
    """One traced stretch: device ops (name, start_ns, end_ns) in launch
    order, host ops (name, start_ns, end_ns), the span's bounds and its
    host wall seconds."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    lo_ns: int = 0
    hi_ns: int = 0
    wall_s: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.hi_ns - self.lo_ns) / 1e9

    def ops(self, *, nccl: bool = False):
        return [d for d in self.device if is_nccl(d[0]) == nccl]

    def busy_s(self, *, nccl: bool = False) -> float:
        return union_s(self.ops(nccl=nccl))

    def device_s(self, match) -> float:
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, k: int = 10):
        c = Counter()
        for n, s, e in self.device:
            c[n[:120]] += (e - s) / 1e9
        return [[n, v] for n, v in c.most_common(k)]

    def idle_gaps(self, k: int = 10):
        """The longest idle time summed by what the host was doing."""
        busy = sorted((s, e) for n, s, e in self.device if not is_nccl(n))
        gaps, t = [], self.lo_ns
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.hi_ns > t:
            gaps.append((t, self.hi_ns))
        c = Counter()
        hosts = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        for a, b in gaps:
            mid = (a + b) // 2
            inner = None
            # The innermost op covering the middle starts last before it;
            # ops nest, so a short look back finds it.
            j = bisect.bisect_right(starts, mid)
            for n, s, e in reversed(hosts[max(0, j - 64):j]):
                if e >= mid:
                    inner = n
                    break
            c[(inner or "python")[:120]] += (b - a) / 1e9
        return [[n, v] for n, v in c.most_common(k)]


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def union_s(intervals) -> float:
    total, end = 0, None
    for _, s, e in sorted(intervals, key=lambda d: d[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


class Tracer:
    """``with tracer.stretch():`` profiles its body on the card; the
    result lands in ``tracer.result``.  Without a card it records the
    host wall only (the CPU tests)."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.result = None

    @contextlib.contextmanager
    def stretch(self):
        if not self.on_card:
            t0 = time.perf_counter()
            yield
            self.result = Stretch(wall_s=time.perf_counter() - t0)
            return
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SPAN):
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        raw = list(prof.profiler.kineto_results.events())
        span = next(e for e in raw if e.name() == SPAN)
        lo, hi = span.start_ns(), span.start_ns() + span.duration_ns()
        cpu = [e for e in raw if e.device_type() == DeviceType.CPU]
        launched = {e.correlation_id() for e in cpu
                    if e.name() in LAUNCH_CALLS and lo <= e.start_ns() <= hi}
        dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in raw if e.device_type() == DeviceType.CUDA
               and e.correlation_id() in launched]
        dev.sort(key=lambda d: d[1])
        host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in cpu if lo <= e.start_ns() <= hi
                and e.name() not in LAUNCH_CALLS and e.name() != SPAN]
        # The span ends when the host has synchronised with the last of
        # its work, so the device work lies inside it.
        self.result = Stretch(dev, host, lo, hi, wall)
