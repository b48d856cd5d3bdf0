"""What a traced run hands the per-layer readers (``metrics/<name>.py``).

The harness fills it from its own wrappers and the profiler's trace;
each reader takes what it needs and returns a number, or None when the
run holds nothing for it to read (the metric is then left out)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from perfbench.lib.trace import Stretch


@dataclass
class Records:
    cell: str
    config: dict
    traffic: dict
    #: the profiled stretch of the window (None: no trace was taken)
    stretch: Optional[Stretch] = None
    #: host seconds of each call the harness timed, by name
    host_spans: dict = field(default_factory=dict)
    #: counts over the stretch: "levels", "chains" (per rank)
    counts: dict = field(default_factory=dict)


def matches(*parts):
    """A kernel-name predicate: any of ``parts`` is in the name."""
    return lambda name: any(p in name for p in parts)


def roofline_pct(stretch: Stretch, match, bounds_s):
    """100 x (the least time of the launches) / (their device time), or
    None when the stretch holds none of them."""
    if stretch is None or not bounds_s:
        return None
    t = stretch.device_s(match)
    if t <= 0 or stretch.count(match) != len(bounds_s):
        return None
    return 100.0 * sum(bounds_s) / t
