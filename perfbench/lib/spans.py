"""The program's own spans in a traced stretch: the profiler ranges of
``repro_torch/spans.py`` land among the stretch's host events, on the
device's clock.  A stretch keeps no correlation ids, so a reader
ties a span to the device work it launched by order alone."""
from __future__ import annotations

from perfbench.lib.cells import load_module

LEVEL = "sa.level"
PACK = "sa.pack"
# Kernel B1 as ``metrics/sa.b1_roofline_pct.py`` matches it, one
# definition for both readers: one launch a level on the kernel route.
B1 = load_module("metrics", "sa.b1_roofline_pct").MATCH


def named(stretch, name: str) -> list:
    """(start_ns, end_ns) of the host events called ``name``, in order."""
    if stretch is None:
        return []
    return sorted((s, e) for n, s, e in stretch.host if n == name)
