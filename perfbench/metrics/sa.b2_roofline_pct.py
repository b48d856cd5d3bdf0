"""B2's share of its roofline: each profiled champion reduction over the
card's chains (``costs/b2.py``) against its device time (layer: kernel
B2).  Every B2 launch of the ladder reduces the card's chains (the final
reduce one more)."""
from perfbench.costs import b2
from perfbench.lib.peaks import least_seconds
from perfbench.lib.records import matches, roofline_pct

MATCH = matches("argmin_kernel")


def read(r):
    if r.stretch is None:
        return None
    t, _ = least_seconds(b2.cost(r.counts["chains"]))
    return roofline_pct(r.stretch, MATCH, [t] * r.stretch.count(MATCH))
