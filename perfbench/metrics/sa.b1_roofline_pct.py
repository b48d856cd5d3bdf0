"""B1 full's share of its roofline: the least time of the profiled
launches (``costs/b1_full.py`` at the cell's chains per card, dim and N,
against the H100 SXM peaks) over their device time (layer: kernel B1).
The stretch holds whole solves: the first launch of each starts its
chains apart, every other from the champion."""
from perfbench.costs import b1_full
from perfbench.lib.peaks import least_seconds
from perfbench.lib.records import matches, roofline_pct

MATCH = matches("sweep_full")


def read(r):
    if r.stretch is None or not r.counts.get("levels"):
        return None
    c, n = r.config, r.counts["chains"]
    count = r.stretch.count(MATCH)
    solves = count // r.counts["levels"]
    apart, _ = least_seconds(b1_full.cost(n, c["dim"], c["N"], "apart"))
    champ, _ = least_seconds(b1_full.cost(n, c["dim"], c["N"], "champion"))
    return roofline_pct(r.stretch, MATCH,
                        [apart] * solves + [champ] * (count - solves))
