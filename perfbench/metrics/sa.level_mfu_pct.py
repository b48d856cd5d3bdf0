"""The whole level's share of the card's peak: the least time of one
level's counted work (``costs/sa_level.py``: B1 full from the champion
and one B2 champion) over the profiled wall per level (layer: the
level)."""
from perfbench.costs import sa_level
from perfbench.lib.peaks import least_seconds


def read(r):
    s, levels = r.stretch, r.counts.get("levels")
    if s is None or not levels or not s.device:
        return None
    c = r.config
    t, _ = least_seconds(sa_level.cost(r.counts["chains"], c["dim"], c["N"]))
    return 100.0 * t * levels / s.wall_s
