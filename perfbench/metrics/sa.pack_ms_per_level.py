"""Device milliseconds per ladder level in the copy the program launches
inside its ``sa.pack`` span: the strided sweep input made contiguous for
kernel B1, under V2 the champion broadcast to every chain (layer: sweep
input pack, the V2 adoption copy).

The k-th ``sa.level`` span is matched with the k-th B1 launch.  In a level
whose span holds a ``sa.pack``, the pack is the last copy off NCCL after
the previous level's B1 and before this one's: the level's champion
update launches its copies earlier in that interval.  0.0 when the levels
pack nothing; None when the stretch holds no level span, the B1 launches
do not pair with the levels, a level that packed launched no copy, or a
level past a solve's first that did not pack still launched a copy the
pack's size (one that left the span, not the card, would read as gone).
A solve's first level samples its starts in that interval and is not
held to it."""
from perfbench.lib.peaks import HBM_BYTES_PER_S
from perfbench.lib.spans import B1, LEVEL, PACK, named
from perfbench.lib.trace import is_nccl

# Bytes an element, for the precisions the ladder runs in.
ITEMSIZE = {"float32": 4, "float64": 8}


def pack_sized_ns(r):
    """Half the least device time of a copy that writes every chain's row:
    no shorter copy can be the pack.  None when the run does not say the
    chains, the width or the precision."""
    n, dim = r.counts.get("chains"), r.config.get("dim")
    size = ITEMSIZE.get(r.config.get("dtype"))
    if not (n and dim and size):
        return None
    return 0.5e9 * n * dim * size / HBM_BYTES_PER_S


def read(r):
    s = r.stretch
    levels = named(s, LEVEL)
    if not levels:
        return None
    packs = named(s, PACK)
    b1 = [i for i, d in enumerate(s.device) if B1(d[0])]
    if len(b1) != len(levels):
        return None
    per_solve = r.counts.get("levels") or len(levels)
    least = pack_sized_ns(r)
    total = 0
    for k, (lo, hi) in enumerate(levels):
        prev = b1[k - 1] + 1 if k else 0
        copies = [d for d in s.device[prev:b1[k]]
                  if "copy" in d[0] and not is_nccl(d[0])]
        if any(lo <= a and b <= hi for a, b in packs):
            if not copies:
                return None
            total += copies[-1][2] - copies[-1][1]
        elif k % per_solve and (least is None or any(
                e - st >= least for _, st, e in copies)):
            return None
    return total / 1e6 / len(levels)
