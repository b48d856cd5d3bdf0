"""Share of the profiled stretch of the ladder in which the card ran no
operation; NCCL's kernels, which spin while a rank waits, count as
neither busy nor idle (layer: device)."""


def read(r):
    s = r.stretch
    if s is None or not s.device or s.window_s <= 0:
        return None
    span = s.window_s - s.busy_s(nccl=True)
    return 100.0 * (1.0 - s.busy_s() / span) if span > 0 else None
