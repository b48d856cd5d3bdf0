"""Host milliseconds per ladder level: the harness's wall clock around
each ``core.annealing.level_step`` call, with no synchronisation, mean
over the unprofiled solves of the traced run (layer: the ladder's host
loop)."""


def read(r):
    spans = r.host_spans.get("level_step") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
