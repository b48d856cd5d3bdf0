"""Device milliseconds per level in NCCL's kernels on rank 0: the
champion all-gather of ``core/exchange.py::gather_champion``.  NCCL's
kernels spin while a rank waits for the others, so this is time in, or
waiting at, the all-gather (layer: exchange across ranks)."""
from perfbench.lib.trace import is_nccl


def read(r):
    s = r.stretch
    if s is None or not r.counts.get("levels") or not s.count(is_nccl):
        return None
    return 1e3 * s.device_s(is_nccl) / r.counts["levels"]
