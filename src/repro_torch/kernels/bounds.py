"""Cost models of the port's kernels on one H100 SXM: the bytes each
launch must move and the time its operations take at the card's peak
rates, and from them the least time a launch can take (its bound).

Peaks are NVIDIA's H100 Tensor Core GPU data sheet's for the H100 SXM
(dense rates, full 700 W power limit): HBM3 at 3.35 TB/s, 67 TFLOP/s of
float32 outside the tensor cores, 989 TFLOP/s of bf16 in them, NVLink at
900 GB/s (450 GB/s each way).  They are the package's one set of the
card's peaks: ``chip_smoke.py`` holds each kernel against its bound, the
dry run (``launch.dryrun``) takes its roofline terms from them and
charges each launch of the SA ladder its model, and the sharding
autotuner (``distributed.autotune``) prices its steps with them.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9   # H100 SXM NVLink 4, per direction
# Hopper has 64 INT32 lanes per SM beside its 128 FP32 ones:
# 132 SMs x 64 lanes x 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# One float32 instruction per lane and cycle (an FMA counts two of the
# 67 TFLOP/s): the rate at which the SMs issue lane-instructions.
LANE_INSTR_PER_S = FP32_OPS_PER_S / 2
# Integer ops of one threefry2x32: 2 key adds, 20 rounds of add, rotate and
# xor, 5 key injections of 3 adds (csrc/rng.cuh).
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3
# Lane-instructions of one full-variant step beyond its new term: the
# changed lane's re-fold (ceil(dim / 32) adds, counted apart), five tree
# adds, f, the accept test's subtraction, division, clip and exp.
FULL_STEP_INSTR = 5 + 10
# SASS instructions of one Schwefel term (full_terms), as chip_smoke.py's
# phase 0 counts them with cuobjdump on the H100 (sm_90a).
TERM_INSTR = 105
# float32 operations of B3's O(n) exchange delta, per n.
QAP_DELTA_OPS_PER_N = 10


def _bound(nbytes: float, t_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def b1_cost(n: int, dim: int, N: int, term_instr: int = TERM_INSTR) -> dict:
    """B1 at n chains of dim coordinates and N steps, by variant: (bytes,
    seconds of operations).  Bytes: x read once, x and f written once.
    Operations: two threefry2x32 per proposal (integer lanes); for full
    also the initial evaluation (one term per coordinate) and per step
    one term, the changed lane's re-fold and the accept test (float
    lanes), a term being ``term_instr`` SASS instructions."""
    xbytes = 2 * n * dim * 4 + n * 4
    t_rng = n * N * 2 * THREEFRY_OPS / INT32_OPS_PER_S
    t_full = (n * dim * term_instr + n * N * (term_instr + -(-dim // 32) + FULL_STEP_INSTR)) \
        / LANE_INSTR_PER_S
    return {"delta": (xbytes, t_rng), "full": (xbytes, max(t_rng, t_full))}


def b1_bounds(n: int, dim: int, N: int, term_instr: int = TERM_INSTR) -> dict:
    """The least time of B1 by variant: (ms, what bounds it)."""
    return {v: _bound(*c) for v, c in b1_cost(n, dim, N, term_instr).items()}


def b2_cost(n: int):
    """B2 over n float32 values: (bytes, seconds of operations): the
    values read once; the min and its index are 8 bytes."""
    return n * 4, 0.0


def b2_bound(n: int):
    return _bound(*b2_cost(n))


def b3_cost(chains: int, n: int, n_slots: int, n_steps: int):
    """B3: p read and written once, f and the blocks' F and D; two
    threefry2x32 per move on the integer lanes plus the delta's 10 n
    float32 operations.  Returns (bytes, seconds of operations)."""
    proposals = chains * n_steps
    qbytes = 2 * chains * n * 4 + chains * 4 + 2 * n_slots * n * n * 4
    t_ops = (proposals * 2 * THREEFRY_OPS / INT32_OPS_PER_S
             + proposals * QAP_DELTA_OPS_PER_N * n / FP32_OPS_PER_S)
    return qbytes, t_ops


def b3_bound(chains: int, n: int, n_slots: int, n_steps: int):
    """The least time of B3: (ms, what bounds it)."""
    return _bound(*b3_cost(chains, n, n_slots, n_steps))
