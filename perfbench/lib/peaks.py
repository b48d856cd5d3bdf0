"""Peaks of one NVIDIA H100 SXM, from NVIDIA's H100 Tensor Core GPU data
sheet (dense rates, 700 W power limit), and the least time a counted
piece of work can take on it.

A card set below 700 W runs slower under load, so every share the
readers report is printed beside the card's power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # HBM3
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
# Integer lanes: 64 INT32 lanes per SM beside the 128 FP32 ones,
# 132 SMs at the 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def least_seconds(cost: dict):
    """(seconds, what bounds it) of a cost ``{"bytes", "flops",
    "int_ops"}``: the larger of its bytes over the HBM rate, its float32
    operations over the float32 rate and its integer operations over the
    integer rate (separate pipes, so they overlap)."""
    parts = {"bytes": cost.get("bytes", 0) / HBM_BYTES_PER_S,
             "flops": cost.get("flops", 0) / FP32_OPS_PER_S,
             "int_ops": cost.get("int_ops", 0) / INT32_OPS_PER_S}
    kind = max(parts, key=parts.get)
    return parts[kind], kind


def add(*costs) -> dict:
    out = {"bytes": 0, "flops": 0, "int_ops": 0}
    for c in costs:
        for k in out:
            out[k] += c.get(k, 0)
    return out
