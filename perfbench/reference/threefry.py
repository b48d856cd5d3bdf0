"""Counter-based threefry2x32 (Random123, 20 rounds) on int64 tensors
holding uint32 values, and the three draws of one Metropolis step.

The stream of chain ``c`` at step ``s`` under seed ``k``: block A is
``threefry2x32(key=(k, 2s), counter=(c, 0))`` and block B
``threefry2x32(key=(k, 2s + 1), counter=(c, 1))``.  The coordinate bits
are A's first word, the value uniform the top 24 bits of A's second word
and the accept uniform the top 24 bits of B's first word, each over
2^24.  ``2s`` wraps modulo 2^32.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def u32(v, device=None) -> torch.Tensor:
    """Any integer input as an int64 tensor of uint32 values."""
    t = torch.as_tensor(v, device=device)
    return t.to(torch.int64) & MASK32


def threefry2x32(k0, k1, x0, x1):
    k0, k1, x0, x1 = (u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for r in range(20):
        x0 = (x0 + x1) & MASK32
        rot = _ROT[r % 8]
        x1 = (((x1 << rot) | (x1 >> (32 - rot))) & MASK32) ^ x0
        if r % 4 == 3:
            i = r // 4
            x0 = (x0 + ks[(i + 1) % 3]) & MASK32
            x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def to_uniform(bits) -> torch.Tensor:
    """float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def step_draws(seed, cidx, step):
    """(coordinate bits int64, value uniform float32, accept uniform
    float32) of every chain in ``cidx`` at ``step``."""
    seed, cidx, step = u32(seed), u32(cidx), u32(step)
    key1 = (2 * step) & MASK32
    a0, a1 = threefry2x32(seed, key1, cidx, torch.zeros_like(cidx))
    b0, _ = threefry2x32(seed, (key1 + 1) & MASK32, cidx,
                         torch.ones_like(cidx))
    return a0, to_uniform(a1), to_uniform(b0)
