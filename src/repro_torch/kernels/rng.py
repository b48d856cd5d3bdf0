"""Counter-based threefry2x32, the plain PyTorch counterpart of the device
function in ``csrc/rng.cuh`` (kernel B0, inlined into the sweep kernel).

Streams are indexed by (seed, global chain index, step, draw) exactly as in
the JAX package, so both packages draw the same bits.  :func:`draws3_f64`
widens the two uniforms to 53 bits for float64 chains with one more
threefry2x32 block under the same (seed, chain, step) counter.  PyTorch on the CPU
has no ``+``, ``<<``, ``>>`` or ``%`` for ``torch.uint32``, so every value
here is an ``int64`` tensor holding a uint32, masked after each add and
shift.
"""
from __future__ import annotations

import torch

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
MASK32 = 0xFFFFFFFF


def as_u32(v, device=None) -> torch.Tensor:
    """Scalar, sequence, numpy array or tensor -> int64 tensor of uint32s."""
    if isinstance(v, torch.Tensor):
        t = v.to(device=device if device is not None else v.device,
                 dtype=torch.int64)
    else:
        t = torch.as_tensor(v, device=device).to(torch.int64)
    return t & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Standard 20-round threefry2x32 on int64 tensors holding uint32
    (broadcastable).  Returns two int64 tensors of uint32s."""
    k0, k1, x0, x1 = (as_u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        for i in range(4):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, _ROT[(block * 4 + i) % 8]) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK32
    return x0, x1


def uniform_from_bits(bits):
    """uint32 bits -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def value_uniform(seed, chain_idx, step):
    """:func:`draws3`'s value uniform alone: it comes from the first of
    its two threefry2x32 blocks, so half the work gives the same bits."""
    c = as_u32(chain_idx)
    k1 = (as_u32(step) * 2) & MASK32
    _, r1 = threefry2x32(as_u32(seed), k1, c, torch.zeros_like(c))
    return uniform_from_bits(r1)


def draws3(seed, chain_idx, step):
    """The paper's three draws per Metropolis step: coordinate bits (raw
    uint32 in int64, for ``% dim``), value uniform and accept uniform.

    ``seed`` and ``step`` broadcast against ``chain_idx``; ``2 * step``
    wraps modulo 2^32 as it does in uint32 device code."""
    seed = as_u32(seed)
    c = as_u32(chain_idx)
    step = as_u32(step)
    k1 = (step * 2) & MASK32
    r0, r1 = threefry2x32(seed, k1, c, torch.zeros_like(c))
    r2, _ = threefry2x32(seed, (k1 + 1) & MASK32, c, torch.ones_like(c))
    return r0, uniform_from_bits(r1), uniform_from_bits(r2)


def uniform53(hi_bits, lo_bits):
    """Two uint32 words -> float64 uniform in [0, 1) with 53 bits: the top
    27 bits of ``hi_bits`` above the top 26 of ``lo_bits``.  Its top 24
    bits are ``uniform_from_bits(hi_bits)``'s, so the float64 draw lies in
    ``[u32, u32 + 2^-24)``."""
    v = ((hi_bits >> 5) << 26) | (lo_bits >> 6)
    return v.to(torch.float64) * (1.0 / (1 << 53))


def draws3_f64(seed, chain_idx, step):
    """:func:`draws3` for float64 chains: the same coordinate bits, and the
    value and accept uniforms widened to 53 bits.  The extra low bits come
    from the block ``threefry2x32(seed, 2 * step, chain, 2)``, a counter
    no float32 draw uses."""
    seed = as_u32(seed)
    c = as_u32(chain_idx)
    step = as_u32(step)
    k1 = (step * 2) & MASK32
    r0, r1 = threefry2x32(seed, k1, c, torch.zeros_like(c))
    r2, _ = threefry2x32(seed, (k1 + 1) & MASK32, c, torch.ones_like(c))
    w0, w1 = threefry2x32(seed, k1, c, torch.full_like(c, 2))
    return r0, uniform53(r1, w0), uniform53(r2, w1)
