"""Kernel B2, the block (min, argmin) reduction, and its plain version.

The counterpart of ``repro.kernels.reduce_min`` (the paper's V1/V2
champion selection, a Thrust reduceMin).  ``argmin_reduce`` launches
``csrc/reduce_min.cu`` for a CUDA tensor and runs ``argmin_reduce_plain``
for a CPU tensor.  Ties go to the lowest index and a NaN wins as the first
NaN, as ``jnp.argmin`` does.  Any ``n >= 1`` is taken, at any start
address, so a champion reduce on the card never falls back to another
path.

The kernel is one launch per reduction: one CTA up to ``ONE_CTA_MAX``
values, a grid whose last CTA folds the tiles above it.  Its scratch (the
tile pairs and the grid's ticket) is allocated once per device and stream
and reused, so a call allocates nothing but its two outputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Count:
    """Reductions launched on the card (wrapper calls, not CUDA launches)."""

    def __init__(self):
        self.launches = 0


counter = _Count()

# Up to this many values one CTA reads the whole vector; above it a grid
# does.  chip_smoke phase 6 times both routes: on the H100 they cross
# between 24576 and 32768 float32 values.
ONE_CTA_MAX = 24576
_TILES = 264                   # tile pairs: two CTAs on each of 132 SMs
_scratch = {}                  # (device index, stream) -> int32 scratch


def _check_input(f):
    if f.ndim != 1 or f.numel() == 0:
        raise ValueError(f"argmin_reduce takes a non-empty 1-D tensor, not {tuple(f.shape)}")
    if f.dtype not in _DTYPES:
        raise TypeError(f"argmin_reduce takes float32 or bfloat16, not {f.dtype}")


def argmin_reduce_plain(f, *, blk: int = 1024):
    """Plain PyTorch (min, first argmin) of ``f``, per tile then across
    tiles.  Returns (0-d value of f's dtype, 0-d int32 index)."""
    _check_input(f)
    n = f.numel()
    pad = (-n) % blk
    tiles = torch.cat([f, f.new_full((pad,), float("inf"))]).view(-1, blk)
    idx = torch.arange(n + pad, device=f.device, dtype=torch.int32).view(-1, blk)

    def first_min(v, i):  # (rows, k) -> per-row (min, first index)
        m = v.amin(1)     # NaN-propagating
        hit = (v == m[:, None]) | (v.isnan() & m.isnan()[:, None])
        return m, torch.where(hit, i, n + pad).amin(1)

    m, i = first_min(tiles, idx)
    m, i = first_min(m[None, :], i[None, :])
    return m[0], i[0].to(torch.int32)


def argmin_reduce(f, *, blk: int = 1024):
    """(min value, first argmin index) of a 1-D float32/bf16 tensor.

    A CUDA tensor goes through kernel B2; a CPU tensor through the plain
    version, which reduces per tile of ``blk`` values, then across tiles.
    The kernel takes ``blk`` and ignores it: its result does not depend on
    a tiling.  Returns 0-d tensors on f's device: no host
    synchronisation."""
    _check_input(f)
    if f.device.type == "cpu":
        return argmin_reduce_plain(f, blk=blk)
    if f.device.type != "cuda":
        raise ValueError(f"argmin_reduce: unsupported device {f.device}")
    if blk <= 0:
        raise ValueError(f"blk must be positive, not {blk}")
    f = f.contiguous()
    dev = f.device
    out_val = torch.empty((), dtype=f.dtype, device=dev)
    out_idx = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.lib()
    if dev.index == torch.cuda.current_device():
        rc = _launch(lib, f, out_val, out_idx)
    else:
        with torch.cuda.device(dev):
            rc = _launch(lib, f, out_val, out_idx)
    _build.check(rc, "argmin_reduce")
    counter.launches += 1
    return out_val, out_idx


def _launch(lib, f, out_val, out_idx):
    stream = torch.cuda.current_stream(f.device).cuda_stream
    scratch = _scratch.get((f.device.index, stream))
    if scratch is None:   # the ticket, then the tile pairs; the ticket stays 0
        scratch = torch.zeros(1 + 2 * _TILES, dtype=torch.int32, device=f.device)
        _scratch[(f.device.index, stream)] = scratch
    return lib.sa_argmin_reduce(
        f.data_ptr(), _DTYPES[f.dtype], f.numel(), ONE_CTA_MAX,
        scratch.data_ptr(), _TILES, out_val.data_ptr(), out_idx.data_ptr(), stream)
