"""Kernel B1, the fused Metropolis sweep: wrapper of
``csrc/metropolis_sweep.cu``.

The counterpart of ``repro.kernels.metropolis_sweep.metropolis_sweep_pallas``
with its whole control interface: per-block ``kid``, ``seed``, ``step0``,
``T``, ``chain_base`` and ``live``, and the per-chain ``t_chain``.  A block
is ``blk`` consecutive chains (a serving slot).  The padding rules and the
eager errors are the reference's.

For a CUDA tensor the wrapper launches the kernel; for a CPU tensor it
expands the per-block controls to per-chain columns and runs the plain
version, ``ref.metropolis_sweep_ref``.  One library serves every objective
and every ``(dim, n_steps, blk, variant)``: they are runtime arguments.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels import rng

VARIANTS = {"delta": 0, "full": 1}


class _Count:
    """Kernel launches on the card."""

    def __init__(self):
        self.launches = 0


counter = _Count()


def _numel(v) -> int:
    return torch.as_tensor(v).numel()


def _per_block(v, n_blocks: int, name: str):
    """None for a scalar (the kernel broadcasts it), else a validated
    (n_blocks,) array."""
    n = _numel(v)
    if n == 1:
        return None
    if n != n_blocks:
        raise ValueError(
            f"{name} has {n} entries for a {n_blocks}-block grid; "
            f"pass a scalar or one entry per chain-block")
    return v


def _scalar(v):
    return torch.as_tensor(v).reshape(-1)[0].item()


def _block_array(v, dtype, device):
    if dtype is torch.int64:  # uint32 controls travel as int32 bit patterns
        t = rng.as_u32(v, device).reshape(-1)
        return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32).contiguous()
    return torch.as_tensor(v, device=device).to(dtype).reshape(-1).contiguous()


def _prepare(x, T, seed, step0, kid, blk, variant, chain_base, live, t_chain):
    """The reference's eager checks and padding.  Returns (padded x,
    number of real chains, per-block control arrays or None)."""
    ref.validate_kid(kid)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be 'delta' or 'full', not {variant!r}")
    if x.ndim != 2 or x.shape[1] == 0 or x.dtype != torch.float32:
        raise ValueError(f"x must be (chains, dim >= 1) float32, not "
                         f"{tuple(x.shape)} {x.dtype}")
    chains, dim = x.shape
    pad = (-chains) % blk
    if pad:
        if (chain_base is not None or live is not None or t_chain is not None
                or any(_numel(v) > 1 for v in (T, seed, step0, kid))):
            raise ValueError(
                f"chains={chains} must be a multiple of blk={blk} when "
                "per-block control arrays are given")
        # Dummy chains at the origin, inside every registry box; their
        # streams use indices >= chains, so real chains are untouched.
        x = torch.cat([x, x.new_zeros((pad, dim))])
    n_blocks = (chains + pad) // blk
    ctl = {name: _per_block(v, n_blocks, name) for name, v in
           (("kid", kid), ("seed", seed), ("step0", step0), ("T", T))}
    if chain_base is not None:
        _per_block(chain_base, n_blocks, "chain_base")
    if live is not None:
        _per_block(live, n_blocks, "live")
    if t_chain is not None and _numel(t_chain) != chains:
        raise ValueError(f"t_chain has {_numel(t_chain)} entries for {chains} chains")
    return x, chains, ctl


def metropolis_sweep_kernel(x, T, seed, step0, *, kid, n_steps: int,
                            blk: int = 256, variant: str = "delta",
                            chain_base=None, live=None, t_chain=None):
    """Run an N-step Metropolis sweep for all chains of ``x`` (chains, dim)
    float32: kernel B1 for a CUDA tensor, the plain version for a CPU one.

    ``T``, ``seed``, ``step0`` and ``kid`` are scalars or one entry per
    block; ``chain_base`` and ``live`` one entry per block; ``t_chain`` one
    entry per chain.  Returns (x_out (chains, dim), f_out (chains,))."""
    if x.device.type == "cpu":
        return metropolis_sweep_plain(
            x, T, seed, step0, kid=kid, n_steps=n_steps, blk=blk,
            variant=variant, chain_base=chain_base, live=live, t_chain=t_chain)
    if x.device.type != "cuda":
        raise ValueError(f"metropolis_sweep_kernel: unsupported device {x.device}")
    xp, chains, ctl = _prepare(x, T, seed, step0, kid, blk, variant,
                               chain_base, live, t_chain)
    xo, fo = _launch(xp, T, seed, step0, kid, n_steps, blk, variant,
                     chain_base, live, t_chain, ctl)
    return xo[:chains], fo[:chains]


def metropolis_sweep_plain(x, T, seed, step0, *, kid, n_steps: int,
                           blk: int = 256, variant: str = "delta",
                           chain_base=None, live=None, t_chain=None):
    """The plain PyTorch version of :func:`metropolis_sweep_kernel`, on
    x's device: the per-block controls expand to per-chain columns for
    ``ref.metropolis_sweep_ref``."""
    x, chains, _ = _prepare(x, T, seed, step0, kid, blk, variant, chain_base,
                            live, t_chain)
    dev = x.device
    n_blocks = x.shape[0] // blk

    def expand(v, dtype):  # scalar or per-block -> per-chain
        a = (rng.as_u32(v, dev) if dtype is torch.int64
             else torch.as_tensor(v, device=dev).to(dtype)).reshape(-1)
        return a.expand(n_blocks * blk) if a.numel() == 1 else a.repeat_interleave(blk)

    lane = torch.arange(blk, device=dev).repeat(n_blocks)
    base = (torch.arange(n_blocks, device=dev) * blk if chain_base is None
            else rng.as_u32(chain_base, dev).reshape(-1))
    cidx = (base.repeat_interleave(blk) + lane) & rng.MASK32
    T_c = (expand(T, x.dtype) if t_chain is None
           else torch.as_tensor(t_chain, device=dev).to(x.dtype).reshape(-1))
    kid_c = (expand(kid, torch.int32)
             if isinstance(kid, torch.Tensor) or _numel(kid) > 1 else kid)
    xo, fo = ref.metropolis_sweep_ref(
        x, T_c, expand(seed, torch.int64), expand(step0, torch.int64),
        kid=kid_c, n_steps=n_steps, variant=variant, cidx=cidx,
        live=None if live is None else expand(live, torch.int32))
    return xo[:chains], fo[:chains]


def _launch(x, T, seed, step0, kid, n_steps, blk, variant, chain_base, live,
            t_chain, ctl):
    dev = x.device
    x = x.contiguous()
    chains, dim = x.shape
    x_out = torch.empty_like(x)
    f_out = torch.empty(chains, dtype=x.dtype, device=dev)
    keep = []  # device arrays that must outlive the launch call

    def ptr(v, dtype):
        if v is None:
            return None
        t = _block_array(v, dtype, dev)
        keep.append(t)
        return t.data_ptr()

    def scal(v, cast):
        return cast(_scalar(v)) if _numel(v) == 1 else 0

    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.sa_metropolis_sweep(
            x.data_ptr(), x_out.data_ptr(), f_out.data_ptr(),
            ptr(ctl["kid"], torch.int32), scal(kid, int),
            ptr(ctl["seed"], torch.int64), scal(seed, int) & rng.MASK32,
            ptr(ctl["step0"], torch.int64), scal(step0, int) & rng.MASK32,
            ptr(ctl["T"], torch.float32), scal(T, float),
            ptr(chain_base, torch.int64),
            ptr(live, torch.int32),
            ptr(t_chain, torch.float32),
            chains, dim, blk, n_steps, VARIANTS[variant],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "metropolis_sweep")
    counter.launches += 1
    return x_out, f_out
