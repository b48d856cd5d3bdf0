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
        if isinstance(v, torch.Tensor) and v.dtype == torch.int32 \
                and v.device == device:
            return v.reshape(-1)
        t = rng.as_u32(v, device).reshape(-1)
        return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)
    return torch.as_tensor(v, device=device).to(dtype).reshape(-1)


def control_arg(v, dtype, device, n_blocks: int, keep: list,
                by_value: bool = True):
    """A per-block control as the kernels take it: ``(pointer, value)``.

    A host scalar goes by value when ``by_value`` (pointer None); anything
    else as a contiguous ``(n_blocks,)`` device array, which ``keep``
    holds until the launch has been enqueued.  A tensor already on the
    card is never read back to the host, so a launch does not synchronise.
    ``dtype`` is the control's type; ``torch.int64`` marks a uint32 (it
    travels as an int32 bit pattern, and an int32 tensor is taken as one).
    ``v is None`` gives ``(None, 0)``."""
    if v is None:
        return None, 0
    on_card = isinstance(v, torch.Tensor) and v.device.type == "cuda"
    if by_value and not on_card and _numel(v) == 1:
        s = _scalar(v)
        if dtype is torch.int64:
            return None, int(s) & rng.MASK32
        return None, float(s) if dtype.is_floating_point else int(s)
    t = _block_array(v, dtype, device).expand(n_blocks).contiguous()
    keep.append(t)
    return t.data_ptr(), 0


def _prepare(x, T, seed, step0, kid, blk, variant, chain_base, live, t_chain,
             kid_checked=False):
    """The reference's eager checks and padding.  Returns (padded x,
    number of real chains)."""
    if not kid_checked:
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
    for name, v in (("kid", kid), ("seed", seed), ("step0", step0), ("T", T),
                    ("chain_base", chain_base), ("live", live)):
        if v is not None:
            _per_block(v, n_blocks, name)
    if t_chain is not None and _numel(t_chain) != chains:
        raise ValueError(f"t_chain has {_numel(t_chain)} entries for {chains} chains")
    return x, chains


def metropolis_sweep_kernel(x, T, seed, step0, *, kid, n_steps: int,
                            blk: int = 256, variant: str = "delta",
                            chain_base=None, live=None, t_chain=None,
                            out=None, kid_checked: bool = False):
    """Run an N-step Metropolis sweep for all chains of ``x`` (chains, dim)
    float32: kernel B1 for a CUDA tensor, the plain version for a CPU one.

    ``T``, ``seed``, ``step0`` and ``kid`` are scalars or one entry per
    block; ``chain_base`` and ``live`` one entry per block; ``t_chain`` one
    entry per chain.  ``out``, when given with ``chains % blk == 0``, is
    a (chains, dim) float32 tensor that receives the states.
    ``kid_checked=True`` skips the eager range check of ``kid`` on the
    card, which reads a kid tensor back to the host: the serving engine's
    ids come from validated requests.  Returns (x_out (chains, dim), f_out
    (chains,))."""
    if x.device.type == "cpu":
        xo, fo = metropolis_sweep_plain(
            x, T, seed, step0, kid=kid, n_steps=n_steps, blk=blk,
            variant=variant, chain_base=chain_base, live=live, t_chain=t_chain)
        return (xo if out is None else out.copy_(xo)), fo
    if x.device.type != "cuda":
        raise ValueError(f"metropolis_sweep_kernel: unsupported device {x.device}")
    xp, chains = _prepare(x, T, seed, step0, kid, blk, variant, chain_base,
                          live, t_chain, kid_checked)
    if out is not None and xp.shape[0] != chains:
        raise ValueError("out needs chains to be a multiple of blk")
    xo, fo = _launch(xp, T, seed, step0, kid, n_steps, blk, variant,
                     chain_base, live, t_chain, out)
    return xo[:chains], fo[:chains]


def metropolis_sweep_plain(x, T, seed, step0, *, kid, n_steps: int,
                           blk: int = 256, variant: str = "delta",
                           chain_base=None, live=None, t_chain=None):
    """The plain PyTorch version of :func:`metropolis_sweep_kernel`, on
    x's device: the per-block controls expand to per-chain columns for
    ``ref.metropolis_sweep_ref``."""
    x, chains = _prepare(x, T, seed, step0, kid, blk, variant, chain_base,
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
            t_chain, out):
    dev = x.device
    x = x.contiguous()
    chains, dim = x.shape
    x_out = torch.empty_like(x) if out is None else out
    if x_out.shape != x.shape or x_out.dtype != x.dtype \
            or x_out.device != dev or not x_out.is_contiguous():
        raise ValueError("out must be a contiguous float32 tensor shaped "
                         "like x on x's device")
    f_out = torch.empty(chains, dtype=x.dtype, device=dev)
    keep = []  # device arrays that must outlive the launch call

    def arg(v, dtype, by_value=True):
        return control_arg(v, dtype, dev, chains // blk, keep, by_value)

    if t_chain is None:
        t_chain_p = None
    else:
        t = torch.as_tensor(t_chain, device=dev).to(torch.float32)
        t = t.reshape(-1).contiguous()
        t_chain_p = t.data_ptr()
        keep.append(t)
    lib = _build.lib()
    with torch.cuda.device(dev):
        rc = lib.sa_metropolis_sweep(
            x.data_ptr(), x_out.data_ptr(), f_out.data_ptr(),
            *arg(kid, torch.int32), *arg(seed, torch.int64),
            *arg(step0, torch.int64), *arg(T, torch.float32),
            arg(chain_base, torch.int64, by_value=False)[0],
            arg(live, torch.int32, by_value=False)[0],
            t_chain_p, chains, dim, blk, n_steps, VARIANTS[variant],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "metropolis_sweep")
    counter.launches += 1
    return x_out, f_out
