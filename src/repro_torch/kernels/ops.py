"""Entry points of the sweep kernel, the counterpart of
``repro.kernels.ops``.

``metropolis_sweep`` is the single-job sweep (chain indices
``0..chains-1``); ``metropolis_sweep_slots`` the heterogeneous-slot sweep
of the serving engine, one slot per block of ``blk`` chains, and
``qap_sweep_slots`` its permutation-family counterpart.  All run on
``cuda`` unless the caller passes ``device="cpu"``: on the card they launch
kernel B1 (B3 for QAP), on the CPU its plain version.  Nothing falls back
from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.metropolis_sweep import metropolis_sweep_kernel
from repro_torch.kernels.qap_sweep import qap_sweep_kernel


def _states(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))


def metropolis_sweep(x, T, seed, step0, *, kid, n_steps: int,
                     variant: str = "delta", blk: int = 256,
                     chain_base: int = 0, device=None):
    """N-step Metropolis sweep over all chains of ``x`` (chains, dim), row
    ``i`` drawing the streams of chain ``chain_base + i`` (a shard's slice
    of a larger job).

    Returns (x_out (chains, dim), f_out (chains,)) on ``device``."""
    x = _states(x, device)
    chains = x.shape[0]
    blk = min(blk, chains)
    if not chain_base:
        return metropolis_sweep_kernel(x, T, seed, step0, kid=kid,
                                       n_steps=n_steps, blk=blk, variant=variant)
    # Per-block bases need whole blocks: pad with dummy chains at the
    # origin, as the kernel's own padding does, and drop them after.
    pad = (-chains) % blk
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    base = chain_base + blk * torch.arange(x.shape[0] // blk, device=x.device)
    xo, fo = metropolis_sweep_kernel(x, T, seed, step0, kid=kid,
                                     n_steps=n_steps, blk=blk, variant=variant,
                                     chain_base=base)
    return xo[:chains], fo[:chains]


def metropolis_sweep_slots(x, kids, T_blocks, seeds, step0s, chain_base, *,
                           n_steps: int, blk: int, variant: str = "delta",
                           live=None, T_chain=None, device=None, out=None,
                           kid_checked: bool = False):
    """Heterogeneous-slot sweep: ``x`` is ``(n_blocks * blk, dim)`` and each
    control has one entry per slot (or one for all): objective id,
    temperature, seed, step counter and global chain-index base.  ``live``
    masks finished slots (their state passes through bit for bit);
    ``T_chain`` gives one temperature per chain instead of per slot.
    ``out`` optionally receives the states; ``kid_checked`` is
    :func:`metropolis_sweep_kernel`'s.

    Returns (x_out (n_blocks*blk, dim), f_out (n_blocks*blk,))."""
    x = _states(x, device)
    if x.shape[0] % blk:
        raise ValueError(
            f"packed chains={x.shape[0]} must be a multiple of blk={blk}")
    return metropolis_sweep_kernel(
        x, T_blocks, seeds, step0s, kid=kids, n_steps=n_steps, blk=blk,
        variant=variant, chain_base=chain_base, live=live, t_chain=T_chain,
        out=out, kid_checked=kid_checked)


def qap_sweep_slots(x, F_blocks, D_blocks, T_blocks, seeds, step0s,
                    chain_base, *, n_steps: int, blk: int, live=None,
                    device=None, out=None):
    """Heterogeneous-slot QAP pairwise-exchange sweep (permutation family).

    ``x`` is ``(n_blocks * blk, n)`` int32 packed slot states and
    ``F_blocks``/``D_blocks`` the per-slot instance operands packed
    ``(n_blocks * n, n)`` (block ``b`` reads rows ``[b*n, (b+1)*n)``) or
    one ``(n, n)`` for every slot.  The per-block controls ``T_blocks``,
    ``seeds``, ``step0s``, ``chain_base`` and ``live`` mean what they mean
    for :func:`metropolis_sweep_slots`; on the CPU they expand to
    per-chain columns for the plain version.  ``out`` optionally receives
    the permutations.

    Returns (p_out (n_blocks*blk, n) int32, f_out (n_blocks*blk,) f32)."""
    x = torch.as_tensor(x, dtype=torch.int32, device=resolve_device(device))
    return qap_sweep_kernel(
        x, F_blocks, D_blocks, T_blocks, seeds, step0s, n_steps=n_steps,
        blk=blk, chain_base=chain_base, live=live, out=out)


def kid_for(objective) -> Optional[int]:
    """Registry kernel id for an Objective, or None."""
    return getattr(objective, "kernel_id", None)
