"""Entry points of the sweep kernel, the counterpart of
``repro.kernels.ops``.

``metropolis_sweep`` is the single-job sweep (chain indices
``0..chains-1``); ``metropolis_sweep_slots`` the heterogeneous-slot sweep
of the serving engine, one slot per block of ``blk`` chains.  Both run on
``cuda`` unless the caller passes ``device="cpu"``: on the card they launch
kernel B1, on the CPU its plain version.  Nothing falls back from one to
the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.metropolis_sweep import metropolis_sweep_kernel


def _states(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))


def metropolis_sweep(x, T, seed, step0, *, kid, n_steps: int,
                     variant: str = "delta", blk: int = 256, device=None):
    """N-step Metropolis sweep over all chains of ``x`` (chains, dim).

    Returns (x_out (chains, dim), f_out (chains,)) on ``device``."""
    x = _states(x, device)
    return metropolis_sweep_kernel(
        x, T, seed, step0, kid=kid, n_steps=n_steps,
        blk=min(blk, x.shape[0]), variant=variant)


def metropolis_sweep_slots(x, kids, T_blocks, seeds, step0s, chain_base, *,
                           n_steps: int, blk: int, variant: str = "delta",
                           live=None, T_chain=None, device=None):
    """Heterogeneous-slot sweep: ``x`` is ``(n_blocks * blk, dim)`` and each
    control has one entry per slot (or one for all): objective id,
    temperature, seed, step counter and global chain-index base.  ``live``
    masks finished slots (their state passes through bit for bit);
    ``T_chain`` gives one temperature per chain instead of per slot.

    Returns (x_out (n_blocks*blk, dim), f_out (n_blocks*blk,))."""
    x = _states(x, device)
    if x.shape[0] % blk:
        raise ValueError(
            f"packed chains={x.shape[0]} must be a multiple of blk={blk}")
    return metropolis_sweep_kernel(
        x, T_blocks, seeds, step0s, kid=kids, n_steps=n_steps, blk=blk,
        variant=variant, chain_base=chain_base, live=live, t_chain=T_chain)


def kid_for(objective) -> Optional[int]:
    """Registry kernel id for an Objective, or None."""
    return getattr(objective, "kernel_id", None)
