"""Chain-exchange operators for parallel SA, the non-segmented half of
``repro.core.exchange``.

The paper's V2 restarts every chain from the champion at each temperature
level; the champion comes from kernel B2 (``argmin_reduce``), the Thrust
reduceMin of the paper's CUDA design.  No operator synchronises with the
host: champions stay 0-d device tensors.

Strategies: ``async`` (V1, no exchange until the end), ``sync`` (V2,
minimum crossover) and ``sos`` (stochastic crossover, Onbasoglu & Özdamar).
The reference draws the SOS adoption uniforms from ``jax.random``; the port
draws them from the counter-based stream ``exchange_uniform(seed,
SOS_SALT, chain, level)``, as the reference's serving engine does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import rng
from repro_torch.kernels.reduce_min import argmin_reduce

#: Salts xor-ed into a request's RNG seed so the exchange-operator draws
#: are independent of the sweep kernel's (seed, chain, step) streams.
SOS_SALT = 0x5053D1B5
PT_SALT = 0x9E3779B9
PA_SALT = 0x7F4A7C15


def exchange_uniform(seed, salt: int, idx, step):
    """One counter-based uniform per index for an exchange operator, keyed
    on ``seed ^ salt``, a logical index and the absolute ladder level."""
    _, u, _ = rng.draws3(rng.as_u32(seed) ^ salt, idx, step)
    return u


def local_champion(x, fx):
    """Best (x, f) among the chains, through kernel B2 on the card.
    Returns (x row (dim,), 0-d f)."""
    fb, i = argmin_reduce(fx)
    return x.index_select(0, i.reshape(1).long())[0], fb


def global_champion(x, fx, axis_names=None):
    """Champion across the chains.  The mesh path is not ported."""
    if axis_names:
        raise NotImplementedError(
            "global_champion over mesh axes (the sharded ladder) is not "
            "ported yet")
    return local_champion(x, fx)


def exchange_sync(x, fx, T, *, seed, lvl):
    """Paper V2: every chain restarts from the champion."""
    xb, fb = global_champion(x, fx)
    return xb.expand_as(x), fb.expand_as(fx)


def sos_adopt_prob(fx, fb, T):
    """SOS adoption probability for a chain at ``fx`` offered the champion
    ``fb`` at temperature ``T``: 1 when the champion is better by more than
    T, 1/2 at a tie, ``1 - exp(-d/T)/2`` in between."""
    d = torch.clamp(fx - fb, min=0.0)
    t = torch.clamp(torch.as_tensor(T, dtype=fx.dtype, device=fx.device),
                    min=1e-30)
    p_within = 1.0 - 0.5 * torch.exp(torch.clamp(-d / t, -80.0, 0.0))
    return torch.where(d > t, torch.ones_like(p_within), p_within)


def exchange_sos(x, fx, T, *, seed, lvl):
    """Stochastic crossover: chain c adopts the champion when
    ``exchange_uniform(seed, SOS_SALT, c, lvl) <= sos_adopt_prob``."""
    xb, fb = global_champion(x, fx)
    cidx = torch.arange(fx.shape[0], device=fx.device)
    u = exchange_uniform(seed, SOS_SALT, cidx, lvl)
    adopt = u <= sos_adopt_prob(fx, fb, T)
    x = torch.where(adopt[:, None], xb[None, :], x)
    fx = torch.where(adopt, fb, fx)
    return x, fx


def exchange_none(x, fx, T, *, seed, lvl):
    return x, fx


EXCHANGES = {
    "async": exchange_none,
    "sync": exchange_sync,
    "sos": exchange_sos,
}
