"""Chain-exchange operators for parallel SA, the counterpart of
``repro.core.exchange``: the paper's operators and, for the serving
engine, the segmented (per-request) champion exchange of plain and SOS
requests.  Parallel tempering and population annealing (the reference's
``pt_swap_segmented`` and ``pa_resample_segmented``) are not ported yet.

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

#: Per-chain workload-class codes of the serving engine (one per chain;
#: pads and plain-sync/async chains are PLAIN).
MCODE_PLAIN = 0
MCODE_SOS = 1
MCODE_PT = 2
MCODE_PA = 3


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


# ------------------------------------------------------------------ segmented
# Multi-tenant serving (service/engine.py): chains of several requests are
# packed into one batch, so the champion reduce is masked per request.
# ``seg`` gives every chain its request's segment id.

def segment_champion(x, fx, seg, num_segments: int):
    """Per-segment champion: a masked argmin over each tenant's chains.

    ``x`` is (chains, dim) float32 or int32, ``fx`` (chains,) float32 and
    ``seg`` (chains,) segment ids in [0, num_segments).  Returns (xb
    (num_segments, dim), fb (num_segments,), ib (num_segments,) int64):
    ties go to the lowest chain index, and a segment with no chains gets
    ``fb = +inf`` and ``ib = chains`` (out of range: check before use)."""
    n = fx.shape[0]
    seg = seg.long()
    fb = torch.full((num_segments,), float("inf"), dtype=fx.dtype,
                    device=fx.device).scatter_reduce(0, seg, fx, "amin")
    idx = torch.where(fx == fb[seg], torch.arange(n, device=fx.device), n)
    ib = torch.full((num_segments,), n, dtype=torch.int64,
                    device=fx.device).scatter_reduce(0, seg, idx, "amin")
    return x[torch.clamp(ib, max=n - 1)], fb, ib


def exchange_sync_segmented(x, fx, seg, num_segments: int, adopt_mask=None):
    """Paper-V2 minimum crossover per request: every chain restarts from
    its own request's champion.  ``adopt_mask`` (chains,) False keeps a
    chain untouched (async requests, free slots).

    Returns (x, fx, xb, fb)."""
    xb, fb, ib = segment_champion(x, fx, seg, num_segments)
    seg = seg.long()
    valid = (ib < fx.shape[0])[seg]
    adopt = valid if adopt_mask is None else valid & adopt_mask
    x = torch.where(adopt[:, None], xb[seg], x)
    fx = torch.where(adopt, fb[seg], fx)
    return x, fx, xb, fb


def serving_exchange(x, fx, seg, num_segments: int, adopt, mcode, T_exch,
                     seed_c, cidx, lvl_abs, live):
    """The engine's per-level exchange over a mixed batch, stages 1-2 of
    the reference's composite:

      1. the segmented champion reduce (always: it feeds best-so-far);
      2. champion adoption by ``sync`` chains (``adopt``) and by ``sos``
         chains (``mcode == MCODE_SOS``, with the counter-based uniform
         ``exchange_uniform(seed_c, SOS_SALT, cidx, lvl_abs)``).

    ``T_exch`` is each chain's schedule temperature and ``live`` masks out
    chains of finished or padded blocks.  Parallel tempering and population
    annealing chains (``MCODE_PT``, ``MCODE_PA``) are not ported yet and
    raise ``NotImplementedError``.  Returns (x, fx, xb, fb)."""
    mcode = torch.as_tensor(mcode)
    if bool((mcode >= MCODE_PT).any()):
        raise NotImplementedError(
            "parallel tempering and population annealing chains are not "
            "ported yet")
    return _serving_exchange(x, fx, seg, num_segments, adopt, mcode == MCODE_SOS,
                             T_exch, seed_c, cidx, lvl_abs, live)


def _serving_exchange(x, fx, seg, num_segments, adopt, is_sos, T_exch, seed_c,
                      cidx, lvl_abs, live, out=None):
    """:func:`serving_exchange` with the SOS mask given.  ``is_sos=None``
    means no SOS chain, so the engine need not read a mask back from the
    card; the stage is then skipped, which an all-False mask makes a
    bitwise identity anyway.  ``out``, a tensor shaped like ``x`` that does
    not overlap it, receives the states."""
    n = fx.shape[0]
    xb, fb, ib = segment_champion(x, fx, seg, num_segments)
    seg = seg.long()
    valid = (ib < n)[seg] & live
    take = adopt
    if is_sos is not None:
        u_sos = exchange_uniform(seed_c, SOS_SALT, cidx, lvl_abs)
        take = take | (is_sos & (u_sos <= sos_adopt_prob(fx, fb[seg], T_exch)))
    take = valid & take
    x = torch.where(take[:, None], xb[seg], x, out=out)
    fx = torch.where(take, fb[seg], fx)
    return x, fx, xb, fb
