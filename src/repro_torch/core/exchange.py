"""Chain-exchange operators for parallel SA, the counterpart of
``repro.core.exchange``: the paper's operators and, for the serving
engine, the segmented (per-request) exchange of every workload class:
champion adoption for plain and SOS requests, the parallel-tempering
swap pass (``pt_swap_segmented``) and population-annealing resampling
(``pa_resample_segmented``).

The paper's V2 restarts every chain from the champion at each temperature
level.  A float32 champion comes from kernel B2 (``argmin_reduce``), the
Thrust reduceMin of the paper's CUDA design; B2 takes no float64, and a
float64 champion comes from ``torch.argmin``, whose ties go to the first
index as ``jnp.argmin``'s do.  The route is chosen by dtype, never by a
kernel failing.  No operator synchronises with the host: champions stay
0-d device tensors.

Strategies: ``async`` (V1, no exchange until the end), ``sync`` (V2,
minimum crossover) and ``sos`` (stochastic crossover, Onbasoglu & Özdamar).
The reference draws the SOS adoption uniforms from ``jax.random``; the port
draws them from the counter-based stream ``exchange_uniform(seed,
SOS_SALT, chain, level)``, as the reference's serving engine does.

Over a mesh (the sharded ladder, ``launch/mesh.py``) each rank holds a
contiguous slice of the chains, and the champion is the reference's
hierarchical one: each rank's first argmin, then one all-gather of the
``(f, x)`` pairs over the mesh dims, then the first argmin over shards, so
ties go to the lowest shard and, within it, to the lowest chain: the
unsharded order.  Only ``shards x (dim + 1)`` values cross ranks.  The SOS
uniforms key on global chain indices (``chain_base`` + local index).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels import rng
from repro_torch.kernels.reduce_min import argmin_reduce
from repro_torch.launch.mesh import axis_group, require_group

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

#: Fixed-point scale of the PA resampling weights.  Integer prefix sums
#: are exact and associative, so a tenant's inverse-CDF lookup does not
#: depend on which rows of a packed batch it occupies.
PA_WEIGHT_SCALE = 65536.0


def exchange_uniform(seed, salt: int, idx, step):
    """One counter-based uniform per index for an exchange operator, keyed
    on ``seed ^ salt``, a logical index and the absolute ladder level:
    ``rng.draws3``'s value uniform."""
    return rng.value_uniform(rng.as_u32(seed) ^ salt, idx, step)


def _exchange_uniforms(seed_c, lvl_abs, keys):
    """:func:`exchange_uniform` for several ``(salt, idx)`` keys over the
    same chains, in one threefry2x32 pass over their concatenation (the
    same bits: the draw is elementwise).  Returns one (chains,) uniform
    per key."""
    n = lvl_abs.shape[0]
    seed = rng.as_u32(seed_c).expand(n)
    u = rng.value_uniform(torch.cat([seed ^ salt for salt, _ in keys]),
                          torch.cat([rng.as_u32(i).expand(n) for _, i in keys]),
                          rng.as_u32(lvl_abs).repeat(len(keys)))
    return list(u.split(n))


def champion_index(fx):
    """(0-d min, 0-d first argmin) of ``fx``: kernel B2 for float32 (its
    plain version on the CPU), ``torch.argmin`` for float64."""
    if fx.dtype == torch.float64:
        i = torch.argmin(fx)
        return fx[i], i
    return argmin_reduce(fx)


def local_champion(x, fx):
    """Best (x, f) among the chains.  Returns (x row (dim,), 0-d f)."""
    fb, i = champion_index(fx)
    return x.index_select(0, i.reshape(1).long())[0], fb


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's place in a sharded ladder, resolved once per ladder: the
    process group over the mesh dims its chains are cut along and the
    rows of an all-gather over it that form its shards, in shard order
    (``launch.mesh.axis_group``), and the global index of its first
    chain."""

    group: object
    rows: tuple
    chain_base: int = 0

    @classmethod
    def over(cls, mesh, axis_names, chain_base: int = 0) -> "Shard":
        require_group()
        if mesh is None:
            raise TypeError("axis_names needs mesh= (launch.mesh.make_mesh)")
        group, rows = axis_group(mesh, axis_names)
        return cls(group, tuple(rows), chain_base)


def gather_shards(t, shard: Shard):
    """Every shard's copy of the 1-D tensor ``t``: one
    ``all_gather_into_tensor`` over the shard's group.  Returns (shards,
    t.numel()), row ``s`` from the rank at shard coordinate ``s``."""
    n = dist.get_world_size(shard.group)
    out = t.new_empty(n * t.numel())
    dist.all_gather_into_tensor(out, t.contiguous(), group=shard.group)
    out = out.view(n, -1)
    return out if shard.rows == tuple(range(n)) else out[list(shard.rows)]


def gather_champion(xb, fb, shard: Shard):
    """The champion over shards of each rank's champion ``(xb (dim,), fb
    0-d)``: the first argmin over the gathered values, the same on every
    rank."""
    packed = gather_shards(torch.cat([fb.reshape(1).to(xb.dtype), xb]), shard)
    j = torch.argmin(packed[:, 0]).reshape(1)
    row = packed.index_select(0, j)[0]
    return row[1:], row[0].to(fb.dtype)


def global_champion(x, fx, axis_names=None, mesh=None):
    """Champion across the chains and, with ``axis_names``, across the
    shards of ``mesh`` along those dims.  Returns (x row (dim,), 0-d f)."""
    return _champion(x, fx, Shard.over(mesh, axis_names) if axis_names else None)


def _champion(x, fx, shard):
    xb, fb = local_champion(x, fx)
    return (xb, fb) if shard is None else gather_champion(xb, fb, shard)


def exchange_sync(x, fx, T, *, seed, lvl, shard=None):
    """Paper V2: every chain restarts from the champion (over the shards
    of ``shard``, a :class:`Shard`, when given)."""
    xb, fb = _champion(x, fx, shard)
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


def exchange_sos(x, fx, T, *, seed, lvl, shard=None):
    """Stochastic crossover: chain c adopts the champion when
    ``exchange_uniform(seed, SOS_SALT, c, lvl) <= sos_adopt_prob``; with
    ``shard``, local chain i is global chain ``shard.chain_base + i``."""
    xb, fb = _champion(x, fx, shard)
    cidx = torch.arange(fx.shape[0], device=fx.device)
    if shard is not None:
        cidx = cidx + shard.chain_base
    u = exchange_uniform(seed, SOS_SALT, cidx, lvl)
    adopt = u <= sos_adopt_prob(fx, fb, T)
    x = torch.where(adopt[:, None], xb[None, :], x)
    fx = torch.where(adopt, fb, fx)
    return x, fx


def exchange_none(x, fx, T, *, seed, lvl, shard=None):
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


def pt_swap_mask(fx, t_rung, partner, is_pt, u):
    """Which rows of one even/odd parallel-tempering pass swap.

    Each chain of a PT request holds one rung of its request's ladder;
    ``partner`` is the packed row of its swap partner at this parity (its
    own row: no swap proposed).  ``u`` is the pair's uniform,
    ``exchange_uniform(seed_c, PT_SALT, pairlo, lvl_abs)`` keyed on the
    lower logical rung ``pairlo`` of the pair, so both partners draw the
    same one and the decision is symmetric.  A pair swaps when
    ``u < exp(clip((beta - beta_partner)(f - f_partner), -80, 0))``.
    Returns (swap (chains,) bool, partner as int64)."""
    partner = partner.long()
    beta = 1.0 / torch.clamp(t_rung, min=1e-30)
    log_a = (beta - beta[partner]) * (fx - fx[partner])
    accept = u < torch.exp(torch.clamp(log_a, -80.0, 0.0))
    rows = torch.arange(fx.shape[0], device=fx.device)
    return is_pt & (partner != rows) & accept, partner


def pt_swap_segmented(x, fx, t_rung, partner, is_pt, u, out=None):
    """One even/odd parallel-tempering swap pass (:func:`pt_swap_mask`):
    swapping pairs exchange states, and the rung temperatures stay put.
    Rows outside ``is_pt`` pass through bit for bit.  Both rows gather
    from the pre-swap arrays: ``x[partner]`` is copied before ``out``
    (which may be ``x`` itself) is written.  Returns (x, fx, swap)."""
    swap, partner = pt_swap_mask(fx, t_rung, partner, is_pt, u)
    fp = fx[partner]
    x = torch.where(swap[:, None], x[partner], x, out=out)
    return x, torch.where(swap, fp, fx), swap


def pa_weights(fx, fb_seg, seg, dbeta_c, is_pa):
    """PA resampling weights ``exp(-dbeta (f - f_champion))`` quantized to
    ``floor(w * PA_WEIGHT_SCALE)`` int32; rows outside ``is_pa`` weigh 0
    (a pad segment's +inf champion makes their exponent NaN)."""
    d = fx - fb_seg[seg.long()]
    w = torch.exp(torch.clamp(-dbeta_c * d, -80.0, 0.0))
    return torch.where(is_pa, (w * PA_WEIGHT_SCALE).to(torch.int32), 0)


def pa_ancestors(fx, fb_seg, seg, seg_lo, seg_hi, dbeta_c, is_pa, u):
    """The ancestor row each PA chain draws from its own request's rows
    ``[seg_lo, seg_hi)`` with the :func:`pa_weights` weights and its
    uniform ``u``, ``exchange_uniform(seed_c, PA_SALT, cidx, lvl_abs)``.

    The reference takes one int32 prefix sum over the packed group;
    ``torch.cumsum`` into int64 equals it wherever the reference's does
    not wrap past 2^31 - 1 (a group of 32768 or more PA chains at high T
    can).  ``floor(u * tot)`` rounds in float32, as the reference's does.
    Returns (anc (chains,) int64, take (chains,) bool)."""
    seg_lo = seg_lo.long()
    seg_hi = seg_hi.long()
    wq = pa_weights(fx, fb_seg, seg, dbeta_c, is_pa)
    cum = torch.cat([wq.new_zeros(1, dtype=torch.int64),
                     torch.cumsum(wq, 0, dtype=torch.int64)])
    tot = cum[seg_hi] - cum[seg_lo]
    off = torch.floor(u * tot.to(fx.dtype)).to(torch.int64)
    off = torch.minimum(torch.clamp(off, min=0), torch.clamp(tot - 1, min=0))
    anc = torch.searchsorted(cum, cum[seg_lo] + off, right=True) - 1
    anc = torch.minimum(torch.maximum(anc, seg_lo),
                        torch.maximum(seg_hi - 1, seg_lo))
    return anc, is_pa & (tot > 0)


def pa_resample_segmented(x, fx, fb_seg, seg, seg_lo, seg_hi, dbeta_c, is_pa,
                          u, out=None):
    """Population-annealing resampling at a temperature-level transition:
    each PA chain takes the state of the ancestor :func:`pa_ancestors`
    draws for it, against its segment's champion ``fb_seg`` (taken before
    the resample).  Rows outside ``is_pa`` pass through bit for bit;
    ``x[anc]`` is copied before ``out`` (which may be ``x``) is written.
    Returns (x, fx, anc, take)."""
    anc, take = pa_ancestors(fx, fb_seg, seg, seg_lo, seg_hi, dbeta_c, is_pa,
                             u)
    x = torch.where(take[:, None], x[anc], x, out=out)
    return x, torch.where(take, fx[anc], fx), anc, take


def serving_exchange(x, fx, seg, num_segments, adopt, mcode, t_rung, T_exch,
                     partner, pairlo, seg_lo, seg_hi, dbeta_c, seed_c, cidx,
                     lvl_abs, live):
    """The engine's composite per-level exchange over a mixed-class batch,
    the reference's four stages, each masked so that an all-False mask is
    a bitwise identity for the other tenants:

      1. the segmented champion reduce (always: it feeds best-so-far);
      2. champion adoption by ``sync`` chains (``adopt``) and by ``sos``
         chains (``mcode == MCODE_SOS``, with the counter-based uniform
         ``exchange_uniform(seed_c, SOS_SALT, cidx, lvl_abs)``);
      3. the parallel-tempering swap pass (``MCODE_PT`` chains);
      4. population-annealing resampling (``MCODE_PA`` chains), weighted
         against stage 1's champions.

    ``T_exch`` is each chain's schedule temperature, ``cidx`` its logical
    chain index and ``live`` masks out chains of finished or padded
    blocks.  Returns (x, fx, xb, fb)."""
    mcode = torch.as_tensor(mcode, device=fx.device)
    return _serving_exchange(
        x, fx, seg, num_segments, adopt, mcode == MCODE_SOS, T_exch, seed_c,
        cidx, lvl_abs, live,
        pt=(t_rung, partner, pairlo, (mcode == MCODE_PT) & live),
        pa=(seg_lo, seg_hi, dbeta_c, (mcode == MCODE_PA) & live))


def _serving_exchange(x, fx, seg, num_segments, adopt, is_sos, T_exch, seed_c,
                      cidx, lvl_abs, live, pt=None, pa=None, out=None):
    """:func:`serving_exchange` with the class masks given.  ``is_sos``,
    ``pt`` (``(t_rung, partner, pairlo, is_pt)``) or ``pa`` (``(seg_lo,
    seg_hi, dbeta_c, is_pa)``) None means the batch has no chain of that
    class, so the engine need not build its operands; the stage is then
    skipped, which an all-False mask makes a bitwise identity anyway.
    The stages' uniforms are drawn in one threefry pass.  ``out``, a
    tensor shaped like ``x`` that does not overlap it, receives the
    states."""
    n = fx.shape[0]
    xb, fb, ib = segment_champion(x, fx, seg, num_segments)
    seg = seg.long()
    valid = (ib < n)[seg] & live
    keys = ([(SOS_SALT, cidx)] if is_sos is not None else []) \
        + ([(PT_SALT, pt[2])] if pt is not None else []) \
        + ([(PA_SALT, cidx)] if pa is not None else [])
    us = _exchange_uniforms(seed_c, lvl_abs, keys) if keys else []
    take = adopt
    if is_sos is not None:
        u_sos = us.pop(0)
        take = take | (is_sos & (u_sos <= sos_adopt_prob(fx, fb[seg], T_exch)))
    take = valid & take
    x = torch.where(take[:, None], xb[seg], x, out=out)
    fx = torch.where(take, fb[seg], fx)
    if pt is not None:
        t_rung, partner, pairlo, is_pt = pt
        x, fx, _ = pt_swap_segmented(x, fx, t_rung, partner, is_pt, us.pop(0),
                                     out=out)
    if pa is not None:
        seg_lo, seg_hi, dbeta_c, is_pa = pa
        x, fx, _, _ = pa_resample_segmented(x, fx, fb, seg, seg_lo, seg_hi,
                                            dbeta_c, is_pa, us.pop(0), out=out)
    return x, fx, xb, fb
