"""The sequence axis of the serving caches: a decode over a cache whose
slots are cut over a group of ranks, with the flash-decode combine.

The reference cuts a cache's sequence in two cases (``launch.steps.cache_specs``):
at a batch no data axis divides (batch 1, the ``long_500k`` cells) the
GQA and MLA caches over the data axes, and under ``seq_shard_kv`` a
GQA cache whose KV heads do not divide ``model`` (and whose layer has
no window), and every MLA latent cache, over ``model``.  XLA's
partitioner then turns the softmax and ``p·v`` over the cut cache into
partial sums over the group.  Here every rank holds one block of the
slots (:class:`SeqCut`) and:

* writes the token's entries only where it owns the slot
  (:func:`write_owned`), a masked update decided on the device;
* computes over its slots the partial softmax (:func:`partial`): its
  max ``m_r``, its sum of exponentials ``l_r`` and its unnormalised
  output ``o_r``, in float32;
* merges the group's partials (:func:`merge_over`: one MAX all-reduce of
  ``m``, one SUM all-reduce of ``l`` and ``o`` packed in one buffer; per
  mesh axis of the group), which :func:`merge` does for partials held in
  one process, with no collective.

The reference's masking is kept: a masked score is -1e30.  A rank whose
slots are all masked has ``m_r = -1e30`` and adds ``exp(-1e30 - m) = 0``;
the token's own slot is valid on its owner, so some rank always has a
valid slot.  Where the group has one rank there is no cut
(:func:`seq_cut` gives None) and nothing here runs.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import sharded
from repro_torch.launch.mesh import mesh_axes, shard_index

#: The score a mask puts where a slot is not attended (the reference's).
MASKED = -1e30


class SeqCut(NamedTuple):
    """One layer's cache cut on its sequence over ``axes`` (each of more
    than one rank; ``size`` ranks in all): this rank, ``rank`` by
    ``shard_index`` over them (the first axis major), holds global slots
    ``[rank·block, min((rank+1)·block, length))`` of the ``length``
    slots, in a buffer of ``block = ceil(length / size)`` slots; the
    last blocks' slots past ``length`` are padding, never addressed."""
    axes: tuple
    mesh: Any
    size: int
    rank: int
    length: int
    block: int

    @property
    def lo(self) -> int:
        """The first global slot of this rank's block."""
        return self.rank * self.block


def block_len(length: int, n: int) -> int:
    """The slots of each rank's block: ``length`` cut into ``n``, the
    last blocks padded as the partitioner pads."""
    return -(-length // n)


def seq_entry(layer: dict):
    """A layer's ``cache_specs`` sequence entry: dim 1 of its GQA ``k``
    or its MLA ``c_kv``; None for a layer whose caches hold no sequence
    (Mamba's)."""
    spec = layer.get("k") or layer.get("c_kv")
    return spec[1] if spec else None


def seq_cut(entry, mesh, length: int) -> Optional[SeqCut]:
    """The cut a cache spec's sequence ``entry`` (None, an axis or a
    tuple of them) makes of ``length`` slots over ``mesh``; None where
    no named axis has more than one rank."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in sharded.entry_axes(entry) if sizes[a] > 1)
    if not axes:
        return None
    n = math.prod(sizes[a] for a in axes)
    return SeqCut(axes, mesh, n, shard_index(mesh, axes), length, block_len(length, n))


# ------------------------------------------------------------------- write
def write_owned(cache: dict, slot, values: dict, cut: SeqCut) -> None:
    """Write each row's ``values[name]`` (B, ...) at global slot ``slot``
    (B,) of ``cache[name]`` (B, block, ...) where this rank owns it, at
    the local slot ``slot - cut.lo``; every other row and slot of the
    block stays as it was.  A masked update decided on the device: no
    host sync."""
    local = slot - cut.lo
    mine = (local >= 0) & (local < cut.block)
    local = local.clamp(0, cut.block - 1)
    rows = torch.arange(slot.shape[0], device=slot.device)
    for name, val in values.items():
        t = cache[name]
        keep = mine.view(-1, *([1] * (val.dim() - 1)))
        t[rows, local] = torch.where(keep, val.to(t.dtype), t[rows, local])


# ----------------------------------------------------------------- combine
def partial(scores, mask, values, spec: str):
    """The rank's partial softmax over its slots: ``scores`` (L..., T)
    float32, ``mask`` broadcastable to them (False: not attended),
    ``values`` and ``spec`` the einsum of the exponentials and
    ``values`` into the output (L..., V...).  Returns ``(m, l, o)``, all
    float32: the max over the slots (L...), the sum of ``exp(s - m)``
    and the unnormalised output."""
    s = torch.where(mask, scores.float(), MASKED)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    return m, e.sum(-1), torch.einsum(spec, e, values.float())


def _weighted(m_r, m, l_r, o_r):
    """A partial rescaled to the merged max ``m``."""
    w = torch.exp(m_r - m)
    return l_r * w, o_r * w.view(*w.shape, *([1] * (o_r.dim() - w.dim())))


def _normalised(l, o):
    return o / l.view(*l.shape, *([1] * (o.dim() - l.dim())))


def merge(partials) -> torch.Tensor:
    """The normalised output of the ``(m, l, o)`` partials of every block:
    ``m = max m_r``, ``l = Σ l_r·exp(m_r - m)``, ``o = Σ o_r·exp(m_r - m) / l``."""
    m = torch.stack([p[0] for p in partials]).amax(0)
    parts = [_weighted(m_r, m, l_r, o_r) for m_r, l_r, o_r in partials]
    return _normalised(sum(p[0] for p in parts), sum(p[1] for p in parts))


def merge_over(m_r, l_r, o_r, cut: SeqCut) -> torch.Tensor:
    """:func:`merge` of this rank's partial with the group's: one MAX
    all-reduce of ``m``, then one SUM all-reduce of ``l`` and ``o``
    packed in one buffer, each once per mesh axis of the group."""
    m = m_r.contiguous().clone()
    for a in cut.axes:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=cut.mesh.get_group(a))
    l, o = _weighted(m_r, m, l_r, o_r)
    buf = torch.cat([l.reshape(-1), o.reshape(-1)])
    sharded.all_reduce_over(buf, cut.axes, cut.mesh)
    return _normalised(buf[:l.numel()].view(l.shape), buf[l.numel():].view(o.shape))


def gather_heads(xs, tp) -> list:
    """Each of ``xs`` (B, S, h, d_i), this rank's h heads of a layer whose
    heads ``tp`` (a ``tensor_parallel.ModelGroup``) cuts in contiguous
    blocks, with every rank's: (B, S, tp.size·h, d_i), in one all-gather
    (they share a dtype)."""
    widths = [x.shape[-1] for x in xs]
    x = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
    B, S, h, d = x.shape
    out = x.new_empty((tp.size * B, S, h, d))
    sharded._ALL_GATHER(out, x.contiguous(), group=tp.group)
    out = out.view(tp.size, B, S, h, d).permute(1, 2, 0, 3, 4).reshape(B, S, tp.size * h, d)
    return list(out.split(widths, -1))


def own_heads(x, tp, h: int):
    """This rank's ``h`` heads (dim 2) of ``x``, whose heads ``tp`` cuts
    in contiguous blocks."""
    return x.narrow(2, tp.rank * h, h)
