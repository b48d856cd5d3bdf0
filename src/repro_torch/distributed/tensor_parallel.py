"""Tensor parallelism over the mesh's ``model`` axis, Megatron style: the
compute the reference's ``jax.jit`` partitions over ``model`` when
``launch.steps.param_specs`` cuts q-heads, ``d_ff``, Mamba's ``d_inner``,
the routed experts and the vocabulary over it.

Without ``seq_parallel`` a rank of a ``model`` group holds the same
tokens as its peers and the same hidden stream (the replicated stream).
A region that computes with the rank's blocks opens with
:func:`copy_to_model` (the identity, whose backward sums the stream's
partial gradients over the group) and closes with
:func:`reduce_from_model` (the sum of the ranks' partial outputs, whose
backward is the identity): a column-parallel projection (a block of
output columns: ``wq``, ``w_gate``/``w_up``, ``in_proj``) feeds a
row-parallel one (a block of input rows: ``wo``, ``w_down``,
``out_proj``); the routed experts' rows are the rank's experts'.  The
vocabulary is cut the same way: the lookup (:func:`vocab_lookup`), the
loss (:func:`vocab_parallel_cross_entropy`) and the next token
(:func:`vocab_parallel_argmax`) each combine the ranks' blocks of it.

With ``seq_parallel`` (Megatron-SP; :class:`SeqSplit`) the stream
between layers is the rank's block of the sequence: ceil(S/tp)
positions, the last blocks padded.  A block opens with
:func:`gather_seq` (an all-gather, whose backward reduce-scatters the
ranks' partial gradients) and closes with :func:`reduce_scatter_seq`
where the ranks hold partial sums, or with :func:`own_seq_block` where
each holds the whole output.  The padding is stripped after each
gather and restored before each scatter, so no layer sees it.  Every
leaf that the specs leave whole over ``model`` then has a partial
gradient on each rank (its block's), summed over the group.

Which leaves a rank computes from its own block, and which gradients it
must sum over the group, follow the specs (:func:`gather_mode`,
:func:`partial_grad`).  Nothing here runs where the group has one rank
(:func:`model_group` gives None): the path is then the whole form's, op
for op.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch._tree import at
from repro_torch.distributed.sharded import _ALL_GATHER, _REDUCE_SCATTER, cut_axes
from repro_torch.launch.mesh import mesh_axes


class ModelGroup(NamedTuple):
    """The ``model`` process group of this rank: its size and this
    rank's place in it."""
    group: object
    size: int
    rank: int


def model_group(mesh, specs=None) -> Optional[ModelGroup]:
    """This rank's ``model`` group where the compute is cut over it: a
    mesh with a ``model`` axis of more than one rank, and ``specs`` given
    (the sharded path; the whole form computes replicated).  Else None."""
    if mesh is None or specs is None or mesh_axes(mesh).get("model", 1) == 1:
        return None
    return ModelGroup(mesh.get_group("model"), mesh_axes(mesh)["model"],
                      mesh.get_local_rank("model"))


# ------------------------------------------------------------- operators
def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=op, group=group)
    return t


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _SumForward(torch.autograd.Function):
    """The sum over ``group``, whose backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, tp: Optional[ModelGroup]):
    """``x`` as it is; its gradient summed over the group."""
    return x if tp is None else _SumGrad.apply(x, tp.group)


def reduce_from_model(x, tp: Optional[ModelGroup]):
    """``x`` summed over the group; its gradient as it is."""
    return x if tp is None else _SumForward.apply(x, tp.group)


def sum_both_ways(x, tp: Optional[ModelGroup]):
    """``x`` summed over the group, and so is its gradient: a partial
    product that every rank then reads in full (Mamba's ``x_proj``)."""
    return copy_to_model(reduce_from_model(x, tp), tp)


# -------------------------------------------------------------- sequence
class SeqSplit(NamedTuple):
    """The stream of ``length`` positions cut on dim 1 over the ``model``
    group ``tp``: rank r holds positions ``[r·block, (r+1)·block)`` of
    the sequence padded to ``tp.size·block``."""
    tp: ModelGroup
    length: int

    @property
    def block(self) -> int:
        return -(-self.length // self.tp.size)


def _padded(t, sp: SeqSplit):
    pad = sp.tp.size * sp.block - t.shape[1]
    return t if pad == 0 else torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], 1)


def _gather_blocks(t, sp: SeqSplit):
    """Every rank's block, in rank order, the padding stripped."""
    moved = t.movedim(1, 0).contiguous()
    out = moved.new_empty((sp.tp.size * moved.shape[0], *moved.shape[1:]))
    _ALL_GATHER(out, moved, group=sp.tp.group)
    return out[:sp.length].movedim(0, 1).contiguous()


def _scatter_blocks(t, sp: SeqSplit):
    """The group's sum of the whole ``t``, the rank's block of it."""
    moved = _padded(t, sp).movedim(1, 0).contiguous()
    out = moved.new_empty((sp.block, *moved.shape[1:]))
    _REDUCE_SCATTER(out, moved, group=sp.tp.group)
    return out.movedim(0, 1).contiguous()


def _own_block(t, sp: SeqSplit):
    return _padded(t, sp).narrow(1, sp.tp.rank * sp.block, sp.block).contiguous()


def _zero_padded(block, sp: SeqSplit):
    """The whole sequence, zero but at the rank's block."""
    whole = block.new_zeros((block.shape[0], sp.tp.size * sp.block, *block.shape[2:]))
    whole.narrow(1, sp.tp.rank * sp.block, sp.block).copy_(block)
    return whole[:, :sp.length]


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _gather_blocks(x, sp)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_blocks(grad, ctx.sp), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _scatter_blocks(x, sp)

    @staticmethod
    def backward(ctx, grad):
        return _gather_blocks(grad, ctx.sp), None


class _OwnSeqBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _own_block(x, sp)

    @staticmethod
    def backward(ctx, grad):
        return _zero_padded(grad, ctx.sp), None


class _OwnSeqGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return x

    @staticmethod
    def backward(ctx, grad):
        return _zero_padded(_own_block(grad, ctx.sp), ctx.sp), None


def gather_seq(x, sp: SeqSplit):
    """The whole sequence (B, length, ...) from the ranks' blocks; the
    backward sums the ranks' (partial) gradients and keeps the rank's
    block: the entry of a block that reads every position."""
    return _GatherSeq.apply(x, sp)


def reduce_scatter_seq(x, sp: SeqSplit):
    """The rank's block of the group's sum of the whole ``x`` (the ranks'
    partial outputs); the backward gathers the blocks' gradients."""
    return _ReduceScatterSeq.apply(x, sp)


def own_seq_block(x, sp: SeqSplit):
    """The rank's block of ``x``, whole and the same on every rank; the
    backward puts the block's gradient in its place and zeros elsewhere
    (a part of the whole gradient, summed where ``x`` came from)."""
    return _OwnSeqBlock.apply(x, sp)


def own_seq_grad(x, sp: SeqSplit):
    """``x`` as it is, its gradient kept at the rank's block only: for a
    whole ``x`` that every rank reads in full, with the same gradient on
    each (the loss over an uncut head), so that what flows back is the
    rank's part and the leaves it reaches have partial gradients."""
    return _OwnSeqGrad.apply(x, sp)


# ------------------------------------------------------------ vocabulary
def vocab_rows(block, ids, tp: ModelGroup):
    """The rank's part of rows ``ids`` of an embedding whose rank holds
    rows ``[r·V/tp, (r+1)·V/tp)`` as ``block``: the ids in its range
    looked up (``nn.functional.embedding``, whose backward adds repeated
    rows in a fixed order), the others zero; the group's sum is the
    lookup.  A negative id counts from the end, as in indexing."""
    n = block.shape[0]
    ids = torch.where(ids < 0, ids + n * tp.size, ids) - tp.rank * n
    outside = (ids < 0) | (ids >= n)
    rows = nn.functional.embedding(ids.masked_fill(outside, 0), block)
    return rows.masked_fill(outside[..., None], 0)


def vocab_lookup(block, ids, tp: ModelGroup):
    """Rows ``ids`` of the embedding whose rank holds ``block``: the
    group's sum of :func:`vocab_rows`."""
    return reduce_from_model(vocab_rows(block, ids, tp), tp)


class _VocabCrossEntropy(torch.autograd.Function):
    """Per position, ``logsumexp`` of the whole row less the target's
    logit, from the rank's block of the columns: the max over the group
    (no gradient), the sum of the exponentials over the group, and the
    target's logit from the one rank that holds it.  The backward is the
    rank's block of ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, logits, targets, group, rank):
        n = logits.shape[-1]
        m = _all_reduce(logits.max(-1).values, group, dist.ReduceOp.MAX)
        e = (logits - m[..., None]).exp_()
        s = _all_reduce(e.sum(-1), group)
        local = targets - rank * n
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        tl = (logits.gather(-1, local[..., None])[..., 0] - m).masked_fill(~mine, 0)
        tl = _all_reduce(tl, group)
        ctx.save_for_backward(e.div_(s[..., None]), local, mine)
        return s.log() - tl

    @staticmethod
    def backward(ctx, grad):
        p, local, mine = ctx.saved_tensors
        g = p.clone()
        g.scatter_add_(-1, local[..., None], -mine[..., None].to(g.dtype))
        return g * grad[..., None], None, None, None


def vocab_parallel_cross_entropy(logits, targets, tp: ModelGroup):
    """``logsumexp(row) - row[target]`` of float32 ``logits`` (..., V/tp),
    the rank's block of the columns, for targets in ``[0, V)``."""
    return _VocabCrossEntropy.apply(logits, targets, tp.group, tp.rank)


def vocab_parallel_argmax(logits, tp: ModelGroup):
    """``argmax`` over the last dim of the whole row from the rank's
    block (..., V/tp): each rank's largest value and its first index,
    gathered; the largest over the group, ties to the lowest index, as
    ``jnp.argmax`` and ``torch.argmax`` take the first."""
    n = logits.shape[-1]
    val, idx = logits.max(-1)       # the first index of the rank's maximum
    both = torch.stack([val.float(), (idx + tp.rank * n).float()]).contiguous()
    out = both.new_empty((tp.size * 2, *both.shape[1:]))
    _ALL_GATHER(out, both, group=tp.group)
    out = out.view(tp.size, *both.shape)
    best = out[:, 0].argmax(0, keepdim=True)     # the first rank, so the lowest index
    return out[:, 1].gather(0, best)[0].long()


# ------------------------------------------------------------ the leaves
def cut_over_model(spec, mesh) -> bool:
    """Whether ``spec`` cuts its leaf over a ``model`` axis of more than one rank."""
    return any("model" in axes for axes in cut_axes(spec, mesh))


def gather_mode(path: str, spec, specs, mesh, seq_parallel: bool = False) -> str:
    """How the sharded path gathers the leaf at ``path`` (``spec`` its
    spec, ``specs`` the whole tree's) where its layer runs:

    * ``"keep"``: cut over ``model``, the rank computes with its block,
      gathered over the data axes only (the expert stacks' E/tp slice
      among them, with or without expert parallelism);
    * ``"sum"``: Mamba's ``in_proj`` where ``d_inner`` is cut, or under
      ``seq_parallel``, gathered over ``model`` too (its ``2·d_inner``
      columns are cut contiguously, so a rank's x and z columns lie in
      two blocks; a replicated layer's gradient is the rank's part under
      ``seq_parallel``), its gradient reduce-scattered (summed) over
      ``model``;
    * ``"whole"``: gathered whole, the gradient's own slice kept over
      ``model`` (a leaf not cut over it; an ``in_proj`` whose ``d_inner``
      does not divide, computed replicated on the replicated stream)."""
    if not cut_over_model(spec, mesh):
        return "whole"
    head, _, name = path.rpartition("/")
    if name == "in_proj":
        cut = cut_over_model(_sibling(specs, head, "conv_w"), mesh)
        return "sum" if cut or seq_parallel else "whole"
    return "keep"


def partial_grad(path: str, spec, specs, mesh, seq_parallel: bool = False) -> bool:
    """Whether the leaf at ``path`` is whole on every rank but each
    rank's gradient is a part, summed over ``model``.  Without
    ``seq_parallel``: a leaf that feeds only the rank's heads, MLA's
    ``w_dkv`` and ``w_kr``, and GQA's ``wk``/``wv`` where the KV heads do
    not divide, in a layer whose q heads are cut; leaves of the
    replicated stream (norms, the router, ``pos_embed``, an uncut
    ``embed``) have the same gradient on every rank and are not summed.
    Under ``seq_parallel`` every leaf not cut over ``model``: each rank's
    gradient is that of its block of the sequence (the norms,
    ``pos_embed``, an uncut embedding's lookup and head, the router, a
    replicated layer's weights)."""
    head, _, name = path.rpartition("/")
    if seq_parallel:
        return not cut_over_model(spec, mesh)
    if cut_over_model(spec, mesh) or head.rpartition("/")[2] not in ("attn", "cross"):
        return False
    wq = _sibling(specs, head, "wq")
    return wq is not None and cut_over_model(wq, mesh)


def _sibling(specs, head, name):
    return at(specs, head).get(name)
