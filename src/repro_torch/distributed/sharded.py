"""The training state laid out by the reference's specs: each rank holds
one block of every leaf.

The reference trains with ``jax.jit(in_shardings=...)`` over a
``NamedSharding(mesh, spec)`` per leaf, from ``param_specs`` and
``state_specs`` (``launch.steps``): each device stores one block of
every parameter, gradient and optimizer moment, and XLA puts an
all-gather before each use and a reduce-scatter after each gradient.
This module stands for ``NamedSharding`` plus ``jit`` in the port, where
every rank is a process and every collective is explicit:

* :func:`shard_leaf` cuts a whole leaf into this rank's block.  A dim
  whose spec entry names axes is cut into the product of their sizes,
  the block chosen by ``launch.mesh.shard_index`` over those axes, the
  first named axis major (JAX's order for an entry such as ``("pod",
  "data")``).  :func:`shard_state` and :func:`gather_state` apply it, and
  its inverse :func:`gather_leaf`, to whole trees.
* :func:`gather` is the all-gather with a gradient, with a choice per
  leaf (``models.model.sharding``, by ``tensor_parallel.gather_mode``).
  Its backward reduce-scatters (sums) the gradient over the data axes
  the spec names and divides by their size, the mean over the batch's
  shards.  Over ``model`` it takes one
  of three forms: axes in ``keep`` are not gathered at all (a leaf the
  rank computes with as its block: tensor parallelism, the expert
  stacks' E/tp slices among them); axes in ``summed`` are gathered and
  the gradient reduce-scattered (summed) back, for a leaf whose ranks
  each fill a part of the whole gradient (Mamba's ``in_proj``, whose x
  and z columns lie in two blocks); otherwise, where every rank of a
  group computes the same thing on the same tokens, it keeps the rank's
  own slice and sums nothing.  Where no named axis has more than one
  rank the block is the whole leaf and comes back as it is.
* :func:`regather_on_unpack` keeps autograd from holding the gathered
  leaves through the backward: what a gathered leaf's users save for the
  backward is the block, gathered again when the backward unpacks it.

A spec is a tuple with one entry per dim (``None``, an axis name or a
tuple of them); a mesh is a ``DeviceMesh`` whose axes other than
``model`` are data axes (``launch.mesh.dp_axes``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch._tree import flatten, map_tree
from repro_torch.launch.mesh import mesh_axes, shard_index

#: The all-gather and reduce-scatter of single tensors (torch's newer
#: names where they exist, else the older ones; the same collectives).
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def cut_axes(spec, mesh) -> list:
    """Per dim, the named axes of more than one rank, in the spec's order."""
    n = mesh_axes(mesh)
    return [tuple(a for a in entry_axes(e) if n[a] > 1) for e in spec]


def whole_shape(shape, spec, mesh) -> tuple:
    """The whole leaf's shape from its block's ``shape``."""
    n = mesh_axes(mesh)
    return tuple(s * math.prod(n[a] for a in entry_axes(e)) for s, e in zip(shape, spec))


def spec_paths(specs) -> dict:
    """{path: spec} of a spec tree (dicts and lists; a spec is a tuple)."""
    return flatten(specs, seqs=(list,))


# --------------------------------------------------------------- blocks
@torch.no_grad()
def shard_leaf(whole: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``whole`` under ``spec``: a contiguous copy,
    or ``whole`` itself where no named axis has more than one rank."""
    n = mesh_axes(mesh)
    out = whole
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        parts = math.prod(n[a] for a in axes)
        if parts == 1:
            continue
        if whole.shape[d] % parts:
            raise ValueError(f"dim {d} of {tuple(whole.shape)} does not divide into {parts} "
                             f"blocks over {axes}")
        size = whole.shape[d] // parts
        out = out.narrow(d, shard_index(mesh, axes) * size, size)
    return whole if out is whole else out.clone(memory_format=torch.contiguous_format)


def shard_state(tree, specs, mesh):
    """Every leaf of ``tree`` cut to this rank's block by ``specs``."""
    fs = spec_paths(specs)
    return map_tree(lambda path, t: shard_leaf(t, fs[path], mesh), tree)


def _gather_dim(t, d, axis, mesh):
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    moved = t.movedim(d, 0).contiguous()
    out = torch.empty((n * moved.shape[0], *moved.shape[1:]), dtype=t.dtype, device=t.device)
    _ALL_GATHER(out, moved, group=group)
    return out.movedim(0, d).contiguous()


def _scatter_dim(t, d, axis, mesh):
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    moved = t.movedim(d, 0).contiguous()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]), dtype=t.dtype, device=t.device)
    _REDUCE_SCATTER(out, moved, group=group)
    return out.movedim(0, d).contiguous()


def _own_slice(t, d, axis, mesh):
    size = t.shape[d] // mesh_axes(mesh)[axis]
    return t.narrow(d, mesh.get_local_rank(axis) * size, size).contiguous()


def gather_leaf(block: torch.Tensor, spec, mesh, keep=()) -> torch.Tensor:
    """The whole leaf from every rank's block (no gradient): one
    all-gather per named axis of more than one rank but those in
    ``keep``, the last named axis of an entry first; ``block`` itself
    where there is none."""
    out = block
    for d, axes in enumerate(cut_axes(spec, mesh)):
        for a in reversed(axes):
            if a not in keep:
                out = _gather_dim(out, d, a, mesh)
    return out


def reduce_leaf(grad: torch.Tensor, spec, mesh, keep=(), summed=()) -> torch.Tensor:
    """The transpose of :func:`gather_leaf` for a loss averaged over the
    data axes: the whole gradient summed over the data axes the spec
    names (a reduce-scatter each, the first named axis first) and
    divided by their size; over ``model`` the rank's own slice, or where
    ``summed`` names it the sum's (a reduce-scatter, not divided)."""
    out, scale = grad, 1
    n = mesh_axes(mesh)
    for d, axes in enumerate(cut_axes(spec, mesh)):
        for a in axes:
            if a in keep:
                continue
            if a in summed:
                out = _scatter_dim(out, d, a, mesh)
            elif a == "model":
                out = _own_slice(out, d, a, mesh)
            else:
                out = _scatter_dim(out, d, a, mesh)
                scale *= n[a]
    return out / scale if scale > 1 else out


def gather_state(tree, specs, mesh):
    """Every leaf of ``tree`` whole (:func:`gather_leaf`, no gradient)."""
    fs = spec_paths(specs)
    with torch.no_grad():
        return map_tree(lambda path, t: gather_leaf(t, fs[path], mesh), tree)


#: Each gathered leaf that needs a gradient -> (its block, spec, mesh,
#: keep), for :func:`regather_on_unpack`.
_GATHERED = WeakIdKeyDictionary()


class _Gather(torch.autograd.Function):
    """:func:`gather_leaf` forward, :func:`reduce_leaf` backward."""

    @staticmethod
    def forward(ctx, block, spec, mesh, keep, summed):
        ctx.spec, ctx.mesh, ctx.keep, ctx.summed = spec, mesh, keep, summed
        return gather_leaf(block, spec, mesh, keep)

    @staticmethod
    def backward(ctx, grad):
        return reduce_leaf(grad, ctx.spec, ctx.mesh, ctx.keep, ctx.summed), None, None, None, None


def gather(block: torch.Tensor, spec, mesh, keep=(), summed=()) -> torch.Tensor:
    """The leaf from every rank's block, gathered over each axis but
    those in ``keep``, differentiable (see the module's docstring);
    ``block`` itself where nothing is gathered."""
    if all(a in keep for axes in cut_axes(spec, mesh) for a in axes):
        return block
    whole = _Gather.apply(block, spec, mesh, tuple(keep), tuple(summed))
    if whole.requires_grad:
        _GATHERED[whole] = (block, spec, mesh, tuple(keep))
    return whole


def _pack(t):
    src = _GATHERED.get(t)
    if src is None and t._base is not None:
        src = _GATHERED.get(t._base)
    if src is None:
        return t
    return src, tuple(t.shape), t.stride(), t.storage_offset()


def _unpack(saved):
    if isinstance(saved, torch.Tensor):
        return saved
    (block, spec, mesh, keep), shape, stride, offset = saved
    with torch.no_grad():
        return gather_leaf(block, spec, mesh, keep).as_strided(shape, stride, offset)


def regather_on_unpack():
    """A ``saved_tensors_hooks`` context: a gathered leaf (or a view of
    it) that an op saves for the backward is kept as its block and
    gathered again when the backward unpacks it.  Inside a ``remat``
    region ``torch.utils.checkpoint``'s own hooks take precedence and
    recompute the gathers with the rest of the region."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


# ------------------------------------------------------------ reductions
def all_reduce_over(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``t`` summed in place over the mesh axes ``axes`` (one all-reduce
    per axis, in the order given)."""
    for a in axes:
        dist.all_reduce(t, group=mesh.get_group(a))
    return t


def partial_mean(x: torch.Tensor, dim, axes, whole: int, mesh, keepdim=False):
    """The mean over ``dim`` (an int, or None for every dim) of a leaf
    whose blocks cut that dim over ``axes``: ``x.mean`` where ``axes`` is
    empty, else the block's sum summed over ``axes`` and divided by
    ``whole``, the reduced elements of the whole leaf."""
    if not axes:
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    s = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
    return all_reduce_over(s, axes, mesh) / whole


def block_bytes(tree) -> int:
    """The bytes of a tree's tensors."""
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())
