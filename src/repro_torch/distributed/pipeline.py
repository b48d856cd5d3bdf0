"""GPipe-style pipeline parallelism over a mesh axis, the counterpart of
``repro.distributed.pipeline``.

The layer stack is split into ``n_stages`` contiguous stages; stage s is
the rank at coordinate s of the mesh dim ``axis``.  Microbatches flow
through the stages by point-to-point sends, stage i to i+1 (the
reference's ``ppermute``); the GPipe schedule runs M microbatches over S
stages in M + S - 1 ticks with bubble fraction (S-1)/(M+S-1).

Model-agnostic: it pipelines any ``layer_fn(stage_params, x) -> x``.
Every rank of the mesh calls it (one process per rank, where the
reference runs inside ``shard_map``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch._tree import map_tree


def pipeline_apply(layer_fn, stage_params, x_microbatches, *, mesh, axis: str = "pod"):
    """``stage_params``: THIS rank's stage weights; ``x_microbatches``:
    (M, mb, ...), the same on every rank.  Returns the final stage's
    outputs for every microbatch (valid on the last stage; the others
    return zeros)."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages, stage = len(ranks), mesh.get_local_rank(axis)
    M = x_microbatches.shape[0]
    state = torch.zeros_like(x_microbatches[0])
    outputs = torch.zeros_like(x_microbatches)
    for t in range(M + n_stages - 1):
        # stage 0 injects microbatch t (when t < M); others use received state
        x_in = x_microbatches[min(t, M - 1)] if stage == 0 else state
        y = layer_fn(stage_params, x_in).contiguous()
        # shift: stage s sends y to s+1
        works = []
        if stage < n_stages - 1:
            works.append(dist.isend(y, ranks[stage + 1], group=group))
        if stage > 0:
            state = torch.empty_like(y)
            works.append(dist.irecv(state, ranks[stage - 1], group=group))
        for w in works:
            w.wait()
        # last stage records its output for microbatch (t - (S-1))
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outputs[out_idx] = y
    return outputs


def make_pipelined_fn(layer_fn, mesh, *, axis: str = "pod"):
    """``fn(stage_params, xs)``: the leading dim of every leaf of
    ``stage_params`` is cut into one equal part per stage and each rank
    takes its own (the reference's ``P(axis)``); ``xs`` is the same on
    every rank, and so is the result: the last stage's outputs, broadcast
    over ``axis``."""
    def fn(stage_params, xs):
        group = mesh.get_group(axis)
        ranks = dist.get_process_group_ranks(group)
        n, s = len(ranks), mesh.get_local_rank(axis)
        mine = map_tree(lambda _, w: w[s * (w.shape[0] // n):(s + 1) * (w.shape[0] // n)],
                        stage_params)
        out = pipeline_apply(layer_fn, mine, xs, mesh=mesh, axis=axis)
        dist.broadcast(out, ranks[-1], group=group)
        return out

    return fn


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
