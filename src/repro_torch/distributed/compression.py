"""Int8 error-feedback gradient compression for the data-parallel sum,
the counterpart of ``repro.distributed.compression``.

Each tensor is quantized to int8 with one float32 scale per (tensor,
shard) before the collective; the quantization residual stays local
(*error feedback*) and is added to the next step's gradient::

    g_sum, new_residual = compressed_psum(g + residual, mesh, axes)

4x less traffic than float32 (2x less than bf16) on the wire.  The
reference runs inside ``shard_map`` over mesh axis names; the port runs
in every rank of a ``torch.distributed`` group and names the mesh dims
(``launch.mesh.axis_group``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch._tree import flatten, map_tree
from repro_torch.launch.mesh import axis_group


def quantize_int8(x):
    """Symmetric per-tensor int8 quantization, rounding half to even (as
    ``jnp.round``). Returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, 1.0).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def _all_gather(t, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def compressed_psum(x, mesh, axes):
    """Sum ``x`` over the mesh dims ``axes`` with an int8 payload and
    error feedback.  Returns (approx_sum, residual): ``residual = x -
    dequant(quant(x))`` must be carried by the caller and added to next
    step's input.  The wire transfer is an all-gather of q and of the
    per-shard scales (1 byte per element + 4 per shard), then the local
    sum of the shards' ``scale · q`` in float32."""
    q, scale = quantize_int8(x)
    residual = x - dequantize_int8(q, scale)
    group, rows = axis_group(mesh, axes)
    qg = _all_gather(q, group)[rows]                 # (shards, ...)
    sg = _all_gather(scale.reshape(1), group)[rows, 0]
    approx = torch.tensordot(sg, qg.float(), dims=1)
    return approx, residual


def compress_grads_tree(grads, residuals, mesh, axes):
    """compressed_psum over every leaf of a gradient tree, each in float32
    with its residual added.  Returns (sums, new residuals)."""
    fr = flatten(residuals)
    out = {path: compressed_psum(g.float() + fr[path], mesh, axes)
           for path, g in flatten(grads).items()}
    return (map_tree(lambda path, _: out[path][0], grads),
            map_tree(lambda path, _: out[path][1], grads))


def init_residuals(grads_like):
    """Zero float32 residuals shaped like ``grads_like``."""
    return map_tree(lambda _, g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)
