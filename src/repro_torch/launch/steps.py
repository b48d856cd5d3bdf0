"""Training and serving steps of the LLM scaffold, the counterpart of
``repro.launch.steps``'s ``make_train_step``, ``make_prefill_step`` and
``make_serve_step``, as plain functions on tensors.

The reference wraps each step in an activation-sharding policy over a
device mesh; the port has no policy, and ``param_specs``,
``cache_specs`` and ``build_cell`` wait for the dry-run's replacement
(ROADMAP.md section A, item 4).  Next tokens are int32, by
``torch.argmax`` (the first index on ties, as ``jnp.argmax``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch._tree import flatten, map_tree
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, opt_step


def make_train_step(cfg: M.ModelConfig, ocfg: OptConfig, mesh=None, batch=None):
    """``train_step(state, batch_data) -> (state, loss)``: ``lm_loss``,
    its gradients by ``torch.autograd``, then the optimizer's update
    applied in place (``optim.opt_step``, Adafactor stacked by ``cfg``'s
    blocks).  ``state`` is ``{"params", "opt"}`` (``launch.train.build_state``),
    written in place and returned; ``loss`` is a 0-d float32 tensor.

    Under a mesh (a ``DeviceMesh``) every rank holds the whole state and
    its share of the batch along the data axes (every dim but
    ``model``): the gradients and the loss are averaged over those axes,
    one all-reduce per axis, and the MoE takes its expert-parallel form
    over ``model`` where ``cfg.moe_ep`` asks (``models.model._moe``).
    ``batch`` is the reference's, which sizes its activation layout; the
    port has none and does not read it."""
    axes = dp_axes(mesh) if mesh is not None else ()

    def mean_over_data(t):
        for a in axes:
            dist.all_reduce(t, group=mesh.get_group(a))
        for a in axes:
            t /= mesh.shape[mesh.mesh_dim_names.index(a)]
        return t

    def train_step(state, batch_data):
        params = state["params"]
        flat = flatten(params)
        loss = M.lm_loss(params, cfg, batch_data, mesh)
        grads = torch.autograd.grad(loss, list(flat.values()), materialize_grads=True)
        loss = loss.detach()
        if axes:
            for g in grads:
                mean_over_data(g)
            mean_over_data(loss)
        by_path = dict(zip(flat, grads))
        opt_step(map_tree(lambda path, _: by_path[path], params), params, state["opt"], ocfg, cfg)
        return state, loss

    return train_step


def make_prefill_step(cfg: M.ModelConfig):
    """``prefill_step(params, batch_data, caches) -> (next_tok (B, 1)
    int32, caches)`` over ``batch_data["tokens"][:, :-1]`` (the training
    layout of S + 1 tokens), the vision stub's ``patch_embeds`` before
    them where the config has one, and the encoder-decoder's
    ``audio_frames`` (B, frontend_len, D) as the encoder's input."""
    def prefill_step(params, batch_data, caches):
        kw = {}
        if cfg.frontend == "vision_stub":
            kw["embeds"] = batch_data["patch_embeds"]
        if cfg.kind == "encdec":
            kw["enc_frames"] = batch_data["audio_frames"]
        logits, caches = M.forward(params, cfg, batch_data["tokens"][:, :-1],
                                   caches=caches, mode="prefill", **kw)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), caches

    return prefill_step


def make_serve_step(cfg: M.ModelConfig):
    """``serve_step(params, caches, tokens (B, 1), pos (B,)) -> (next_tok
    (B, 1) int32, caches)``: one decode tick for the whole batch, the
    caches written in place."""
    def serve_step(params, caches, tokens, pos):
        positions = pos[:, None].expand(tokens.shape).to(torch.int32)
        logits, caches = M.forward(params, cfg, tokens, positions=positions,
                                   caches=caches, mode="decode")
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32), caches

    return serve_step
