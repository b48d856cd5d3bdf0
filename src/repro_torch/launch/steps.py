"""Serving steps of the LLM scaffold, the counterpart of the prefill and
serve half of ``repro.launch.steps`` (``make_prefill_step``,
``make_serve_step``) as plain functions on tensors.

The reference wraps each step in an activation-sharding policy over a
device mesh; on one card there is no layout to choose, so the port has
no policy, and ``param_specs``, ``cache_specs`` and ``build_cell`` wait
for the dry-run's replacement (ROADMAP.md section A, the last item).
Next tokens are int32, by ``torch.argmax`` (the first index on ties, as
``jnp.argmax``).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M


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
