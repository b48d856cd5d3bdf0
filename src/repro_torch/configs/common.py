"""Shared architecture/shape plumbing for the assigned-architecture pool,
the counterpart of ``repro.configs.common``, with its own copy of the data.

Every architecture module exposes ``ARCH: ArchSpec``.  The four assigned
input shapes are global; per-arch skip rules are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.model import LayerSpec, ModelConfig

# assigned shape set: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: ModelConfig
    long_ok: bool = False       # sub-quadratic enough for long_500k
    decode_ok: bool = True      # encoder-only archs would set False
    source: str = ""            # provenance tag from the assignment table

    def shapes(self):
        for name, (seq, batch, kind) in SHAPES.items():
            if name == "long_500k" and not self.long_ok:
                continue
            if kind == "decode" and not self.decode_ok:
                continue
            yield name, (seq, batch, kind)


def dense_blocks(n_layers: int, window: Optional[int] = None):
    return ((
        (LayerSpec(kind="attn", window=window, mlp="dense"),),
        n_layers,
    ),)


def shrink(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (few layers, tiny
    widths/vocab/experts) — structure preserved, scale removed."""
    blocks = tuple((pattern, 1) for pattern, _ in cfg.blocks[:2])
    small = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        blocks=blocks,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        kv_lora=32 if cfg.kv_lora else 0,
        d_nope=16 if cfg.d_nope else 0,
        d_rope=16 if cfg.d_rope else 0,
        d_state=min(cfg.d_state, 4),
        expand=cfg.expand,
        dt_rank=4 if cfg.dt_rank or cfg.blocks_have("mamba") else 0,
        max_seq=512,
        frontend_len=4 if cfg.frontend_len else 0,
        remat="none",
        moe_ep=False,
    )
    # shrink sliding windows in the pattern
    blocks2 = []
    for pattern, reps in blocks:
        blocks2.append((tuple(
            dataclasses.replace(s, window=8 if s.window else None)
            for s in pattern), reps))
    small["blocks"] = tuple(blocks2)
    small.update(over)
    return dataclasses.replace(cfg, **small)
