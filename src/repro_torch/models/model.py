"""Model configuration, the counterpart of the configuration half of
``repro.models.model``: :class:`LayerSpec` and :class:`ModelConfig` with
every field and default of the reference, the derived sizes and the
analytic parameter count the sharding autotuner reads.

Depth heterogeneity is ``blocks = ((pattern, repeats), ...)``: each
pattern is a tuple of :class:`LayerSpec` applied in order, repeated
``repeats`` times.  ``blocks_have``, which the reference attaches to the
class in ``repro/configs/common.py``, is a method here.  The parameters,
the forward pass and the caches wait for the model slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"          # 'attn' | 'mla' | 'mamba'
    window: Optional[int] = None  # None = global attention
    mlp: str = "dense"          # 'dense' | 'moe'
    cross_attn: bool = False    # enc-dec decoder layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    blocks: tuple  # ((pattern: tuple[LayerSpec, ...], repeats: int), ...)
    kind: str = "decoder"       # 'decoder' | 'encdec'
    n_enc_layers: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- MLA ---
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    # --- SSM ---
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    # --- misc ---
    rope_theta: float = 10000.0
    use_rope: bool = True
    max_seq: int = 131072
    frontend: str = "none"      # 'none' | 'audio_stub' | 'vision_stub'
    frontend_len: int = 0
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"         # 'none' | 'full' | 'dots'
    moe_ep: bool = False        # expert parallelism over the 'model' mesh axis
    scan_unroll: int = 1        # reference: 1=scan, 0=full unroll
    # --- distribution knobs (the reference's launch/steps.py) ---
    seq_parallel: bool = False  # Megatron-SP: shard saved hiddens' seq axis
    seq_shard_kv: bool = False  # flash-decode: shard cache seq over 'model'
                                # when KV heads don't divide the TP degree
    serve_params_tp_only: bool = False  # serving: weights TP-sharded and
                                # replicated over DP (no per-step FSDP
                                # all-gather; right when params/TP fit memory)

    @property
    def n_layers(self) -> int:
        return sum(len(p) * r for p, r in self.blocks)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    def blocks_have(self, kind: str) -> bool:
        """Whether any layer of the blocks is of ``kind``."""
        return any(s.kind == kind for pattern, _ in self.blocks for s in pattern)

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts — analytic, for 6ND roofline."""
        D, V = self.d_model, self.vocab_size
        emb = V * D
        total = emb if self.tie_embeddings else 2 * emb
        active = total
        for pattern, reps in self.blocks:
            for spec in pattern:
                t = a = 2 * D if spec.mlp != "none" else D  # norms
                if spec.kind == "attn":
                    t += D * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                    t += self.n_heads * self.head_dim * D
                    a = t
                elif spec.kind == "mla":
                    t += D * self.n_heads * (self.d_nope + self.d_rope)
                    t += D * (self.kv_lora + self.d_rope)
                    t += self.kv_lora * self.n_heads * (self.d_nope + self.head_dim)
                    t += self.n_heads * self.head_dim * D
                    a = t
                elif spec.kind == "mamba":
                    di = self.d_inner
                    t += D * 2 * di + self.d_conv * di + di * (self.dt_rank_eff + 2 * self.d_state)
                    t += self.dt_rank_eff * di + di * D
                    a = t
                if spec.mlp == "dense":
                    t += 3 * D * self.d_ff
                    a = t
                else:
                    routed = 3 * D * self.d_ff_expert
                    t += self.n_experts * routed + D * self.n_experts
                    a += self.top_k * routed + D * self.n_experts
                    if self.n_shared:
                        sh = 3 * D * (self.n_shared * self.d_ff_expert)
                        t += sh
                        a += sh
                if spec.cross_attn:
                    ca = D * 2 * self.n_heads * self.head_dim * 2 + D
                    t += ca
                    a += ca
                total += t * reps
                active += a * reps
        # encoder (whisper): plain dense attention layers
        if self.kind == "encdec":
            per = 2 * D + D * 3 * self.n_heads * self.head_dim + \
                self.n_heads * self.head_dim * D + 3 * D * self.d_ff
            total += per * self.n_enc_layers
            active += per * self.n_enc_layers
        return total, active
