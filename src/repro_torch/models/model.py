"""The LLM model of the port, the counterpart of
``repro.models.model``: :class:`LayerSpec` and :class:`ModelConfig` with
every field and default of the reference, the derived sizes and the
analytic parameter count; then the parameters (:func:`init_params`, the
:class:`Model` module over them), the decode caches (:func:`init_cache`)
and :func:`forward` in its train, prefill and decode modes.

Depth heterogeneity is ``blocks = ((pattern, repeats), ...)``: each
pattern is a tuple of :class:`LayerSpec` applied in order, repeated
``repeats`` times.  ``blocks_have``, which the reference attaches to the
class in ``repro/configs/common.py``, is a method here.  The reference
scans each group over a stacked ``repeats`` axis; the port keeps one
parameter dict and one cache dict per layer, in the order the blocks
apply them.

Every layer kind of the reference runs: GQA (RoPE or learned positions,
``use_rope=False``) and MLA attention, Mamba, with the dense SwiGLU MLP,
the MoE (and its shared experts) or no MLP, and cross-attention over the
encoder of the encoder-decoder (``kind="encdec"``).  The reference's
``shardctx.constrain`` calls and the knobs ``seq_parallel``,
``seq_shard_kv`` and ``serve_params_tp_only`` choose layouts over a
device mesh and change no value; the port's compute leaves them out
(``launch.steps`` gives their specs), and ``scan_unroll`` likewise.
``remat`` ("full" or "dots") checkpoints each instance of a block
pattern in train mode, as the reference checkpoints its scan body
(:func:`_rematted`): the same values, with less held for the backward.
:func:`lm_loss` is the training objective; under a mesh with a ``model``
axis and ``moe_ep`` the MoE takes its expert-parallel form (:func:`_moe`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch._device import resolve_device
from repro_torch.models import layers as L


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


# ---------------------------------------------------------------- support
def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a model kind, layer kind or MLP the
    reference does not define."""
    if cfg.kind not in ("decoder", "encdec"):
        raise ValueError(f"{cfg.name}: model kind {cfg.kind!r}")
    for pattern, _ in cfg.blocks:
        for spec in pattern:
            if spec.kind not in ("attn", "mla", "mamba") or spec.mlp not in ("dense", "moe",
                                                                             "none"):
                raise ValueError(f"{cfg.name}: layer {spec}")


ENC_SPEC = LayerSpec(kind="attn", window=None, mlp="dense")


def layer_specs(cfg: ModelConfig) -> list:
    """Every layer's spec, in the order the blocks apply them."""
    return [spec for pattern, reps in cfg.blocks for _ in range(reps) for spec in pattern]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ------------------------------------------------------------------ init
def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters in ``cfg.param_dtype`` on the generator's device,
    drawn by the reference's rules (``init_params``, ``_init_layer``):
    ``{"embed", "final_norm", ["lm_head"], ["pos_embed"], "layers": [per
    layer], ["enc"]}``.  ``pos_embed`` (max_seq, D) is there without
    RoPE.  Each layer holds ``norm1`` and ``attn``: GQA's ``{wq, wk, wv,
    wo}``, MLA's ``{wq, w_dkv, w_kr, w_uk, w_uv, wo}`` (``d_v =
    head_dim``) or Mamba's (:func:`layers.init_mamba`); with an MLP
    ``norm2`` and ``mlp``, the dense ``{w_gate, w_up, w_down}`` or the
    MoE's ``{router, w_gate, w_up, w_down[, shared]}`` with its float32
    router; with cross-attention ``normc`` and ``cross``, attention with
    as many KV heads as heads.  The encoder-decoder's ``enc`` is
    ``{"layers": [n_enc_layers dense attention layers], "final_norm",
    "pos_embed"}``.  Each weight is drawn in float32 and cast on its own
    (an expert stack one expert at a time), so the whole model is never
    held in float32."""
    check_supported(cfg)
    dtype, dev = _dtype(cfg.param_dtype), generator.device
    D = cfg.d_model
    params = {"embed": L._init(generator, (cfg.vocab_size, D), scale=0.02, dtype=dtype),
              "final_norm": torch.zeros(D, dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L._init(generator, (D, cfg.vocab_size), dtype=dtype)
    if not cfg.use_rope:
        params["pos_embed"] = L._init(generator, (cfg.max_seq, D), scale=0.02, dtype=dtype)
    params["layers"] = [_init_layer(generator, spec, cfg, dtype) for spec in layer_specs(cfg)]
    if cfg.kind == "encdec":
        params["enc"] = {
            "layers": [_init_layer(generator, ENC_SPEC, cfg, dtype)
                       for _ in range(cfg.n_enc_layers)],
            "final_norm": torch.zeros(D, dtype=dtype, device=dev),
            "pos_embed": L._init(generator, (cfg.max_seq, D), scale=0.02, dtype=dtype),
        }
    return params


def _init_layer(gen, spec: LayerSpec, cfg: ModelConfig, dtype) -> dict:
    D, dev = cfg.d_model, gen.device
    p = {"norm1": torch.zeros(D, dtype=dtype, device=dev)}
    if spec.mlp != "none":
        p["norm2"] = torch.zeros(D, dtype=dtype, device=dev)
    if spec.kind == "mla":
        p["attn"] = L.init_mla(gen, D, cfg.n_heads, kv_lora=cfg.kv_lora, d_nope=cfg.d_nope,
                               d_rope=cfg.d_rope, d_v=cfg.head_dim, dtype=dtype)
    elif spec.kind == "mamba":
        p["attn"] = L.init_mamba(gen, D, d_state=cfg.d_state, d_conv=cfg.d_conv,
                                 expand=cfg.expand, dt_rank=cfg.dt_rank_eff, dtype=dtype)
    else:
        p["attn"] = L.init_attention(gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype)
    if spec.mlp == "moe":
        p["mlp"] = L.init_moe(gen, D, cfg.d_ff_expert, cfg.n_experts, cfg.n_shared,
                              cfg.d_ff_expert, dtype)
    elif spec.mlp == "dense":
        p["mlp"] = L.init_mlp(gen, D, cfg.d_ff, dtype)
    if spec.cross_attn:
        p["normc"] = torch.zeros(D, dtype=dtype, device=dev)
        p["cross"] = L.init_attention(gen, D, cfg.n_heads, cfg.n_heads, cfg.head_dim, dtype)
    return p


def _as_parameters(tree):
    if isinstance(tree, dict):
        return nn.ParameterDict({k: _as_parameters(v) for k, v in tree.items()})
    return nn.Parameter(tree, requires_grad=False)


def _as_tensors(mod):
    if isinstance(mod, nn.ParameterDict):
        return {k: _as_tensors(v) for k, v in mod.items()}
    return mod


class Model(nn.Module):
    """The model as a module: the parameters of :func:`init_params`
    (or ``params``, e.g. from ``interop.model_params_from_jax``) on the
    card unless ``device`` says otherwise, and :func:`forward` over them.
    The encoder's parameters are ``enc`` (its norm and positions) and
    ``enc_layers``.  Serving holds them frozen (``requires_grad=False``);
    training builds its own leaves (``launch.train.build_state``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 params: Optional[dict] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        self.top = _as_parameters({k: v for k, v in params.items() if k not in ("layers", "enc")})
        self.layers = nn.ModuleList(_as_parameters(lp) for lp in params["layers"])
        if "enc" in params:
            enc = params["enc"]
            self.enc = _as_parameters({k: v for k, v in enc.items() if k != "layers"})
            self.enc_layers = nn.ModuleList(_as_parameters(lp) for lp in enc["layers"])

    def params(self) -> dict:
        """The parameters as the dict :func:`forward` takes."""
        out = {**_as_tensors(self.top), "layers": [_as_tensors(m) for m in self.layers]}
        if hasattr(self, "enc"):
            out["enc"] = {**_as_tensors(self.enc),
                          "layers": [_as_tensors(m) for m in self.enc_layers]}
        return out

    def forward(self, tokens=None, **kw):
        return forward(self.params(), self.cfg, tokens, **kw)


# ------------------------------------------------------------------ cache
def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device=None, enc_len: int = 0) -> list:
    """Decode caches, one dict per layer in the order of
    :func:`layer_specs`: on a GQA layer ``k`` and ``v`` (batch, C,
    n_kv_heads, head_dim) with ``C = min(s_max, window)`` on window layers
    and ``s_max`` on global ones; on an MLA layer the compressed ``c_kv``
    (batch, s_max, kv_lora) and ``k_rope`` (batch, s_max, d_rope); on
    both ``pos_k`` (batch, C) int32 at int32 max.  A Mamba layer holds
    ``conv`` (batch, d_conv - 1, d_inner) in ``dtype`` and ``h`` (batch,
    d_inner, d_state) in float32 whatever ``dtype``; a cross-attention
    layer adds ``ck`` and ``cv`` (batch, enc_len, n_heads, head_dim)."""
    check_supported(cfg)
    dev = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def layer_cache(spec):
        if spec.kind == "mamba":
            c = {"conv": zeros(batch, cfg.d_conv - 1, cfg.d_inner),
                 "h": zeros(batch, cfg.d_inner, cfg.d_state, dt=torch.float32)}
        elif spec.kind == "mla":
            c = {"c_kv": zeros(batch, s_max, cfg.kv_lora),
                 "k_rope": zeros(batch, s_max, cfg.d_rope),
                 "pos_k": torch.full((batch, s_max), L.INT32_MAX, dtype=torch.int32,
                                     device=dev)}
        else:
            C = min(s_max, spec.window) if spec.window else s_max
            c = {"k": zeros(batch, C, cfg.n_kv_heads, cfg.head_dim),
                 "v": zeros(batch, C, cfg.n_kv_heads, cfg.head_dim),
                 "pos_k": torch.full((batch, C), L.INT32_MAX, dtype=torch.int32, device=dev)}
        if spec.cross_attn:
            c["ck"] = zeros(batch, enc_len, cfg.n_heads, cfg.head_dim)
            c["cv"] = zeros(batch, enc_len, cfg.n_heads, cfg.head_dim)
        return c

    return [layer_cache(spec) for spec in layer_specs(cfg)]


# ------------------------------------------------------------------ forward
def _cross_attention(p, h, ck, cv, head_dim):
    """Cross-attention of ``h`` over the encoder's keys and values, with
    no mask: float32 scores over sqrt(head_dim), a float32 ``p·cv`` cast
    to ``h``'s dtype, then ``wo``."""
    B, S, _ = h.shape
    q = L._heads(h, p["wq"])
    s = torch.einsum("bshk,bthk->bsht", q.float(), ck.float()) / math.sqrt(head_dim)
    o = torch.einsum("bsht,bthk->bshk", s.softmax(-1), cv.float()).to(h.dtype)
    H, hd, D = p["wo"].shape
    return o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)


def _apply_layer(lp, spec: LayerSpec, cfg: ModelConfig, x, positions, cache, decode,
                 enc_out=None, mesh=None):
    h = L.rms_norm(x, lp["norm1"])
    if spec.kind == "mamba":
        out, new_c = L.mamba_apply(lp["attn"], h, d_state=cfg.d_state, d_conv=cfg.d_conv,
                                   cache=cache, decode=decode)
    elif spec.kind == "mla":
        out, new_c = L.mla_attention(lp["attn"], h, positions, d_nope=cfg.d_nope,
                                     d_rope=cfg.d_rope, rope_theta=cfg.rope_theta,
                                     cache=cache, decode=decode)
    else:
        out, new_c = L.attention(lp["attn"], h, positions,
                                 n_rep=cfg.n_heads // cfg.n_kv_heads, window=spec.window,
                                 rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
                                 cache=cache, decode=decode)
    x = x + out
    if spec.cross_attn:
        # Decode reads the encoder's keys and values from the cache (the
        # dict attention wrote in place, so new_c holds them); prefill
        # computes them from enc_out and stores them in x's dtype.
        h = L.rms_norm(x, lp["normc"])
        if decode:
            ck, cv = cache["ck"], cache["cv"]
        else:
            ck, cv = L._heads(enc_out, lp["cross"]["wk"]), L._heads(enc_out, lp["cross"]["wv"])
            if new_c is not None:
                new_c.update(ck=ck.to(x.dtype), cv=cv.to(x.dtype))
        x = x + _cross_attention(lp["cross"], h, ck, cv, cfg.head_dim)
    if spec.mlp == "none":
        return x, new_c
    h = L.rms_norm(x, lp["norm2"])
    if spec.mlp == "moe":
        out = _moe(lp["mlp"], h, cfg, mesh)
        if "shared" in lp["mlp"]:
            out = out + L.mlp_apply(lp["mlp"]["shared"], h)
    else:
        out = L.mlp_apply(lp["mlp"], h)
    return x + out, new_c


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _moe(mp, h, cfg: ModelConfig, mesh=None):
    """The routed experts: the local form, or under a mesh with a
    ``model`` axis and ``cfg.moe_ep`` the expert-parallel one (the
    reference's ``shard_map`` over that axis).  Then the ranks of a
    ``model`` group hold the same tokens (the batch is split over the
    other axes only) and whole, equal parameters; rank i computes experts
    ``[i·E/ep, (i+1)·E/ep)`` over the tokens of every peer.  The result
    is the local form's, and so is each rank's gradient, as the
    reference's ``shard_map`` transpose gives it: the output's gradient
    is divided among the ep replicas that each count it, and the
    gradients of the replicated inputs (the tokens, the router and the
    expert stacks, of which each rank fills its slice) are summed over
    the group.  The shared experts stay outside, on every rank.  So the
    compute is split and the memory is not: every rank holds every expert
    and its optimizer state, and each expert stack's whole gradient is
    all-reduced, where the reference keeps one E/ep slice per rank
    (ROADMAP.md section A, item 5)."""
    routed = {k: mp[k] for k in ("router", "w_gate", "w_up", "w_down")}
    if not (cfg.moe_ep and mesh is not None and "model" in mesh.mesh_dim_names):
        return L.moe_apply(routed, h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    group = mesh.get_group("model")
    ep, i = dist.get_world_size(group), mesh.get_local_rank("model")
    n = cfg.n_experts // ep
    h = _SumGrad.apply(h, group)
    local = {k: _SumGrad.apply(w, group) for k, w in routed.items()}
    for k in ("w_gate", "w_up", "w_down"):
        local[k] = local[k][i * n:(i + 1) * n]
    y = L.moe_apply(local, h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                    ep_group=group, ep_size=ep)
    return _ScaleGrad.apply(y, 1.0 / ep)


def _rows(table, idx):
    """``table[idx]`` for an integer ``idx``, by ``embedding``: its
    backward adds the gradient rows of repeated indices in a fixed order.
    Indexing's backward (``index_put_`` with accumulate) adds them with
    atomic float adds across the intra-op threads on the CPU, whose order,
    and so whose last bits, change from run to run.  A negative index
    counts from the end, as in indexing (a padded batch's masked ``-1``
    among the inputs reads the last row, as the reference's does)."""
    return nn.functional.embedding(torch.where(idx < 0, idx + table.shape[0], idx), table)


#: The products ``remat="dots"`` keeps for the backward: matmuls with no
#: batch dims, which the port's projections (``x @ w``, w 2-D) lower to;
#: the attention's per-head scores and the expert stacks are ``bmm``s and
#: are recomputed, as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
#: does.
DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _rematted(fn, remat: str):
    """``fn`` (tensor -> tensor) run under ``torch.utils.checkpoint``:
    "full" keeps only its input for the backward and recomputes the
    rest; "dots" keeps the outputs of :data:`DOTS_SAVED` too; "none"
    leaves ``fn`` as it is."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda x: ckpt.checkpoint(fn, x, use_reentrant=False)
    if remat == "dots":
        return lambda x: ckpt.checkpoint(
            fn, x, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(DOTS_SAVED))
    raise ValueError(f"remat must be none, full or dots, not {remat!r}")


def _encode(params, cfg: ModelConfig, frames, cdt, remat="none"):
    """The encoder over ``frames`` (B, Te, D): learned positions 0..Te-1,
    dense attention layers run as causal attention with every position 0
    (so the mask passes everywhere: the reference's bidirectional
    encoder), then its final norm.  Each layer is one ``remat`` region."""
    enc = params["enc"]
    B, Te, _ = frames.shape
    pos = torch.arange(Te, device=frames.device)
    e = frames.to(cdt) + _rows(enc["pos_embed"], pos).to(cdt)
    zeros = torch.zeros((B, Te), dtype=torch.int32, device=frames.device)
    for lp in enc["layers"]:
        e = _rematted(lambda h, lp=lp: _apply_layer(lp, ENC_SPEC, cfg, h, zeros, None,
                                                    False)[0], remat)(e)
    return L.rms_norm(e, enc["final_norm"])


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None, positions=None,
            caches=None, mode: str = "train", enc_frames=None, mesh=None):
    """Forward pass.

    mode='train'   : full-sequence causal logits.
    mode='prefill' : as train, but fills and returns the decode caches
                     (one per layer, or None where ``caches`` is None).
    mode='decode'  : tokens (B,1) against ``caches``, written in place;
                     positions (B,1).

    ``embeds`` (B, Lv, D) is the vision stub's prefix, put before the
    tokens' embeddings.  Without RoPE, ``pos_embed`` at the positions is
    added to them.  The encoder-decoder encodes ``enc_frames`` (B, Te,
    D) in train and prefill mode (decode reads the cross-attention
    caches).  Embeddings, the layers and the head run in
    ``cfg.compute_dtype``; the tied head is ``x @ embed.T`` in it.
    ``mesh`` (a ``DeviceMesh``) is read by the MoE only (:func:`_moe`).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, not {mode!r}")
    check_supported(cfg)
    cdt = _dtype(cfg.compute_dtype)
    decode = mode == "decode"

    parts = []
    if embeds is not None:
        parts.append(embeds.to(cdt))
    if tokens is not None:
        parts.append(_rows(params["embed"], tokens).to(cdt))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    if not cfg.use_rope:
        x = x + _rows(params["pos_embed"], positions).to(cdt)
    remat = cfg.remat if mode == "train" else "none"
    enc_out = None
    if cfg.kind == "encdec" and not decode:
        enc_out = _encode(params, cfg, enc_frames, cdt, remat)

    specs = layer_specs(cfg)
    caches = caches if caches is not None else [None] * len(specs)
    new_caches = [None] * len(specs)

    def instance(h, span):
        for j in span:
            h, new_caches[j] = _apply_layer(params["layers"][j], specs[j], cfg, h, positions,
                                            caches[j], decode, enc_out, mesh)
        return h

    # One remat region per instance of a block pattern: the reference's
    # checkpointed scan body (jamba's 8 layers are one).
    start = 0
    for pattern, reps in cfg.blocks:
        for _ in range(reps):
            span = range(start, start + len(pattern))
            start += len(pattern)
            x = _rematted(lambda h, span=span: instance(h, span), remat)(x)

    x = L.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(cdt)
    if mode == "train":
        return logits
    return logits, new_caches


def lm_loss(params, cfg: ModelConfig, batch, mesh=None):
    """Next-token cross entropy, the reference's ``lm_loss``:
    ``batch["tokens"]`` (B, S + 1) integer, the first S the inputs and
    the last S the targets; float32 logits, ``logsumexp`` less the
    target's logit, averaged over the targets >= 0 (a negative target is
    masked out).  The vision stub's ``patch_embeds`` go before the
    tokens, and only the text positions' logits are scored; an
    encoder-decoder encodes ``audio_frames``.  ``mesh`` as in
    :func:`forward`."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    kw = {}
    if cfg.frontend == "vision_stub":
        kw["embeds"] = batch["patch_embeds"]
    if cfg.kind == "encdec":
        kw["enc_frames"] = batch["audio_frames"]
    logits = forward(params, cfg, inputs, mesh=mesh, **kw)
    if cfg.frontend == "vision_stub":
        logits = logits[:, -targets.shape[1]:]
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    ll = logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)
