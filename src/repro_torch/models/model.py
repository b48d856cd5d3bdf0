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
device mesh and change no value: ``launch.steps`` gives their specs, the
serving steps cut the caches' sequences where ``cache_specs`` does
(``seq_shard_kv`` among them; ``distributed.sequence``), and
``seq_parallel`` cuts the stream between layers on its sequence
(below); ``scan_unroll`` changes nothing in the port.
``remat`` ("full" or "dots") checkpoints each instance of a block
pattern in train mode, as the reference checkpoints its scan body
(:func:`_rematted`): the same values, with less held for the backward.
:func:`lm_loss` is the training objective; under a mesh with a ``model``
axis and ``moe_ep`` the MoE takes its expert-parallel form (:func:`_moe`).
With a plan (:func:`sharding` of ``launch.steps.param_specs``) the
parameters are each rank's blocks (``distributed.sharded``): each leaf
is gathered where its layer runs, inside the layer's remat region, and
what the backward needs of it is gathered again (:func:`_gathering`).  Under a mesh whose
``model`` axis has more than one rank the compute is then cut over it
as the specs cut the leaves (``distributed.tensor_parallel``): a layer
whose q heads, ``d_ff``, ``d_inner`` or routed experts arrive as the
rank's block computes the rank's heads, channels or experts between
``copy_to_model`` and ``reduce_from_model``, and the vocabulary's
lookup, head and loss work on the rank's rows of it; a layer whose
leaves arrive whole computes replicated.  With ``cfg.seq_parallel``
(the plan's ``sp``, in train and prefill mode) the stream between
layers is the rank's block of the sequence (Megatron-SP): the norms run
on it, each block opens with ``gather_seq`` and closes with
``reduce_scatter_seq`` (cut) or ``own_seq_block`` (replicated), and the
remat regions save the block.  A decode step's single position keeps
the replicated stream.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch._device import resolve_device
from repro_torch._tree import at, map_tree
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
def init_params(cfg: ModelConfig, generator: torch.Generator, place=None) -> dict:
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
    held in float32.  ``place(path, leaf)``, where given, takes each leaf
    as soon as it is drawn, named by its path (``layers/3/attn/wq``), and
    what it returns is kept: ``launch.train.build_state`` keeps a rank's
    block, so no more than one whole leaf is held at a time."""
    check_supported(cfg)
    dtype, dev = _dtype(cfg.param_dtype), generator.device
    D = cfg.d_model
    place = place or L._kept
    params = {"embed": place("embed", L._init(generator, (cfg.vocab_size, D), scale=0.02,
                                               dtype=dtype)),
              "final_norm": place("final_norm", torch.zeros(D, dtype=dtype, device=dev))}
    if not cfg.tie_embeddings:
        params["lm_head"] = place("lm_head", L._init(generator, (D, cfg.vocab_size), dtype=dtype))
    if not cfg.use_rope:
        params["pos_embed"] = place("pos_embed", L._init(generator, (cfg.max_seq, D), scale=0.02,
                                                         dtype=dtype))
    params["layers"] = [_init_layer(generator, spec, cfg, dtype, _under(place, f"layers/{j}"))
                        for j, spec in enumerate(layer_specs(cfg))]
    if cfg.kind == "encdec":
        params["enc"] = {
            "layers": [_init_layer(generator, ENC_SPEC, cfg, dtype,
                                   _under(place, f"enc/layers/{j}"))
                       for j in range(cfg.n_enc_layers)],
            "final_norm": place("enc/final_norm", torch.zeros(D, dtype=dtype, device=dev)),
            "pos_embed": place("enc/pos_embed", L._init(generator, (cfg.max_seq, D), scale=0.02,
                                                        dtype=dtype)),
        }
    return params


def _under(place, head):
    """``place`` for the leaves under ``head``, named from there."""
    return lambda name, t: place(f"{head}/{name}", t)


def _init_layer(gen, spec: LayerSpec, cfg: ModelConfig, dtype, place) -> dict:
    D, dev = cfg.d_model, gen.device
    p = {"norm1": place("norm1", torch.zeros(D, dtype=dtype, device=dev))}
    if spec.mlp != "none":
        p["norm2"] = place("norm2", torch.zeros(D, dtype=dtype, device=dev))
    if spec.kind == "mla":
        p["attn"] = L.init_mla(gen, D, cfg.n_heads, kv_lora=cfg.kv_lora, d_nope=cfg.d_nope,
                               d_rope=cfg.d_rope, d_v=cfg.head_dim, dtype=dtype,
                               place=_under(place, "attn"))
    elif spec.kind == "mamba":
        p["attn"] = L.init_mamba(gen, D, d_state=cfg.d_state, d_conv=cfg.d_conv,
                                 expand=cfg.expand, dt_rank=cfg.dt_rank_eff, dtype=dtype,
                                 place=_under(place, "attn"))
    else:
        p["attn"] = L.init_attention(gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype,
                                     place=_under(place, "attn"))
    if spec.mlp == "moe":
        p["mlp"] = L.init_moe(gen, D, cfg.d_ff_expert, cfg.n_experts, cfg.n_shared,
                              cfg.d_ff_expert, dtype, place=_under(place, "mlp"))
    elif spec.mlp == "dense":
        p["mlp"] = L.init_mlp(gen, D, cfg.d_ff, dtype, place=_under(place, "mlp"))
    if spec.cross_attn:
        p["normc"] = place("normc", torch.zeros(D, dtype=dtype, device=dev))
        p["cross"] = L.init_attention(gen, D, cfg.n_heads, cfg.n_heads, cfg.head_dim, dtype,
                                      place=_under(place, "cross"))
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
def cache_length(spec: LayerSpec, s_max: int) -> int:
    """The slots of a layer's cache: ``min(s_max, window)`` on a window
    layer, ``s_max`` on a global or MLA one."""
    return min(s_max, spec.window) if spec.window else s_max


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device=None, enc_len: int = 0, *, n_kv_heads: Optional[int] = None,
               n_heads: Optional[int] = None, d_inner: Optional[int] = None,
               lengths: Optional[list] = None) -> list:
    """Decode caches, one dict per layer in the order of
    :func:`layer_specs`: on a GQA layer ``k`` and ``v`` (batch, C,
    n_kv_heads, head_dim) with ``C = min(s_max, window)`` on window layers
    and ``s_max`` on global ones; on an MLA layer the compressed ``c_kv``
    (batch, s_max, kv_lora) and ``k_rope`` (batch, s_max, d_rope); on
    both ``pos_k`` (batch, C) int32 at int32 max.  A Mamba layer holds
    ``conv`` (batch, d_conv - 1, d_inner) in ``dtype`` and ``h`` (batch,
    d_inner, d_state) in float32 whatever ``dtype``; a cross-attention
    layer adds ``ck`` and ``cv`` (batch, enc_len, n_heads, head_dim).
    ``n_kv_heads``, ``n_heads`` and ``d_inner`` are the config's unless
    given, and so are the slots (:func:`cache_length`) unless ``lengths``
    gives each layer's: a rank holds its share of those that are cut, and
    its block of a sequence cut over a group (``launch.steps.cache_blocks``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n_kv_heads = n_kv_heads or cfg.n_kv_heads
    n_heads = n_heads or cfg.n_heads
    d_inner = d_inner or cfg.d_inner

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def layer_cache(spec, C):
        if spec.kind == "mamba":
            c = {"conv": zeros(batch, cfg.d_conv - 1, d_inner),
                 "h": zeros(batch, d_inner, cfg.d_state, dt=torch.float32)}
        elif spec.kind == "mla":
            c = {"c_kv": zeros(batch, C, cfg.kv_lora),
                 "k_rope": zeros(batch, C, cfg.d_rope),
                 "pos_k": torch.full((batch, C), L.INT32_MAX, dtype=torch.int32, device=dev)}
        else:
            c = {"k": zeros(batch, C, n_kv_heads, cfg.head_dim),
                 "v": zeros(batch, C, n_kv_heads, cfg.head_dim),
                 "pos_k": torch.full((batch, C), L.INT32_MAX, dtype=torch.int32, device=dev)}
        if spec.cross_attn:
            c["ck"] = zeros(batch, enc_len, n_heads, cfg.head_dim)
            c["cv"] = zeros(batch, enc_len, n_heads, cfg.head_dim)
        return c

    specs = layer_specs(cfg)
    lengths = lengths or [cache_length(spec, s_max) for spec in specs]
    return [layer_cache(spec, C) for spec, C in zip(specs, lengths)]


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


def _own_channels(in_proj, d_inner: int, n: int, tp):
    """The rank's x columns then its z columns of a whole ``in_proj``
    (D, 2·d_inner), for its ``n`` channels."""
    lo = tp.rank * n
    return torch.cat([in_proj[:, lo:lo + n], in_proj[:, d_inner + lo:d_inner + lo + n]], 1)


def _apply_layer(lp, spec: LayerSpec, cfg: ModelConfig, x, positions, cache, decode,
                 enc_out=None, mesh=None, tp=None, seq=None, sp=None):
    """One layer.  ``tp`` (this rank's ``model`` group under tensor
    parallelism, else None): a mixer, cross-attention or dense MLP whose
    leaves arrive as the rank's blocks of heads, channels or ``d_ff``
    computes its part between ``copy_to_model`` and ``reduce_from_model``;
    one whose leaves arrive whole computes replicated.  ``seq`` (a
    ``distributed.sequence.SeqCut``, else None): the layer's cache holds
    the rank's block of its sequence; where the cut is over ``model`` and
    the q heads are too, the attention gathers the q heads over it.
    ``sp`` (a ``tensor_parallel.SeqSplit``, else None): ``x`` is the
    rank's block of the sequence; each block gathers the normed stream
    (``gather_seq``) and gives back the rank's block of its output
    (``reduce_scatter_seq`` of the partial sums of a cut block,
    ``own_seq_block`` of a replicated one's), and ``enc_out`` is the
    encoder's output gathered whole."""
    from repro_torch.distributed import tensor_parallel as TP

    def enter(h, cut):
        return TP.copy_to_model(h, cut) if sp is None else TP.gather_seq(h, sp)

    def leave(out, cut):
        if sp is None:
            return TP.reduce_from_model(out, cut)
        return TP.own_seq_block(out, sp) if cut is None else TP.reduce_scatter_seq(out, sp)

    h = L.rms_norm(x, lp["norm1"])
    a = lp["attn"]
    if spec.kind == "mamba":
        n = a["conv_w"].shape[1]
        cut = tp if tp is not None and n < cfg.d_inner else None
        if cut is not None:
            a = dict(a, in_proj=_own_channels(a["in_proj"], cfg.d_inner, n, tp))
        out, new_c = L.mamba_apply(a, enter(h, cut), d_state=cfg.d_state,
                                   d_conv=cfg.d_conv, cache=cache, decode=decode,
                                   proj_sum=None if cut is None else
                                   lambda t: TP.sum_both_ways(t, cut))
    else:
        n = a["wq"].shape[1]
        cut = tp if tp is not None and n < cfg.n_heads else None
        q_group = cut if seq is not None and "model" in seq.axes else None
        if spec.kind == "mla":
            out, new_c = L.mla_attention(a, enter(h, cut), positions,
                                         d_nope=cfg.d_nope, d_rope=cfg.d_rope,
                                         rope_theta=cfg.rope_theta, cache=cache, decode=decode,
                                         seq=seq, q_group=q_group)
        else:
            kv_whole = cut is not None and a["wk"].shape[1] == cfg.n_kv_heads
            out, new_c = L.attention(a, enter(h, cut), positions,
                                     n_rep=cfg.n_heads // cfg.n_kv_heads, window=spec.window,
                                     rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
                                     cache=cache, decode=decode,
                                     q_head0=tp.rank * n if kv_whole else None,
                                     seq=seq, q_group=q_group)
    x = x + leave(out, cut)
    if spec.cross_attn:
        # Decode reads the encoder's keys and values from the cache (the
        # dict attention wrote in place, so new_c holds them); prefill
        # computes them from enc_out and stores them in x's dtype.
        c = lp["cross"]
        cut = tp if tp is not None and c["wq"].shape[1] < cfg.n_heads else None
        h = enter(L.rms_norm(x, lp["normc"]), cut)
        if decode:
            ck, cv = cache["ck"], cache["cv"]
        else:
            e = enc_out if sp is not None else TP.copy_to_model(enc_out, cut)
            ck, cv = L._heads(e, c["wk"]), L._heads(e, c["wv"])
            if new_c is not None:
                new_c.update(ck=ck.to(x.dtype), cv=cv.to(x.dtype))
        x = x + leave(_cross_attention(c, h, ck, cv, cfg.head_dim), cut)
    if spec.mlp == "none":
        return x, new_c
    h = L.rms_norm(x, lp["norm2"])
    if sp is not None:      # one gather for the routed and the shared experts
        h = TP.gather_seq(h, sp)

    def dense(mp, width):
        cut = tp if tp is not None and mp["w_gate"].shape[1] < width else None
        return leave(L.mlp_apply(mp, h if sp is not None else TP.copy_to_model(h, cut)), cut)

    if spec.mlp == "moe":
        out = _moe(lp["mlp"], h, cfg, mesh, tp, sp)
        if "shared" in lp["mlp"]:
            out = out + dense(lp["mlp"]["shared"], cfg.n_shared * cfg.d_ff_expert)
    else:
        out = dense(lp["mlp"], cfg.d_ff)
    return x + out, new_c


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _ep(cfg: ModelConfig, mesh) -> bool:
    """Whether the MoE takes its expert-parallel form over ``model``."""
    return bool(cfg.moe_ep and mesh is not None and "model" in mesh.mesh_dim_names)


EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def _moe(mp, h, cfg: ModelConfig, mesh=None, tp=None, sp=None):
    """The routed experts, in the stream's layout (``sp``: ``h`` is the
    whole sequence gathered, and the output the rank's block of it).

    The local form computes every expert.  Where a plan's ``tp`` holds
    the stacks as the rank's E/tp slice (the specs cut E over ``model``)
    without expert parallelism, every rank of the group runs the same
    dispatch over the same tokens (the same capacity, the same drops),
    computes the rows of its own experts only (``moe_apply``'s
    ``expert_range``), and the group sums the partial outputs: the local
    form's value up to the order of the top-k sum.  The tokens and the
    router enter through ``copy_to_model`` (their gradients are partial
    sums over the group; under ``sp`` ``gather_seq`` sums the tokens' and
    ``launch.steps.partial_grad_paths`` the router's).

    Under a mesh with a ``model`` axis and ``cfg.moe_ep`` the
    expert-parallel form (the reference's ``shard_map`` over that axis):
    the ranks of a ``model`` group hold the same tokens (the batch is
    split over the other axes only); rank i computes experts
    ``[i·E/ep, (i+1)·E/ep)`` over the tokens of every peer.  The result
    is the local form's, and so is each rank's gradient, as the
    reference's ``shard_map`` transpose gives it: the output's gradient
    is divided among the ep replicas that each read it whole, and the
    gradients of the replicated inputs (the tokens and the router) are
    summed over the group.  Under ``sp`` each rank reads only its block
    of the output, so nothing is divided, and the sums are made as in the
    cut form.  The shared experts stay outside, on every rank.

    A sharded state (:func:`forward`'s ``plan``) stores each expert
    stack as the rank's E/ep slice, as the reference's ``P("model")``
    does, and the slice's gradient is the rank's own: no whole (E, D, F)
    stack is held or all-reduced.  A whole state (every rank the same
    parameters) holds every stack whole; the rank takes its slice, and
    the stack's gradient, of which each rank filled its slice, is summed
    over the group."""
    from repro_torch.distributed import tensor_parallel as TP
    routed = {k: mp[k] for k in ("router", *EXPERT_STACKS)}
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    n = routed["w_gate"].shape[0]
    if not _ep(cfg, mesh):
        if tp is None or n == cfg.n_experts:
            y = L.moe_apply(routed, h, **kw)
            return y if sp is None else TP.own_seq_block(y, sp)
        if sp is None:
            h = TP.copy_to_model(h, tp)
            routed["router"] = TP.copy_to_model(routed["router"], tp)
        y = L.moe_apply(routed, h, expert_range=(tp.rank * n, n), **kw)
        return TP.reduce_from_model(y, tp) if sp is None else TP.reduce_scatter_seq(y, sp)
    group = mesh.get_group("model")
    ep, i = dist.get_world_size(group), mesh.get_local_rank("model")
    grp = TP.ModelGroup(group, ep, i)
    n = cfg.n_experts // ep
    if sp is None:
        h = TP.copy_to_model(h, grp)
        routed["router"] = TP.copy_to_model(routed["router"], grp)
    for k in EXPERT_STACKS:
        w = routed[k]
        routed[k] = w if w.shape[0] == n else TP.copy_to_model(w, grp)[i * n:(i + 1) * n]
    y = L.moe_apply(routed, h, ep_group=group, ep_size=ep, **kw)
    return _ScaleGrad.apply(y, 1.0 / ep) if sp is None else TP.own_seq_block(y, sp)


class Sharding(NamedTuple):
    """How the sharded path reads this rank's blocks over a mesh, worked
    out once from the specs (:func:`sharding`)."""
    gathers: dict       # {path: (spec, mesh, keep, summed)}: the leaves with a gather to make
    holding: frozenset  # the paths of the subtrees that hold such a leaf
    tp: Any             # the rank's ``model`` group where the compute is cut over it, else None
    embed_tp: Any       # ``tp`` where the embedding's rows (the vocabulary) are cut, else None
    head_tp: Any        # ``tp`` where the head's columns are cut (the logits the rank's)
    seq: tuple = ()     # per layer, its cache's ``sequence.SeqCut`` or None; () without caches
    sp: Any = None      # ``tp`` where the stream is cut on its sequence (``seq_parallel``)


def sharding(cfg: ModelConfig, mesh, specs, cache_specs=None, s_max=None,
             decode: bool = False) -> Sharding:
    """The :class:`Sharding` of ``specs`` (``launch.steps.param_specs``,
    or ``tp_only`` of them) over ``mesh``.  Each leaf is gathered by
    ``tensor_parallel.gather_mode``: over the data axes only where the
    rank computes with its block over ``model`` (an expert stack, its
    E/tp slice, among them), else whole; a leaf with nothing left to
    gather (no other axis of more than one rank cuts it) is used as its
    block and has no entry.  With the caches' ``cache_specs``
    (``launch.steps.cache_specs``) each layer's sequence cut of a cache
    of ``s_max`` positions (``distributed.sequence.seq_cut`` of its ``k``
    or ``c_kv`` sequence entry; None where the entry names no axis of
    more than one rank).  ``sp`` is the ``model`` group where
    ``cfg.seq_parallel`` cuts the stream on its sequence: a group of more
    than one rank, in a train or prefill step (not ``decode``)."""
    from repro_torch.distributed import sequence as SQ
    from repro_torch.distributed import sharded
    from repro_torch.distributed import tensor_parallel as TP
    tp = TP.model_group(mesh, specs)
    sp = tp if cfg.seq_parallel and not decode else None
    gathers = {}
    for path, spec in sharded.spec_paths(specs).items():
        mode = TP.gather_mode(path, spec, specs, mesh, sp is not None)
        keep = ("model",) if mode == "keep" else ()
        if any(a not in keep for axes in sharded.cut_axes(spec, mesh) for a in axes):
            gathers[path] = (spec, mesh, keep, ("model",) if mode == "sum" else ())

    def vocab(name):
        return tp if tp is not None and TP.cut_over_model(specs[name], mesh) else None

    holding = frozenset(p[:i] for p in gathers for i, c in enumerate(p) if c == "/")
    seq = ()
    if cache_specs is not None:
        seq = tuple(SQ.seq_cut(SQ.seq_entry(c), mesh, cache_length(spec, s_max))
                    for c, spec in zip(cache_specs, layer_specs(cfg)))
    return Sharding(gathers, holding, tp, vocab("embed"),
                    vocab("embed" if cfg.tie_embeddings else "lm_head"), seq, sp)


def _gathering(params, plan: Optional[Sharding]):
    """``whole(path)``: the parameter (a leaf or a layer's dict) at
    ``path`` as the layer computes with it.  Without a ``plan`` it is
    ``params``' own; with one ``params`` holds this rank's blocks and
    each leaf of ``plan.gathers`` is gathered
    (``distributed.sharded.gather``) as it says."""
    if plan is None:
        return lambda path: at(params, path)
    from repro_torch.distributed import sharded
    gathers = plan.gathers

    def leaf(path, block):
        how = gathers.get(path)
        return block if how is None else sharded.gather(block, *how)

    def whole(path):
        tree = at(params, path)
        if not isinstance(tree, dict):
            return leaf(path, tree)
        if path not in plan.holding:
            return tree
        return map_tree(lambda sub, block: leaf(f"{path}/{sub}", block), tree)

    return whole


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


def _encode(whole, cfg: ModelConfig, frames, cdt, remat="none", tp=None, sp=None):
    """The encoder over ``frames`` (B, Te, D): learned positions 0..Te-1,
    dense attention layers run as causal attention with every position 0
    (so the mask passes everywhere: the reference's bidirectional
    encoder), then its final norm.  Each layer is one ``remat`` region.
    ``whole`` gives the parameters (:func:`_gathering`), ``tp`` as in
    :func:`_apply_layer`.  ``sp`` (the ``model`` group under
    ``seq_parallel``): the layers run on the rank's block of the frames,
    and the output is gathered whole."""
    from repro_torch.distributed import tensor_parallel as TP
    B, Te, _ = frames.shape
    pos = torch.arange(Te, device=frames.device)
    e = frames.to(cdt)
    if sp is not None:
        sp = TP.SeqSplit(sp, Te)
        e, pos = TP.own_seq_block(e, sp), TP.own_seq_block(pos[None], sp)[0]
    e = e + _rows(whole("enc/pos_embed"), pos).to(cdt)
    zeros = torch.zeros((B, Te), dtype=torch.int32, device=frames.device)
    for j in range(cfg.n_enc_layers):
        e = _rematted(lambda h, j=j: _apply_layer(whole(f"enc/layers/{j}"), ENC_SPEC, cfg, h,
                                                  zeros, None, False, tp=tp, sp=sp)[0], remat)(e)
    e = L.rms_norm(e, whole("enc/final_norm"))
    return e if sp is None else TP.gather_seq(e, sp)


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None, positions=None,
            caches=None, mode: str = "train", enc_frames=None, mesh=None,
            plan: Optional[Sharding] = None):
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
    ``mesh`` (a ``DeviceMesh``) is read by the MoE (:func:`_moe`).  With
    ``plan`` (:func:`sharding` of ``launch.steps.param_specs`` over
    ``mesh``) ``params`` are this rank's blocks, gathered where each
    layer runs (:func:`_gathering`).  Under a ``model`` axis of more
    than one rank the compute is then cut over it (the module's
    docstring), the caches hold the rank's heads and channels where
    ``launch.steps.cache_specs`` cuts them, and where the vocabulary is
    cut the logits are the rank's columns (B, S, V/tp), never gathered.
    Where the plan's ``sp`` cuts the stream on its sequence (train and
    prefill), the stream is the rank's block from the lookup to the
    final norm, and the head reads the whole sequence gathered: the
    logits are those of every position.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, not {mode!r}")
    check_supported(cfg)
    if plan is None:
        return _forward(_gathering(params, None), cfg, tokens, embeds, positions, caches, mode,
                        enc_frames, mesh, None)
    from repro_torch.distributed import sharded
    with sharded.regather_on_unpack():
        return _forward(_gathering(params, plan), cfg, tokens, embeds, positions, caches, mode,
                        enc_frames, mesh, plan)


def _forward(whole, cfg, tokens, embeds, positions, caches, mode, enc_frames, mesh, plan):
    from repro_torch.distributed import tensor_parallel as TP
    tp = plan.tp if plan is not None else None
    seq = plan.seq if plan is not None and plan.seq else [None] * len(layer_specs(cfg))
    cdt = _dtype(cfg.compute_dtype)
    decode = mode == "decode"
    sp = plan.sp if plan is not None and not decode else None
    embed_tp = plan.embed_tp if plan is not None else None

    # The tied embedding is gathered once, for the lookup and the head,
    # so that its two gradients add before any reduction, as they do on a
    # whole leaf.
    embed = whole("embed") if tokens is not None or cfg.tie_embeddings else None
    parts = []
    if embeds is not None:   # under sp with a cut vocabulary, rank 0's part of the sum below
        parts.append(embeds.to(cdt) if sp is None or embed_tp is None or embed_tp.rank == 0
                     else embeds.new_zeros(embeds.shape, dtype=cdt))
    if tokens is not None:
        if embed_tp is None:
            rows = _rows(embed, tokens)
        elif sp is None:
            rows = TP.vocab_lookup(embed, tokens, embed_tp)
        else:
            rows = TP.vocab_rows(embed, tokens, embed_tp)
        parts.append(rows.to(cdt))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    block_pos = positions
    if sp is not None:       # the rank's block of the sequence from here to the final norm
        sp = TP.SeqSplit(sp, S)
        x = TP.own_seq_block(x, sp) if embed_tp is None else TP.reduce_scatter_seq(x, sp)
        block_pos = TP.own_seq_block(positions, sp)
    if not cfg.use_rope:
        x = x + _rows(whole("pos_embed"), block_pos).to(cdt)
    remat = cfg.remat if mode == "train" else "none"
    enc_out = None
    if cfg.kind == "encdec" and not decode:
        enc_out = _encode(whole, cfg, enc_frames, cdt, remat, tp,
                          None if sp is None else sp.tp)

    specs = layer_specs(cfg)
    caches = caches if caches is not None else [None] * len(specs)
    new_caches = [None] * len(specs)

    def instance(h, span):
        for j in span:
            h, new_caches[j] = _apply_layer(whole(f"layers/{j}"), specs[j], cfg, h, positions,
                                            caches[j], decode, enc_out, mesh, tp, seq[j], sp)
        return h

    # One remat region per instance of a block pattern: the reference's
    # checkpointed scan body (jamba's 8 layers are one).
    start = 0
    for pattern, reps in cfg.blocks:
        for _ in range(reps):
            span = range(start, start + len(pattern))
            start += len(pattern)
            x = _rematted(lambda h, span=span: instance(h, span), remat)(x)

    x = L.rms_norm(x, whole("final_norm"))
    head = embed.T if cfg.tie_embeddings else whole("lm_head")
    if sp is not None:
        x = TP.gather_seq(x, sp)
    elif plan is not None:
        x = TP.copy_to_model(x, plan.head_tp)     # the rank's columns of the logits
    logits = x @ head.to(cdt)
    if sp is not None and plan.head_tp is None:
        # every rank reads the whole logits with the same gradient: each
        # takes its block's part, so the head's gradient is partial too
        logits = TP.own_seq_grad(logits, sp)
    if mode == "train":
        return logits
    return logits, new_caches


def lm_loss(params, cfg: ModelConfig, batch, mesh=None, plan: Optional[Sharding] = None):
    """Next-token cross entropy, the reference's ``lm_loss``:
    ``batch["tokens"]`` (B, S + 1) integer, the first S the inputs and
    the last S the targets; float32 logits, ``logsumexp`` less the
    target's logit, averaged over the targets >= 0 (a negative target is
    masked out).  The vision stub's ``patch_embeds`` go before the
    tokens, and only the text positions' logits are scored; an
    encoder-decoder encodes ``audio_frames``.  ``mesh`` and ``plan`` as
    in :func:`forward`; where the logits are the rank's columns of the
    vocabulary, the loss is ``tensor_parallel.vocab_parallel_cross_entropy``."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    kw = {}
    if cfg.frontend == "vision_stub":
        kw["embeds"] = batch["patch_embeds"]
    if cfg.kind == "encdec":
        kw["enc_frames"] = batch["audio_frames"]
    logits = forward(params, cfg, inputs, mesh=mesh, plan=plan, **kw)
    if cfg.frontend == "vision_stub":
        logits = logits[:, -targets.shape[1]:]
    logits = logits.float()
    mask = (targets >= 0).float()
    if plan is not None and plan.head_tp is not None:
        from repro_torch.distributed import tensor_parallel as TP
        nll = TP.vocab_parallel_cross_entropy(logits, targets.clamp_min(0), plan.head_tp)
    else:
        lse = torch.logsumexp(logits, -1)
        nll = lse - logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
