"""Layers of the LLM scaffold, the port's counterpart of
``repro.models.layers``: RMSNorm, RoPE, the SwiGLU MLP, GQA attention
with its prefill and decode caches (the circular buffer of
sliding-window layers included, RoPE optional), MLA with its compressed
cache and absorbed decode, the top-k MoE with capacity dispatch (locally
or expert-parallel over a process group), and the Mamba-1 selective SSM
with its chunked scan.

Functional, as the reference is: parameters are dicts of tensors built by
the ``init_*`` functions from an explicit ``torch.Generator``, and the
apply functions take a leading batch axis.  The numerics follow the
reference's: RMSNorm and RoPE in float32, attention scores and the
attention output in float32 whatever the compute dtype (the reference's
``preferred_element_type=float32`` and its float32 ``p`` times a bf16
``v``).  MLA, the MoE and Mamba follow the reference's dtypes step by
step (see :func:`mla_attention`, :func:`moe_apply` and
:func:`mamba_apply`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

INT32_MAX = torch.iinfo(torch.int32).max


# --------------------------------------------------------------------- utils
def _init(gen, shape, scale=None, dtype=torch.float32):
    """A normal draw scaled by ``1/sqrt(fan_in)`` (``fan_in = shape[0]``)
    unless ``scale`` is given, drawn in float32 on the generator's device
    and cast: the reference's rule, the same distribution, not the same
    values."""
    fan_in = shape[0] if len(shape) else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(scale).to(dtype)


def _init_experts(gen, shape, dtype):
    """:func:`_init` of an (experts, fan_in, fan_out) stack, drawn one
    expert at a time so that no float32 copy of the whole stack is held.
    The scale is the reference's, ``1/sqrt(shape[0])``: its ``_init``
    takes the expert axis as fan-in."""
    scale = 1.0 / math.sqrt(max(1, shape[0]))
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        w[e] = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                           device=gen.device).mul_(scale)
    return w


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x, positions, *, theta: float = 10000.0):
    """Rotary embedding, the half-split rotation with float32 angles.
    x: (..., S, H, hd); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _silu(x):
    """silu as the reference lowers it: the logistic, then the product."""
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ----------------------------------------------------------------- attention
def init_attention(gen, d_model, n_heads, n_kv_heads, head_dim, dtype):
    return {
        "wq": _init(gen, (d_model, n_heads, head_dim), dtype=dtype),
        "wk": _init(gen, (d_model, n_kv_heads, head_dim), dtype=dtype),
        "wv": _init(gen, (d_model, n_kv_heads, head_dim), dtype=dtype),
        "wo": _init(gen, (n_heads, head_dim, d_model),
                    scale=1.0 / math.sqrt(n_heads * head_dim), dtype=dtype),
    }


def _heads(x, w):
    """x (B, S, D) times w (D, H, hd) -> (B, S, H, hd)."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(B, S, w.shape[1], w.shape[2])


def _gqa_scores(q, k, n_rep):
    """q: (B,S,H,hd), k: (B,T,Hkv,hd) -> (B,Hkv,S,n_rep,T) float32, by
    grouping the n_rep query heads of each KV head, never by repeating K.
    Both sides are cast to float32 first: bf16 to float32 is exact, so
    the products are the reference's bf16 products accumulated in
    float32.  The scores stay in the layout of the batched product that
    makes them, contiguous, so the softmax and its backward read them as
    they are where a (B,S,H,T) view would make each copy them."""
    B, S, H, hd = q.shape
    qg = q.float().view(B, S, H // n_rep, n_rep, hd)
    return torch.einsum("bsgrk,btgk->bgsrt", qg, k.float()) / math.sqrt(hd)


def _gqa_out(p, v, n_rep):
    """p: (B,Hkv,S,n_rep,T) float32, v: (B,T,Hkv,hd) -> (B,S,H,hd)
    float32, as the reference promotes float32 p times a bf16 v."""
    B, G, S, R, T = p.shape
    o = torch.einsum("bgsrt,btgk->bsgrk", p, v.float())
    return o.reshape(B, S, G * R, v.shape[-1])


def _softmax(scores, mask):
    return torch.where(mask, scores.float(), -1e30).softmax(-1)


def _prefill_cache(cache, k, v, positions, window):
    """The cache a prefill leaves: the prompt's k, v and positions padded
    to the buffer's length C with positions at int32 max, or, on a window
    layer whose buffer is shorter than the prompt, its last C positions
    placed at slot ``pos % C``."""
    B, S = positions.shape
    C = cache["k"].shape[1]
    if window is not None and C < S:
        # torch.roll of each row by positions[b, S - C] % C, as a gather.
        roll = positions[:, S - C].long() % C
        src = (torch.arange(C, device=k.device) - roll[:, None]) % C + (S - C)
        rows = torch.arange(B, device=k.device)[:, None]
        kc, vc, pc = k[rows, src], v[rows, src], positions[rows, src]
    else:
        if C < S:
            raise ValueError(f"a prompt of {S} positions does not fit a global "
                             f"layer's cache of {C}")
        kc = k.new_zeros((B, C) + k.shape[2:])
        vc = v.new_zeros((B, C) + v.shape[2:])
        pc = positions.new_full((B, C), INT32_MAX)
        kc[:, :S], vc[:, :S], pc[:, :S] = k, v, positions
    return {"k": kc.to(cache["k"].dtype), "v": vc.to(cache["v"].dtype),
            "pos_k": pc.to(torch.int32)}


def attention(params, x, positions, *, n_rep: int, window: Optional[int],
              rope_theta: float = 10000.0, use_rope: bool = True, cache=None,
              decode: bool = False):
    """GQA attention with an optional sliding window and KV cache; q and
    k are rotated by RoPE unless ``use_rope`` is False (learned positions).

    Train/prefill: x (B,S,D) under the causal (and window) mask; returns
    (out, new_cache), new_cache filled iff ``cache`` is given (prefill).
    Decode: x (B,1,D) against ``cache`` = dict(k, v, pos_k), a circular
    buffer of length min(s_max, window) on window layers and s_max on
    global ones: the token's k, v and position are written at slot
    ``pos % C`` of ``cache``'s tensors in place, and the same dict is
    returned.  Slots never written hold position int32 max, which the
    mask excludes.
    """
    B, S, _ = x.shape
    q, k, v = (_heads(x, params[w]) for w in ("wq", "wk", "wv"))
    if use_rope:
        q = rope(q, positions, theta=rope_theta)
        k = rope(k, positions, theta=rope_theta)

    if not decode:
        mask = positions[:, None, :] <= positions[:, :, None]
        if window is not None:
            mask = mask & (positions[:, None, :] > positions[:, :, None] - window)
        out = _gqa_out(_softmax(_gqa_scores(q, k, n_rep), mask[:, None, :, None, :]), v, n_rep)
        new_cache = None if cache is None else _prefill_cache(cache, k, v, positions, window)
    else:
        C = cache["k"].shape[1]
        pos = positions[:, 0]
        slot = pos.long() % C
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos_k"][rows, slot] = pos.to(torch.int32)
        pc = cache["pos_k"]
        valid = pc <= pos[:, None]
        if window is not None:
            valid = valid & (pc > pos[:, None] - window)
        scores = _gqa_scores(q, cache["k"], n_rep)  # (B,Hkv,1,n_rep,C)
        out = _gqa_out(_softmax(scores, valid[:, None, None, None, :]), cache["v"], n_rep)
        new_cache = cache

    H, hd, D = params["wo"].shape
    proj = out.to(x.dtype).reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, D)
    return proj, new_cache


# ----------------------------------------------------------------------- MLA
def init_mla(gen, d_model, n_heads, *, kv_lora, d_nope, d_rope, d_v, dtype):
    return {
        "wq": _init(gen, (d_model, n_heads, d_nope + d_rope), dtype=dtype),
        "w_dkv": _init(gen, (d_model, kv_lora), dtype=dtype),
        "w_kr": _init(gen, (d_model, d_rope), dtype=dtype),
        "w_uk": _init(gen, (kv_lora, n_heads, d_nope), dtype=dtype),
        "w_uv": _init(gen, (kv_lora, n_heads, d_v), dtype=dtype),
        "wo": _init(gen, (n_heads, d_v, d_model),
                    scale=1.0 / math.sqrt(n_heads * d_v), dtype=dtype),
    }


def _same_dtype(a, b):
    """``a`` and ``b`` in their promoted dtype, as a mixed einsum of the
    reference computes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mla_scores(spec, q, keys, q_r, k_r, scale):
    """The two score terms (``spec`` the first's einsum), each one matmul
    in the inputs' dtype (rounded once), added in that dtype, then cast
    to float32 and scaled: the reference's order, whose score einsums
    have no float32 output type."""
    s = torch.einsum(spec, *_same_dtype(q, keys))
    return (s + torch.einsum("bshr,btr->bsht", *_same_dtype(q_r, k_r))).float() * scale


def mla_attention(params, x, positions, *, d_nope: int, d_rope: int,
                  rope_theta: float = 10000.0, cache=None, decode: bool = False):
    """DeepSeek-V2 multi-head latent attention.

    The cache holds the compressed per-token state: ``c_kv`` (B, C,
    kv_lora), ``k_rope`` (B, C, d_rope) and ``pos_k`` (B, C) int32.
    Train/prefill take the plain form (keys and values expanded from
    ``c_kv``) under the causal mask; prefill returns the cache padded to C
    with positions at int32 max.  Decode takes the absorbed form: the
    token's state is written at slot ``pos % C`` in place (no window, so
    positions past C overwrite the oldest), ``W_uk`` folds into the query
    and ``W_uv`` into the output, and the scores are rank-``kv_lora``
    products against the cache.  ``p`` is float32, so ``p·v``, ``p·c_kv``
    and ``ctx·W_uv`` are float32 products, cast to ``x``'s dtype after.
    """
    B, S, _ = x.shape
    # A float32 scalar, as the reference's numpy float32 scale.
    scale = float(1.0 / np.sqrt(d_nope + d_rope).astype(np.float32))
    q = _heads(x, params["wq"])
    q_n = q[..., :d_nope]
    q_r = rope(q[..., d_nope:], positions, theta=rope_theta)
    c_kv = x @ params["w_dkv"]
    k_r = rope((x @ params["w_kr"])[:, :, None, :], positions, theta=rope_theta)[:, :, 0, :]

    if not decode:
        k_n = _heads(c_kv, params["w_uk"])
        v = _heads(c_kv, params["w_uv"])
        causal = positions[:, None, :] <= positions[:, :, None]
        p = _softmax(_mla_scores("bshk,bthk->bsht", q_n, k_n, q_r, k_r, scale),
                     causal[:, :, None, :])
        out = torch.einsum("bsht,bthk->bshk", p, v.float()).to(x.dtype)
        new_cache = None
        if cache is not None:
            C = cache["c_kv"].shape[1]
            if C < S:
                raise ValueError(f"a prompt of {S} positions does not fit an MLA "
                                 f"layer's cache of {C}")
            ckv = cache["c_kv"].new_zeros(cache["c_kv"].shape)
            krc = cache["k_rope"].new_zeros(cache["k_rope"].shape)
            pc = positions.new_full((B, C), INT32_MAX).to(torch.int32)
            ckv[:, :S], krc[:, :S], pc[:, :S] = c_kv, k_r, positions
            new_cache = {"c_kv": ckv, "k_rope": krc, "pos_k": pc}
    else:
        C = cache["c_kv"].shape[1]
        pos = positions[:, 0]
        slot = pos.long() % C
        rows = torch.arange(B, device=x.device)
        cache["c_kv"][rows, slot] = c_kv[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][rows, slot] = k_r[:, 0].to(cache["k_rope"].dtype)
        cache["pos_k"][rows, slot] = pos.to(torch.int32)
        ckv = cache["c_kv"]
        q_abs = torch.einsum("bshk,chk->bshc", q_n, params["w_uk"])
        valid = cache["pos_k"] <= pos[:, None]
        p = _softmax(_mla_scores("bshc,btc->bsht", q_abs, ckv, q_r, cache["k_rope"], scale),
                     valid[:, None, None, :])
        ctx = torch.einsum("bsht,btc->bshc", p, ckv.float())
        out = torch.einsum("bshc,chk->bshk", ctx, params["w_uv"].float()).to(x.dtype)
        new_cache = cache

    H, dv, D = params["wo"].shape
    proj = out.reshape(B, S, H * dv) @ params["wo"].reshape(H * dv, D)
    return proj, new_cache


# ----------------------------------------------------------------------- MLP
def init_mlp(gen, d_model, d_ff, dtype):
    return {
        "w_gate": _init(gen, (d_model, d_ff), dtype=dtype),
        "w_up": _init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": _init(gen, (d_ff, d_model), dtype=dtype),
    }


def mlp_apply(params, x):
    return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])


# ----------------------------------------------------------------------- MoE
def init_moe(gen, d_model, d_ff_expert, n_experts, n_shared, d_ff_shared, dtype):
    """The router, always float32 (the reference's), the (E, D, F) and
    (E, F, D) expert stacks, drawn one expert at a time, and the shared
    experts as one SwiGLU MLP of width ``n_shared * d_ff_shared``."""
    p = {
        "router": _init(gen, (d_model, n_experts), scale=0.02, dtype=torch.float32),
        "w_gate": _init_experts(gen, (n_experts, d_model, d_ff_expert), dtype),
        "w_up": _init_experts(gen, (n_experts, d_model, d_ff_expert), dtype),
        "w_down": _init_experts(gen, (n_experts, d_ff_expert, d_model), dtype),
    }
    if n_shared:
        p["shared"] = init_mlp(gen, d_model, n_shared * d_ff_shared, dtype)
    return p


def moe_capacity(tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: the reference's ``ceil(T·k/E·cf)``, at least k,
    in the same float expression so that ceil lands alike."""
    return max(int(np.ceil(tokens * top_k / n_experts * capacity_factor)), top_k)


def moe_dispatch(router, xt, top_k: int, capacity_factor: float):
    """Route the (T, D) tokens: a float32 softmax over ``xt @ router``,
    the k largest probabilities (descending, the lower expert first on
    ties, as ``lax.top_k``) as gates renormalised to sum to one and cast
    to ``xt``'s dtype, and each pick's row of the (E·C) dispatch buffer:
    a stable sort by expert ranks an expert's picks in token order, and
    a pick ranked C or later is dropped to row E·C.  Returns (gate (T,
    k), picks (T, k), dest (T·k,), C)."""
    T = xt.shape[0]
    E = router.shape[-1]
    probs = (xt.float() @ router).softmax(-1)
    gate, picks = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, picks = gate[:, :top_k], picks[:, :top_k]
    gate = (gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)).to(xt.dtype)
    C = moe_capacity(T, top_k, E, capacity_factor)
    flat = picks.reshape(-1)
    order = torch.argsort(flat, stable=True)
    by_expert = flat[order]
    first = torch.searchsorted(by_expert, torch.arange(E, device=xt.device))
    slot = torch.empty_like(flat)
    slot[order] = torch.arange(T * top_k, device=xt.device) - first[by_expert]
    dest = torch.where(slot < C, flat * C + slot, E * C)
    return gate, picks, dest, C


class _AllToAll(torch.autograd.Function):
    """The symmetric all_to_all over ``group``: chunk j of dim 0 goes to
    member j, which puts it at its chunk i (this rank's place in the
    group).  The exchange is its own transpose, so its backward is the
    same exchange of the gradient: why the reference keeps it symmetric."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x, group):
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              ep_group=None, ep_size: int = 1):
    """Top-k MoE with capacity dispatch.  x (B, S, D) -> (B, S, D).

    The T = B·S tokens of one call share each expert's C slots, so a
    token's output depends on the tokens routed before it.  Kept picks
    fill an (E, C, D) buffer (dropped ones write a spare row that is cut
    off and never read), every expert runs its C rows through SwiGLU as
    one batched matmul per weight, and each token gathers its k rows
    against a zero row for a dropped pick and sums them by its gates in
    one product over k in ``x``'s dtype.

    Expert-parallel form (``ep_size > 1``): every rank of the process
    group ``ep_group`` (of ``ep_size`` ranks) calls it with its own
    tokens, the whole router and its E/ep experts (rank i of the group
    holds experts ``[i·E/ep, (i+1)·E/ep)``).  Each rank dispatches its
    tokens over all E experts as the local form does, the (ep, E/ep, C,
    D) buffer goes through the reference's symmetric ``all_to_all``, each
    rank runs its experts over the ep·C rows of its peers, and the outputs
    come back by the same exchange.  Autograd carries it: on each rank
    the gradient is that of the sum of every rank's loss.
    """
    B, S, D = x.shape
    E = params["router"].shape[-1]
    if ep_size > 1:
        if ep_group is None or dist.get_world_size(ep_group) != ep_size:
            raise ValueError(f"the expert-parallel MoE needs an ep_group of ep_size = "
                             f"{ep_size} ranks")
        if E % ep_size or params["w_gate"].shape[0] != E // ep_size:
            raise ValueError(f"{E} experts over {ep_size} ranks: each rank holds E/ep, "
                             f"not {params['w_gate'].shape[0]}")
    xt = x.reshape(B * S, D)
    gate, _, dest, C = moe_dispatch(params["router"], xt, top_k, capacity_factor)
    buf = x.new_zeros((E * C + 1, D))
    buf[dest] = xt.repeat_interleave(top_k, dim=0)
    buf = buf[:E * C].view(E, C, D)
    if ep_size > 1:
        # [j, e, c]: peer j's slot c for my local expert e
        buf = _AllToAll.apply(buf.reshape(ep_size, E // ep_size, C, D), ep_group)
        buf = buf.transpose(0, 1).reshape(E // ep_size, ep_size * C, D)
    h = _silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    out = torch.bmm(h, params["w_down"])
    if ep_size > 1:
        out = out.view(E // ep_size, ep_size, C, D).transpose(0, 1)
        out = _AllToAll.apply(out, ep_group)
    out = torch.cat([out.reshape(E * C, D), x.new_zeros((1, D))])
    tok = out[dest].view(B * S, top_k, D)
    y = torch.bmm(gate.to(tok.dtype)[:, None, :], tok)
    return y.view(B, S, D)


# -------------------------------------------------------------------- Mamba1
def init_mamba(gen, d_model, *, d_state, d_conv, expand, dt_rank, dtype):
    """The reference's draws and constants: ``conv_w`` at scale 0.5,
    ``conv_b`` zeros, ``dt_bias`` -4 (softplus of it is a small dt),
    ``A_log = log(1..d_state)`` on every row and ``D`` ones.  The log is
    taken in float64 and rounded once to float32, then cast: XLA's CPU
    log is one float32 ulp above that at 7, 47 and 49."""
    d_inner, dev = expand * d_model, gen.device
    a_log = np.log(np.arange(1, d_state + 1, dtype=np.float64)).astype(np.float32)
    return {
        "in_proj": _init(gen, (d_model, 2 * d_inner), dtype=dtype),
        "conv_w": _init(gen, (d_conv, d_inner), scale=0.5, dtype=dtype),
        "conv_b": torch.zeros(d_inner, dtype=dtype, device=dev),
        "x_proj": _init(gen, (d_inner, dt_rank + 2 * d_state), dtype=dtype),
        "dt_proj": _init(gen, (dt_rank, d_inner), dtype=dtype),
        "dt_bias": torch.full((d_inner,), -4.0, dtype=dtype, device=dev),
        "A_log": torch.from_numpy(a_log).to(dev).expand(d_inner, d_state).to(dtype).contiguous(),
        "D": torch.ones(d_inner, dtype=dtype, device=dev),
        "out_proj": _init(gen, (d_inner, d_model), dtype=dtype),
    }


MAMBA_CHUNK = 256   # the reference's chunk: a prefill of a multiple of it scans in chunks


def _ssm_chunk_scan(dA, dBx, h0, chunk: int):
    """The linear recurrence ``h_t = dA_t·h_{t-1} + dBx_t`` over axis 1
    in chunks of ``chunk`` steps (S a multiple of it), carrying h from
    chunk to chunk: within a chunk an inclusive Hillis-Steele scan of
    the pairs (a, b) under ``(a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2)``
    in log2(chunk) passes, then ``hs = aa·h + bb``.  The reference's
    ``lax.associative_scan`` combines in another order, so the two agree
    to float32 rounding.  Running products are never divided out: the
    product of 256 dA underflows.  Every pass makes new tensors (no
    ``out=``), so autograd differentiates the scan; its backward keeps the
    log2(chunk) passes of (B, chunk, Di, N) float32 of every chunk alive.
    dA, dBx: (B, S, Di, N) float32; h0: (B, Di, N).  Returns (hs (B, S,
    Di, N), h at the last step)."""
    S = dA.shape[1]
    chunks = []
    h = h0
    for c0 in range(0, S, chunk):
        a, b = dA[:, c0:c0 + chunk], dBx[:, c0:c0 + chunk]
        d = 1
        while d < chunk:
            b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], 1)
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
            d *= 2
        chunks.append(torch.addcmul(b, a, h[:, None]))
        h = chunks[-1][:, -1]
    hs = chunks[0] if len(chunks) == 1 else torch.cat(chunks, 1)
    return hs, h


def _ssm_step_scan(dA, dBx, h0):
    """The same recurrence one step at a time, as the reference's
    ``lax.scan`` when S is not a multiple of the chunk.  It is kept
    beside the chunked scan because it is the reference's own order: its
    states equal the reference's bit for bit on the CPU, where the
    chunked order differs from them in the last bits
    (``tests/test_torch_mamba_encdec.py::test_ssm_step_scan_is_the_reference_order``),
    so a prompt of any length that is not a multiple of the chunk, most
    of them, rounds as the reference's does.  The states are stacked
    after the loop, so autograd differentiates it."""
    h, hs = h0, []
    for t in range(dA.shape[1]):
        h = torch.addcmul(dBx[:, t], dA[:, t], h)
        hs.append(h)
    return torch.stack(hs, 1), h


def mamba_apply(params, x, *, d_state: int, d_conv: int, cache=None, decode: bool = False):
    """Mamba-1 selective SSM.  x: (B, S, D) -> (out, new_cache).

    Prefill/train: a causal depthwise conv over zero padding (``d_conv``
    products in the compute dtype, added in order), then the scan from
    h = 0 (``cache["h"]`` is not read, as in the reference): chunked when
    S is a multiple of ``MAMBA_CHUNK`` and at least it, else step by step.
    With a cache, returns ``{"conv": the last d_conv-1 inputs (the
    cache's and the prompt's when S is shorter), "h": the last state}``.
    Decode (S = 1): one contraction over (d_conv, Di) of the cached
    inputs and this one, one recurrence step from ``cache["h"]``; both
    written into ``cache`` in place, and the same dict returned.

    Dtypes, the reference's step by step: dt = softplus (``logaddexp(.,
    0)``) in the compute dtype; dA = exp(dt·A) float32 with A =
    -exp(A_log) in float32; dBx = (dt·conv)·B as two compute-dtype
    products, then float32; the recurrence, y = hs·C and y + conv·D and
    y·silu(z) in float32; y cast to ``x``'s dtype before ``out_proj``.
    ``init_cache`` holds h in float32.
    """
    B, S, _ = x.shape
    Di = params["in_proj"].shape[-1] // 2
    R = params["dt_proj"].shape[0]
    xz = x @ params["in_proj"]
    xin, z = xz[..., :Di], xz[..., Di:]
    w = params["conv_w"]
    if not decode:
        xpad = torch.cat([xin.new_zeros((B, d_conv - 1, Di)), xin], 1)
        conv = xpad[:, :S] * w[0]
        for i in range(1, d_conv):
            conv = conv + xpad[:, i:i + S] * w[i]
    else:
        hist = torch.cat(_same_dtype(cache["conv"], xin), 1)         # (B, d_conv, Di)
        conv = (hist.float() * w.float()).sum(1, keepdim=True).to(
            torch.promote_types(hist.dtype, w.dtype))
    conv = _silu(conv + params["conv_b"])

    proj = conv @ params["x_proj"]
    dt_r, Bm, Cm = proj[..., :R], proj[..., R:R + d_state], proj[..., R + d_state:]
    dt = dt_r @ params["dt_proj"] + params["dt_bias"]
    dt = torch.logaddexp(dt, dt.new_zeros(()))                     # (B, S, Di)
    A = -torch.exp(params["A_log"].float())                         # (Di, N)
    dA = torch.exp(dt.float()[..., None] * A)                       # (B, S, Di, N)
    dBx = ((dt * conv)[..., None] * Bm[:, :, None, :]).float()

    if not decode:
        h0 = dA.new_zeros((B, Di, d_state))
        if S % MAMBA_CHUNK == 0 and S >= MAMBA_CHUNK:
            hs, h_last = _ssm_chunk_scan(dA, dBx, h0, MAMBA_CHUNK)
        else:
            hs, h_last = _ssm_step_scan(dA, dBx, h0)
        y = (hs @ Cm.float()[..., None])[..., 0]
    else:
        h_last = torch.addcmul(dBx[:, 0], cache["h"].float(), dA[:, 0])
        y = (h_last @ Cm[:, 0].float()[..., None])[..., 0][:, None]

    y = (y + conv * params["D"]) * _silu(z)
    out = y.to(x.dtype) @ params["out_proj"]
    new_cache = None
    if decode:
        cache["conv"].copy_(hist[:, 1:])
        cache["h"].copy_(h_last)
        new_cache = cache
    elif cache is not None:
        # the last d_conv-1 inputs, copied (and h_last, a view of hs), so
        # that the row cache holds neither xpad nor hs
        if S >= d_conv - 1:
            state = xpad[:, S:].clone()
        else:
            state = torch.cat(_same_dtype(cache["conv"], xin), 1)[:, -(d_conv - 1):]
        new_cache = {"conv": state.to(cache["conv"].dtype),
                     "h": h_last.to(cache["h"].dtype, copy=True)}
    return out, new_cache
