"""Dense layers of the LLM scaffold, the port's counterpart of the dense
half of ``repro.models.layers``: RMSNorm, RoPE, the SwiGLU MLP and GQA
attention with its prefill and decode caches, the circular buffer of
sliding-window layers included.

Functional, as the reference is: parameters are dicts of tensors built by
the ``init_*`` functions from an explicit ``torch.Generator``, and the
apply functions take a leading batch axis.  The numerics follow the
reference's: RMSNorm and RoPE in float32, attention scores and the
attention output in float32 whatever the compute dtype (the reference's
``preferred_element_type=float32`` and its float32 ``p`` times a bf16
``v``).  MLA, MoE and Mamba wait for the next slice of the port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
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
    """q: (B,S,H,hd), k: (B,T,Hkv,hd) -> (B,S,H,T) float32, by grouping the
    n_rep query heads of each KV head, never by repeating K.  Both sides
    are cast to float32 first: bf16 to float32 is exact, so the products
    are the reference's bf16 products accumulated in float32."""
    B, S, H, hd = q.shape
    qg = q.float().view(B, S, H // n_rep, n_rep, hd)
    s = torch.einsum("bsgrk,btgk->bsgrt", qg, k.float())
    return s.reshape(B, S, H, k.shape[1]) / math.sqrt(hd)


def _gqa_out(p, v, n_rep):
    """p: (B,S,H,T) float32, v: (B,T,Hkv,hd) -> (B,S,H,hd) float32, as
    the reference promotes float32 p times a bf16 v."""
    B, S, H, T = p.shape
    o = torch.einsum("bsgrt,btgk->bsgrk", p.view(B, S, H // n_rep, n_rep, T), v.float())
    return o.reshape(B, S, H, v.shape[-1])


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
              rope_theta: float = 10000.0, cache=None, decode: bool = False):
    """GQA attention with an optional sliding window and KV cache.

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
    q = rope(_heads(x, params["wq"]), positions, theta=rope_theta)
    k = rope(_heads(x, params["wk"]), positions, theta=rope_theta)
    v = _heads(x, params["wv"])

    if not decode:
        mask = positions[:, None, :] <= positions[:, :, None]
        if window is not None:
            mask = mask & (positions[:, None, :] > positions[:, :, None] - window)
        out = _gqa_out(_softmax(_gqa_scores(q, k, n_rep), mask[:, :, None, :]), v, n_rep)
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
        scores = _gqa_scores(q, cache["k"], n_rep)  # (B,1,H,C)
        out = _gqa_out(_softmax(scores, valid[:, None, None, :]), cache["v"], n_rep)
        new_cache = cache

    H, hd, D = params["wo"].shape
    proj = out.to(x.dtype).reshape(B, S, H * hd) @ params["wo"].reshape(H * hd, D)
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
