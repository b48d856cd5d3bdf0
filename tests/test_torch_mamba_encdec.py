"""Mamba and the encoder-decoder of the port (``repro_torch.models``)
against the reference's (``repro.models``): the Mamba layer and its scan
alone on seeded numpy inputs, then shrink(falcon-mamba-7b),
shrink(jamba-v0.1-52b) and shrink(whisper-base) through ``forward``, the
steps and the serving loop, on the reference's own weights
(``interop.model_params_from_jax``).

Tolerances are ``tests/test_torch_model.py``'s: logits at rtol = atol =
2e-4 in float32, a layer at rtol = atol = 1e-5, bfloat16 within
BF16_ULPS units in the last place of the largest |value|.  The port's
chunked scan combines in another order than ``lax.associative_scan``,
so the recurrence agrees to float32 rounding, not bit for bit; its
per-step loop is the reference's ``lax.scan`` order and agrees bit for
bit.  ``forward`` in train, prefill and decode modes, with every cache
entry compared, runs these three configs in ``tests/test_torch_model.py``.
jamba's MoE routes as deepseek's does in ``tests/test_torch_mla_moe.py``:
in bf16 a token beyond BF16_ULPS must come at or after a router near-tie.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.launch import steps as RS
from repro.launch.mesh import local_test_mesh
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import interop
from repro_torch.configs import get_arch, shrink
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as TST
from repro_torch.models import layers as L
from repro_torch.models import model as M
from test_torch_model import LAYER_TOL, TOL, assert_caches, configs, ref_forward, weights

BF16_ULPS = 8
NEAR_TIE_BF16 = 2.0 ** -9          # tests/test_torch_mla_moe.py's NEAR_TIE in bf16
FALCON, JAMBA, WHISPER = "falcon-mamba-7b", "jamba-v0.1-52b", "whisper-base"
D, D_STATE, D_CONV, EXPAND, DT_RANK = 32, 16, 4, 2, 4
DI = EXPAND * D


def port(tree):
    return {k: port(v) if isinstance(v, dict) else interop._tensor(v, "cpu")
            for k, v in tree.items()}


def seeded(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32).astype(dtype)


def ulps(want):
    """One bf16 unit in the last place of the largest |value|."""
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def frames_for(cfg, batch, seed):
    """The audio stub's frames (batch, frontend_len, D) of an
    encoder-decoder, else None."""
    if cfg.kind != "encdec":
        return None
    return seeded((batch, cfg.frontend_len, cfg.d_model), seed + 100)


def kwargs(frames):
    """(the reference's, the port's) ``enc_frames`` keyword."""
    if frames is None:
        return {}, {}
    return {"enc_frames": jnp.asarray(frames)}, {"enc_frames": torch.as_tensor(frames)}


# ------------------------------------------------------------------ Mamba
def mamba_params(dtype, seed=0):
    p = RL.init_mamba(jax.random.PRNGKey(seed), D, d_state=D_STATE, d_conv=D_CONV,
                      expand=EXPAND, dt_rank=DT_RANK, dtype=dtype)
    p = jax.tree.map(np.asarray, p)
    return p, port(p)


def mamba_caches(B, dtype):
    tdt = getattr(torch, jnp.dtype(dtype).name)
    rc = {"conv": jnp.zeros((B, D_CONV - 1, DI), dtype),
          "h": jnp.zeros((B, DI, D_STATE), jnp.float32)}
    tc = {"conv": torch.zeros((B, D_CONV - 1, DI), dtype=tdt),
          "h": torch.zeros((B, DI, D_STATE))}
    return rc, tc


def assert_mamba_cache(tc, rc, **tol):
    assert tc["h"].dtype == torch.float32
    for name in ("conv", "h"):
        np.testing.assert_allclose(tc[name].float().numpy(), np.asarray(rc[name], np.float32),
                                   **tol)


KW = dict(d_state=D_STATE, d_conv=D_CONV)


def test_init_mamba_constants_match_reference():
    """Shapes, dtypes and the constants of the reference's init_mamba:
    conv_b, dt_bias and D exactly, A_log exactly in bf16 and within one
    float32 ulp in float32 (XLA's CPU log is one ulp above the correctly
    rounded value at 7, 47 and 49; the port rounds the float64 log)."""
    for dtype in (jnp.float32, jnp.bfloat16):
        ref = jax.tree.map(np.asarray, RL.init_mamba(
            jax.random.PRNGKey(0), D, d_state=64, d_conv=D_CONV, expand=EXPAND,
            dt_rank=DT_RANK, dtype=dtype))
        tdt = getattr(torch, jnp.dtype(dtype).name)
        got = L.init_mamba(torch.Generator().manual_seed(0), D, d_state=64, d_conv=D_CONV,
                           expand=EXPAND, dt_rank=DT_RANK, dtype=tdt)
        assert set(got) == set(ref)
        for k, v in got.items():
            assert v.dtype == tdt and tuple(v.shape) == ref[k].shape, k
            assert v.is_contiguous()
        for k in ("conv_b", "dt_bias", "D"):
            np.testing.assert_array_equal(got[k].float().numpy(), ref[k].astype(np.float32))
        a_got, a_ref = got["A_log"].float().numpy(), ref["A_log"].astype(np.float32)
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(a_got, a_ref)
        else:
            off = np.abs(a_got.view(np.int32).astype(np.int64) - a_ref.view(np.int32))
            assert off.max() <= 1
            assert sorted(set(np.flatnonzero(off[0]) + 1)) == [7, 47, 49]
    w = L.init_mamba(torch.Generator().manual_seed(1), 512, d_state=16, d_conv=4, expand=2,
                     dt_rank=32, dtype=torch.float32)["conv_w"]
    assert abs(float(w.std()) - 0.5) < 0.01


@pytest.mark.parametrize("S", [16, 256])
def test_mamba_train_matches_reference(S):
    """Train mode: S = 16 scans step by step, S = 256 through the chunked
    scan (chunk 256), in both packages."""
    p, tp = mamba_params(jnp.float32, seed=S)
    x = seeded((2, S, D), S)
    want, _ = RL.mamba_apply(p, jnp.asarray(x), **KW)
    got, none = L.mamba_apply(tp, torch.as_tensor(x), **KW)
    assert none is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("S", [10, 256])
def test_mamba_prefill_then_decode_matches_reference(S):
    """Prefill into a cache (conv the last d_conv-1 inputs, h the last
    state), then four decode steps, each writing conv and h in place."""
    B = 2
    p, tp = mamba_params(jnp.float32, seed=1)
    x = seeded((B, S + 4, D), 1)
    rc, tc = mamba_caches(B, jnp.float32)
    want, rc = RL.mamba_apply(p, jnp.asarray(x[:, :S]), cache=rc, **KW)
    got, tc = L.mamba_apply(tp, torch.as_tensor(x[:, :S]), cache=tc, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert_mamba_cache(tc, rc, **LAYER_TOL)
    for i in range(S, S + 4):
        want, rc = RL.mamba_apply(p, jnp.asarray(x[:, i:i + 1]), cache=rc, decode=True, **KW)
        conv, h = tc["conv"], tc["h"]
        got, tc2 = L.mamba_apply(tp, torch.as_tensor(x[:, i:i + 1]), cache=tc, decode=True,
                                 **KW)
        assert tc2 is tc and tc["conv"] is conv and tc["h"] is h      # in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
        assert_mamba_cache(tc, rc, **LAYER_TOL)


@pytest.mark.parametrize("S", [1, 2])
def test_mamba_short_prefill_keeps_the_cached_inputs(S):
    """S < d_conv - 1 with a cache: the new conv state is the tail of the
    cached inputs and these, and h starts from 0 whatever the cache holds
    (the reference's prefill does not read cache["h"])."""
    B = 2
    p, tp = mamba_params(jnp.float32, seed=2)
    x = seeded((B, 6 + S + 2, D), 2)
    rc, tc = mamba_caches(B, jnp.float32)
    _, rc = RL.mamba_apply(p, jnp.asarray(x[:, :6]), cache=rc, **KW)
    _, tc = L.mamba_apply(tp, torch.as_tensor(x[:, :6]), cache=tc, **KW)
    want, rc = RL.mamba_apply(p, jnp.asarray(x[:, 6:6 + S]), cache=rc, **KW)
    got, tc = L.mamba_apply(tp, torch.as_tensor(x[:, 6:6 + S]), cache=tc, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert_mamba_cache(tc, rc, **LAYER_TOL)
    xin = (torch.as_tensor(x[:, :6 + S]) @ tp["in_proj"])[..., :DI]
    np.testing.assert_allclose(tc["conv"].numpy(), xin[:, -(D_CONV - 1):].numpy(), **LAYER_TOL)
    fresh, _ = L.mamba_apply(tp, torch.as_tensor(x[:, 6:6 + S]), **KW)
    assert torch.equal(fresh, got)          # the cached h did not enter
    for i in range(6 + S, 6 + S + 2):
        want, rc = RL.mamba_apply(p, jnp.asarray(x[:, i:i + 1]), cache=rc, decode=True, **KW)
        got, tc = L.mamba_apply(tp, torch.as_tensor(x[:, i:i + 1]), cache=tc, decode=True, **KW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("decay", [0.1, 5.0])
def test_ssm_chunk_scan_matches_reference_and_step_scan(decay):
    """The chunked scan at chunk 4 against the reference's and against
    the port's per-step loop.  At decay 5 the running product of dA
    underflows within a chunk of 4 steps: the scan stays finite (no
    division by the running product)."""
    rs = np.random.default_rng(int(decay * 10))
    B, S, Di, N = 2, 16, 8, 4
    dA = np.exp(-decay * rs.uniform(0.5, 1.5, (B, S, Di, N)) * np.arange(1, N + 1) * 8
                ).astype(np.float32)
    dBx = rs.standard_normal((B, S, Di, N)).astype(np.float32)
    h0 = rs.standard_normal((B, Di, N)).astype(np.float32)
    want_hs, want_h = RL._ssm_chunk_scan(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(h0), 4)
    args = (torch.as_tensor(dA), torch.as_tensor(dBx), torch.as_tensor(h0))
    hs, h = L._ssm_chunk_scan(*args, 4)
    step_hs, step_h = L._ssm_step_scan(*args)
    if decay == 5.0:
        assert float(torch.as_tensor(dA)[:, :4].prod(1).min()) == 0.0
    assert torch.isfinite(hs).all()
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), **LAYER_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **LAYER_TOL)
    np.testing.assert_allclose(hs.numpy(), step_hs.numpy(), **LAYER_TOL)
    assert torch.equal(h, hs[:, -1]) and torch.equal(step_h, step_hs[:, -1])


@pytest.mark.parametrize("S", [1, 7, 200])
def test_ssm_step_scan_is_the_reference_order(S):
    """The per-step loop against the reference's ``lax.scan`` step (its
    ``mamba_apply`` body, S not a multiple of the chunk): equal bit for
    bit, at dA and dBx drawn as the layer's (dt = softplus(n - 4)).
    The chunked order over the same 200 steps (chunk 8) is not."""
    rs = np.random.default_rng(S)
    B, Di, N = 2, 64, 16
    dt = np.logaddexp(rs.standard_normal((B, S, Di)).astype(np.float32) - 4, 0)
    dA = np.exp(dt[..., None] * -np.arange(1, N + 1, dtype=np.float32)).astype(np.float32)
    dBx = (rs.standard_normal((B, S, Di, N)) * dt[..., None]).astype(np.float32)
    h0 = np.zeros((B, Di, N), np.float32)

    def step(h, ab):
        a, bx = ab
        h = a * h + bx
        return h, h

    want_h, want_hs = jax.jit(lambda a, b: jax.lax.scan(
        step, jnp.asarray(h0), (a.transpose(1, 0, 2, 3), b.transpose(1, 0, 2, 3))))(dA, dBx)
    args = (torch.as_tensor(dA), torch.as_tensor(dBx), torch.as_tensor(h0))
    hs, h = L._ssm_step_scan(*args)
    np.testing.assert_array_equal(hs.numpy(), np.asarray(want_hs).transpose(1, 0, 2, 3))
    np.testing.assert_array_equal(h.numpy(), np.asarray(want_h))
    if S % 8 == 0:
        chunked, _ = L._ssm_chunk_scan(*args, 8)
        assert not torch.equal(chunked, hs)
        np.testing.assert_allclose(chunked.numpy(), hs.numpy(), **LAYER_TOL)


@pytest.mark.parametrize("S", [16, 256])
def test_mamba_bf16_within_ulps_of_reference(S):
    """bf16 weights and input: dt in bf16, dA and the recurrence in
    float32, dBx two bf16 products then float32, y float32 until the
    cast before out_proj; train, prefill into a bf16 cache (h float32)
    and two decode steps."""
    B = 2
    p, tp = mamba_params(jnp.bfloat16, seed=3)
    x = seeded((B, S + 2, D), 3, ml_dtypes.bfloat16)
    rc, tc = mamba_caches(B, jnp.bfloat16)
    want, rc = RL.mamba_apply(p, jnp.asarray(x[:, :S]), cache=rc, **KW)
    got, tc = L.mamba_apply(tp, interop._tensor(x[:, :S], "cpu"), cache=tc, **KW)
    assert got.dtype == torch.bfloat16 and tc["conv"].dtype == torch.bfloat16
    assert tc["h"].dtype == torch.float32
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= BF16_ULPS * ulps(want)
    h_ref = np.asarray(rc["h"])
    assert np.abs(tc["h"].numpy() - h_ref).max() <= BF16_ULPS * ulps(h_ref)
    for i in range(S, S + 2):
        want, rc = RL.mamba_apply(p, jnp.asarray(x[:, i:i + 1]), cache=rc, decode=True, **KW)
        got, tc = L.mamba_apply(tp, interop._tensor(x[:, i:i + 1], "cpu"), cache=tc,
                                decode=True, **KW)
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= BF16_ULPS * ulps(want)


def test_attention_without_rope_matches_reference():
    """use_rope=False: q and k are not rotated, in train and decode."""
    B, S, H, hd = 2, 6, 4, 8
    p = jax.tree.map(np.asarray, RL.init_attention(jax.random.PRNGKey(5), D, H, H, hd,
                                                   jnp.float32))
    tp = port(p)
    x = seeded((B, S, D), 5)
    pos = np.tile(np.arange(S, dtype=np.int32) + 40, (B, 1))
    kw = dict(n_rep=1, window=None, use_rope=False)
    want, _ = RL.attention(p, jnp.asarray(x), jnp.asarray(pos), **kw)
    got, _ = L.attention(tp, torch.as_tensor(x), torch.as_tensor(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    roped, _ = L.attention(tp, torch.as_tensor(x), torch.as_tensor(pos), n_rep=1, window=None)
    assert not torch.allclose(roped, got)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("name", [FALCON, JAMBA])
def test_chunked_scan_forward_matches_reference(name):
    """A 256-token prompt takes the chunked scan in every Mamba layer, in
    train mode and in prefill, in both packages."""
    rcfg, cfg = configs(name)
    p, tp = weights(rcfg, cfg, seed=7)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
    want = ref_forward(p, rcfg, jnp.asarray(toks))
    np.testing.assert_allclose(M.forward(tp, cfg, torch.as_tensor(toks)).numpy(),
                               np.asarray(want), **TOL)
    rc = RM.init_cache(rcfg, 1, 260, dtype=jnp.float32)
    tc = M.init_cache(cfg, 1, 260, dtype=torch.float32, device="cpu")
    want, rc = ref_forward(p, rcfg, jnp.asarray(toks), caches=rc, mode="prefill")
    got, tc = M.forward(tp, cfg, torch.as_tensor(toks), caches=tc, mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_caches(rc, tc, cfg)


@pytest.mark.parametrize("name,pre,total", [(FALCON, 10, 20), (FALCON, 256, 260),
                                            (JAMBA, 10, 20), (JAMBA, 256, 260),
                                            (WHISPER, 10, 20)])
def test_teacher_forced_decode_reproduces_train_logits(name, pre, total):
    """Prefill then decode one token at a time against train mode.  At
    (256, 260) the prefill takes the chunked scan and train mode the
    per-step one (260 is no multiple of 256).  jamba's MoE runs at
    capacity factor E/k, so no pick drops in either mode."""
    rcfg, cfg = configs(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    _, tp = weights(rcfg, cfg, seed=2)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, total)))
    fr = frames_for(cfg, 1, 2)
    tkw = kwargs(fr)[1]
    full = M.forward(tp, cfg, toks, **tkw)
    caches = M.init_cache(cfg, 1, total + 4, dtype=torch.float32, device="cpu",
                          enc_len=TS.enc_len(cfg))
    logits, caches = M.forward(tp, cfg, toks[:, :pre], caches=caches, mode="prefill", **tkw)
    np.testing.assert_allclose(logits.numpy(), full[:, :pre].numpy(), **TOL)
    for i in range(pre, total):
        logits, caches = M.forward(tp, cfg, toks[:, i:i + 1], caches=caches, mode="decode",
                                   positions=torch.full((1, 1), i, dtype=torch.int32))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i].numpy(), **TOL)


def router_margins(fn):
    """Run ``fn`` with the port's router probabilities of every MoE call
    recorded; returns (fn's result, [probs (T, E)])."""
    seen, real = [], L.moe_dispatch

    def spy(router, xt, top_k, capacity_factor):
        seen.append((xt.float() @ router).softmax(-1))
        return real(router, xt, top_k, capacity_factor)

    L.moe_dispatch = spy
    try:
        return fn(), seen
    finally:
        L.moe_dispatch = real


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", [FALCON, JAMBA, WHISPER])
def test_bf16_forward_within_ulps_or_after_a_near_tie(name, seed):
    """bf16 train mode against the reference.  falcon-mamba and whisper
    stay within BF16_ULPS; in jamba a token beyond it must come at or
    after a router near-tie in its MoE layers' call order (printed)."""
    rcfg, cfg = configs(name, param_dtype="bfloat16", compute_dtype="bfloat16")
    p, tp = weights(rcfg, cfg, seed=seed)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    fr = frames_for(cfg, 2, seed)
    jkw, tkw = kwargs(fr)
    want = np.asarray(ref_forward(p, rcfg, jnp.asarray(toks), **jkw).astype(jnp.float32))
    got, seen = router_margins(lambda: M.forward(tp, cfg, torch.as_tensor(toks), **tkw))
    assert got.dtype == torch.bfloat16
    bad = np.flatnonzero((np.abs(got.float().numpy() - want).max(-1) >
                          BF16_ULPS * ulps(want)).reshape(-1))
    if len(bad):
        assert seen, f"{name}: tokens {bad.tolist()} beyond {BF16_ULPS} ulps with no router"
        ties = []
        for probs in seen:
            s = np.sort(probs.numpy(), 1)[:, ::-1]
            margin = s[:, cfg.top_k - 1] - s[:, cfg.top_k]
            ties += [(int(t), float(margin[t])) for t in
                     np.flatnonzero(margin <= NEAR_TIE_BF16)]
        print(f"tokens beyond {BF16_ULPS} ulps: {bad.tolist()}; near-ties {ties}")
        assert ties and bad.min() >= min(t for t, _ in ties)


@pytest.mark.parametrize("name", [FALCON, JAMBA, WHISPER])
def test_init_params_layout_and_count(name):
    """Random weights on the generator's device in param_dtype: no norm2
    without an MLP, Mamba's leaves, normc and cross, pos_embed and the
    encoder; as many parameters as the analytic count plus what it
    leaves out: the final norms, the learned positions and Mamba's
    conv_b, dt_bias, A_log and D."""
    cfg = dataclasses.replace(shrink(get_arch(name).model), param_dtype="bfloat16")
    model = M.Model(cfg, device="cpu", seed=5)
    params = model.params()
    assert all(q.dtype == (torch.float32 if n.endswith("router") else torch.bfloat16)
               for n, q in model.named_parameters())
    extra = cfg.d_model
    for spec, lp in zip(M.layer_specs(cfg), params["layers"]):
        assert ("norm2" in lp) == ("mlp" in lp) == (spec.mlp != "none")
        assert ("cross" in lp) == ("normc" in lp) == spec.cross_attn
        if spec.kind == "mamba":
            assert set(lp["attn"]) == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                                       "dt_bias", "A_log", "D", "out_proj"}
            extra += cfg.d_inner * (cfg.d_state + 3)
        if spec.cross_attn:
            assert lp["cross"]["wk"].shape == (cfg.d_model, cfg.n_heads, cfg.head_dim)
    if name == WHISPER:
        assert params["pos_embed"].shape == (cfg.max_seq, cfg.d_model)
        enc = params["enc"]
        assert len(enc["layers"]) == cfg.n_enc_layers == len(model.enc_layers)
        assert set(enc["layers"][0]) == {"norm1", "norm2", "attn", "mlp"}
        extra += 2 * cfg.max_seq * cfg.d_model + cfg.d_model
        assert "enc.pos_embed" in dict(model.named_parameters())
    else:
        assert "pos_embed" not in params and "enc" not in params
    assert sum(q.numel() for q in model.parameters()) == cfg.param_count()[0] + extra
    caches = M.init_cache(cfg, 3, 16, device="cpu", enc_len=TS.enc_len(cfg))
    for spec, c in zip(M.layer_specs(cfg), caches):
        if spec.kind == "mamba":
            assert c["conv"].shape == (3, cfg.d_conv - 1, cfg.d_inner)
            assert c["conv"].dtype == torch.bfloat16
            assert c["h"].shape == (3, cfg.d_inner, cfg.d_state) and c["h"].dtype == torch.float32
        if spec.cross_attn:
            assert c["ck"].shape == c["cv"].shape == (3, cfg.frontend_len, cfg.n_heads,
                                                      cfg.head_dim)


def test_model_params_from_jax_carries_every_new_leaf():
    rcfg, cfg = configs(WHISPER, param_dtype="bfloat16", compute_dtype="bfloat16")
    p, tp = weights(rcfg, cfg)

    def same(got, want):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))

    same(tp["pos_embed"], p["pos_embed"])
    same(tp["enc"]["pos_embed"], p["enc"]["pos_embed"])
    same(tp["enc"]["final_norm"], p["enc"]["final_norm"])
    assert len(tp["enc"]["layers"]) == cfg.n_enc_layers == 2
    same(tp["enc"]["layers"][1]["mlp"]["w_up"], p["enc"]["groups"][0][0]["mlp"]["w_up"][1])
    same(tp["layers"][0]["cross"]["wv"], p["groups"][0][0]["cross"]["wv"][0])
    same(tp["layers"][0]["normc"], p["groups"][0][0]["normc"][0])

    rcfg, cfg = configs(JAMBA)
    p, tp = weights(rcfg, cfg)
    for i, spec in enumerate(M.layer_specs(cfg)):
        ref = p["groups"][0][i]
        assert set(tp["layers"][i]) == set(ref)
        if spec.kind == "mamba":
            for k, v in ref["attn"].items():
                same(tp["layers"][i]["attn"][k], v[0])
    rcfg, cfg = configs(FALCON)
    p, tp = weights(rcfg, cfg)
    assert set(tp["layers"][0]) == {"norm1", "attn"}
    with pytest.raises(ValueError, match="unknown top-level"):
        interop.model_params_from_jax({**p, "extra": p["embed"]}, cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder's blocks"):
        rcfg, cfg = configs(WHISPER)
        p, _ = weights(rcfg, cfg)
        interop.model_params_from_jax(p, dataclasses.replace(cfg, n_enc_layers=3), device="cpu")


def test_unknown_layer_kinds_raise_and_expert_parallelism_still_raises():
    cfg = shrink(get_arch(FALCON).model)
    bad = dataclasses.replace(cfg, blocks=(((M.LayerSpec(kind="rwkv"),), 1),))
    with pytest.raises(ValueError, match="rwkv"):
        M.init_cache(bad, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="model kind"):
        M.forward({}, dataclasses.replace(cfg, kind="encoder"), torch.zeros(1, 2, dtype=torch.int64))
    moe = L.init_moe(torch.Generator().manual_seed(0), 16, 8, 4, 0, 8, torch.float32)
    with pytest.raises(ValueError, match="ep_group"):
        L.moe_apply(moe, torch.zeros(1, 2, 16), top_k=2, ep_size=2)


# ---------------------------------------------------------------- serving
def queue_for(cfg, n, seed):
    rng = np.random.default_rng(seed)
    queue = [rng.integers(1, cfg.vocab_size, size=m).astype(np.int32)
             for m in (8, 5, 8, 11, 6, 8, 7, 9, 10, 8)[:n]]
    frames = None
    if cfg.kind == "encdec":
        frames = [rng.standard_normal((cfg.frontend_len, cfg.d_model)).astype(np.float32)
                  for _ in range(n)]
    return queue, frames


def ref_splice(caches, row, slot):
    return [jax.tree.map(lambda f, r: jax.lax.dynamic_update_slice_in_dim(
        f, r.astype(f.dtype), slot, axis=1), fg, rg) for fg, rg in zip(caches, row)]


def ref_loop(rcfg, p, queue, frames, *, batch, max_new, s_max):
    """The reference's continuous-batching loop (``repro/launch/serve.py``
    main, lines 87-121) over its own steps (``repro.launch.steps``'
    ``make_prefill_step`` and ``make_serve_step`` on a one-device mesh)
    in float32, the caches built with ``enc_len = frontend_len`` as
    ``build_cell`` builds them, the prefill given each request's frames:
    what the reference's steps compute for a request, which its own loop
    cannot serve for an encoder-decoder (ROADMAP.md section C)."""
    mesh = local_test_mesh()
    Te = TS.enc_len(rcfg)
    prefill = jax.jit(RS.make_prefill_step(rcfg, mesh, 1, s_max))
    step = jax.jit(RS.make_serve_step(rcfg, mesh, batch))
    caches = RM.init_cache(rcfg, batch, s_max, dtype=jnp.float32, enc_len=Te)
    cur_tok = np.zeros((batch, 1), np.int32)
    cur_pos = np.zeros((batch,), np.int32)
    remaining = np.zeros((batch,), np.int32)
    outputs = [[] for _ in queue]
    slot_req = [-1] * batch
    next_req = done = 0
    with mesh:
        while done < len(queue):
            for s in range(batch):
                if remaining[s] == 0 and next_req < len(queue):
                    prompt = queue[next_req]
                    data = {"tokens": jnp.asarray(np.append(prompt, 0)[None])}
                    if frames is not None:
                        data["audio_frames"] = jnp.asarray(frames[next_req][None])
                    row = RM.init_cache(rcfg, 1, s_max, dtype=jnp.float32, enc_len=Te)
                    tok, row = prefill(p, data, row)
                    caches = ref_splice(caches, row, s)
                    cur_tok[s, 0] = int(tok[0, 0])
                    cur_pos[s] = len(prompt)
                    remaining[s] = max_new - 1
                    slot_req[s] = next_req
                    outputs[next_req].append(int(cur_tok[s, 0]))
                    next_req += 1
            nxt, caches = step(p, caches, jnp.asarray(cur_tok), jnp.asarray(cur_pos))
            nxt = np.asarray(nxt)[:, 0]
            for s in range(batch):
                if remaining[s] > 0:
                    outputs[slot_req[s]].append(int(nxt[s]))
                    cur_tok[s, 0] = nxt[s]
                    cur_pos[s] += 1
                    remaining[s] -= 1
                    if remaining[s] == 0:
                        done += 1
    return outputs


def assert_tokens_trace_to_near_ties(model, cfg, queue, frames, got, want):
    """Every request whose tokens differ parts at a step where the port's
    float32 train-mode logits put the two tokens within the logits'
    tolerance of each other."""
    for r, (prompt, g, w) in enumerate(zip(queue, got, want)):
        assert len(g) == len(w)
        if g == w:
            continue
        i = next(j for j in range(len(g)) if g[j] != w[j])
        seq = torch.as_tensor(np.concatenate([prompt, np.asarray(w[:i], np.int32)]))[None]
        kw = {} if frames is None else {"enc_frames": torch.as_tensor(frames[r][None])}
        logits = model(seq, **kw)[0, -1]
        a, b = float(logits[g[i]]), float(logits[w[i]])
        margin = 2 * (2e-4 + 2e-4 * max(abs(a), abs(b)))
        print(f"request {r} parts at step {i}: logits {a:.6f} vs {b:.6f}")
        assert abs(a - b) <= margin, f"request {r} parts on a margin {abs(a - b):.3g}"


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("name", [FALCON, JAMBA, WHISPER])
def test_serve_tokens_match_the_reference_steps(name, batch):
    """Ten requests of uneven prompts through the port's serve and a loop
    over the reference's steps: the same greedy tokens, or a part at a
    near-tie.  Free slots decode stale tokens in both (and, in jamba,
    take expert capacity in both)."""
    rcfg, cfg = configs(name)
    p, tp = weights(rcfg, cfg, seed=6)
    model = M.Model(cfg, device="cpu", params=tp)
    queue, frames = queue_for(cfg, 10, 6)
    want = ref_loop(rcfg, p, queue, frames, batch=batch, max_new=5, s_max=24)
    got, ticks = TS.serve(cfg, model, queue, batch=batch, max_new=5, s_max=24, device="cpu",
                          frames=frames)
    assert all(len(o) == 5 for o in got)
    if batch == 1:
        assert ticks == 10 * 4
    assert_tokens_trace_to_near_ties(model, cfg, queue, frames, got, want)


def test_prefill_step_passes_the_audio_frames():
    """make_prefill_step gives the encoder-decoder's audio_frames to the
    encoder: next tokens and the ck/cv caches as the reference's step;
    then two serve steps."""
    rcfg, cfg = configs(WHISPER)
    p, tp = weights(rcfg, cfg, seed=8)
    B, S, s_max = 3, 7, 16
    rs = np.random.default_rng(8)
    toks = rs.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    fr = rs.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    mesh = local_test_mesh()
    with mesh:
        want_tok, rc = jax.jit(RS.make_prefill_step(rcfg, mesh, B, s_max))(
            p, {"tokens": jnp.asarray(toks), "audio_frames": jnp.asarray(fr)},
            RM.init_cache(rcfg, B, s_max, dtype=jnp.float32, enc_len=cfg.frontend_len))
    caches = M.init_cache(cfg, B, s_max, dtype=torch.float32, device="cpu",
                          enc_len=cfg.frontend_len)
    tok, caches = TST.make_prefill_step(cfg)(
        tp, {"tokens": torch.as_tensor(toks), "audio_frames": torch.as_tensor(fr)}, caches)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    assert_caches(rc, caches, cfg)
    ref_step, step = jax.jit(RS.make_serve_step(rcfg, mesh, B)), TST.make_serve_step(cfg)
    pos = np.full((B,), S, np.int32)
    for _ in range(2):
        with mesh:
            want_tok, rc = ref_step(p, rc, want_tok, jnp.asarray(pos))
        tok, caches = step(tp, caches, tok, torch.as_tensor(pos))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
        pos += 1
    assert_caches(rc, caches, cfg)


def test_serve_encdec_needs_frames_and_splices_every_cache():
    cfg = dataclasses.replace(shrink(get_arch(WHISPER).model), compute_dtype="bfloat16")
    model = M.Model(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="audio frames"):
        TS.serve(cfg, model, [np.ones(4, np.int32)], batch=1, max_new=2, s_max=8, device="cpu")
    for name in (WHISPER, JAMBA):
        cfg = dataclasses.replace(shrink(get_arch(name).model), compute_dtype="bfloat16")
        slots = TS.SlotCache(cfg, 3, 16, torch.bfloat16, "cpu")
        row = M.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu",
                           enc_len=TS.enc_len(cfg))
        for i, layer in enumerate(row):
            for t in layer.values():
                t.fill_(i + 1)
        slots.splice(row, 2)
        for full, r in zip(slots.caches, row):
            assert set(full) == set(r)
            for key, t in full.items():
                if key == "h":
                    assert t.dtype == torch.float32
                assert torch.equal(t[2:3].to(r[key].dtype), r[key])
                assert not t[:2].float().any() or key == "pos_k"
