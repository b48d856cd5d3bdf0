"""The port's dense LLM layers and model (``repro_torch.models``) against
the reference's (``repro.models``): the same seeded numpy inputs and the
reference's own initial weights (``interop.model_params_from_jax``)
through both.

Tolerances: logits at rtol 2e-4 and atol 2e-4 in float32 (the reference's
own contract between its prefill, decode and train paths,
``tests/test_archs_smoke.py:97-98``); a layer's output at rtol 1e-5 and
atol 1e-5 (a few float32 roundings of values of order one); caches' k and
v as the logits, their positions exactly.  In bfloat16 every layer
rounds, and XLA rounds in other places than torch, so the bf16 forward
is held to BF16_ULPS units in the last place of its largest |logit|.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch, shrink as ref_shrink
from repro.launch.train import preset_config as ref_preset
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import interop
from repro_torch.configs import get_arch, shrink
from repro_torch.launch.train import preset_config
from repro_torch.models import layers as L
from repro_torch.models import model as M

DENSE = ("stablelm-1.6b", "gemma3-4b", "granite-20b", "internlm2-20b", "internvl2-2b")
MLA_MOE = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")
SSM_ENCDEC = ("falcon-mamba-7b", "jamba-v0.1-52b", "whisper-base")
TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULPS = 8
# The reference's forward compiled once per config, mode and shape (eager,
# each call would compile its scans anew).
ref_forward = jax.jit(RM.forward, static_argnames=("cfg", "mode"))


def configs(name, **over):
    """(reference config, port config) of an architecture's shrink() or a
    preset, with ``over`` applied to both."""
    if name == "smoke":
        r, t = ref_preset("smoke")[0], preset_config("smoke")[0]
    else:
        r, t = ref_shrink(ref_arch(name).model), shrink(get_arch(name).model)
    return dataclasses.replace(r, **over), dataclasses.replace(t, **over)


def weights(rcfg, cfg, seed=0):
    p = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(seed), rcfg))
    return p, interop.model_params_from_jax(p, cfg, device="cpu")


def inputs(cfg, batch, seq, seed=0):
    """Tokens and the stub's inputs: the vision stub's prefix embeddings
    (``embeds``) or the encoder-decoder's audio frames (``enc_frames``)."""
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    stub = {}
    if cfg.frontend == "vision_stub":
        stub["embeds"] = rs.standard_normal((batch, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)
    if cfg.kind == "encdec":
        stub["enc_frames"] = rs.standard_normal((batch, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)
    return toks, stub


def both(toks, stub):
    j = {k: jnp.asarray(v) for k, v in stub.items()}
    t = {k: torch.as_tensor(v) for k, v in stub.items()}
    return jnp.asarray(toks), j, torch.as_tensor(toks), t


def assert_caches(ref_caches, caches, cfg):
    """The reference's per-group caches (leading repeats axis) against
    the port's per-layer ones."""
    i = 0
    for (pattern, reps), group in zip(cfg.blocks, ref_caches):
        for r in range(reps):
            for j in range(len(pattern)):
                got = caches[i]
                assert set(got) == set(group[j])
                # k, v or c_kv, k_rope, or Mamba's conv and h; ck, cv
                for name in [n for n in got if n != "pos_k"]:
                    np.testing.assert_allclose(got[name].numpy(),
                                               np.asarray(group[j][name])[r], **TOL)
                if "pos_k" in got:
                    np.testing.assert_array_equal(got["pos_k"].numpy(),
                                                  np.asarray(group[j]["pos_k"])[r])
                    assert got["pos_k"].dtype == torch.int32
                i += 1
    assert i == len(caches)


# ------------------------------------------------------------------ layers
def test_rms_norm_matches_reference():
    rs = np.random.default_rng(0)
    x = (rs.standard_normal((3, 7, 64)) * 5).astype(np.float32)
    scale = rs.standard_normal(64).astype(np.float32) * 0.1
    want = np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = L.rms_norm(torch.as_tensor(x), torch.as_tensor(scale)).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


def test_rope_matches_reference_up_to_position_4096():
    rs = np.random.default_rng(1)
    x = rs.standard_normal((2, 65, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(65) * 64, rs.integers(0, 4097, 65)]).astype(np.int32)
    want = np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0))
    got = L.rope(torch.as_tensor(x), torch.as_tensor(pos), theta=10000.0).numpy()
    assert pos.max() == 4096
    np.testing.assert_allclose(got, want, **LAYER_TOL)


def test_swiglu_matches_reference():
    rs = np.random.default_rng(2)
    p = jax.tree.map(np.asarray, RL.init_mlp(jax.random.PRNGKey(2), 64, 128, jnp.float32))
    x = rs.standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(RL.mlp_apply(p, jnp.asarray(x)))
    got = L.mlp_apply({k: torch.tensor(v) for k, v in p.items()},
                      torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


def test_init_draws_the_reference_distribution():
    gen = torch.Generator().manual_seed(0)
    w = L._init(gen, (512, 64, 8), dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (512, 64, 8)
    assert abs(float(w.float().std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert abs(float(w.float().mean())) < 1e-3
    e = L._init(gen, (4096, 32), scale=0.02)
    assert abs(float(e.std()) - 0.02) < 0.02 * 0.05


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_attention_train_prefill_and_decode_match_reference(n_rep, window):
    """Train mode, prefill into a cache longer than the prompt (padded)
    and, with a window, shorter (the roll), then three decode steps into
    each cache: outputs and caches against the reference."""
    B, S, D, H, hd = 2, 10, 64, 4, 16
    Hkv = H // n_rep
    p = jax.tree.map(np.asarray, RL.init_attention(jax.random.PRNGKey(n_rep), D, H, Hkv,
                                                   hd, jnp.float32))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    rs = np.random.default_rng(n_rep)
    x = rs.standard_normal((B, S + 3, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + 3, dtype=np.int32), (B, S + 3)) + \
        np.array([[0], [5]], np.int32)                    # rows at other offsets
    kw = dict(n_rep=n_rep, window=window, rope_theta=10000.0)

    want, _ = RL.attention(p, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]), **kw)
    got, _ = L.attention(tp, torch.as_tensor(x[:, :S]), torch.as_tensor(pos[:, :S]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    for C in ((16, 4) if window else (16,)):
        def cache(zeros, full):
            return {"k": zeros((B, C, Hkv, hd)), "v": zeros((B, C, Hkv, hd)),
                    "pos_k": full((B, C), np.iinfo(np.int32).max)}
        rc = cache(lambda s: jnp.zeros(s, jnp.float32), lambda s, v: jnp.full(s, v, jnp.int32))
        tc = cache(lambda s: torch.zeros(s), lambda s, v: torch.full(s, v, dtype=torch.int32))
        want, rc = RL.attention(p, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]),
                                cache=rc, **kw)
        got, tc = L.attention(tp, torch.as_tensor(x[:, :S]), torch.as_tensor(pos[:, :S]),
                              cache=tc, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for i in range(S, S + 3):
            want, rc = RL.attention(p, jnp.asarray(x[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]),
                                    cache=rc, decode=True, **kw)
            got, tc = L.attention(tp, torch.as_tensor(x[:, i:i + 1]),
                                  torch.as_tensor(pos[:, i:i + 1]), cache=tc, decode=True,
                                  **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            for name in ("k", "v"):
                np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), **TOL)
            np.testing.assert_array_equal(tc["pos_k"].numpy(), np.asarray(rc["pos_k"]))


def test_global_prefill_longer_than_its_cache_raises():
    p = L.init_attention(torch.Generator().manual_seed(0), 16, 2, 2, 8, torch.float32)
    cache = {"k": torch.zeros(1, 4, 2, 8), "v": torch.zeros(1, 4, 2, 8),
             "pos_k": torch.zeros(1, 4, dtype=torch.int32)}
    with pytest.raises(ValueError, match="does not fit"):
        L.attention(p, torch.zeros(1, 6, 16), torch.arange(6)[None], n_rep=1,
                    window=None, cache=cache)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("name", DENSE + MLA_MOE + SSM_ENCDEC + ("smoke",))
def test_forward_train_matches_reference(name):
    rcfg, cfg = configs(name)
    p, tp = weights(rcfg, cfg)
    jt, jkw, tt, tkw = both(*inputs(cfg, 2, 16))
    want = np.asarray(ref_forward(p, rcfg, jt, **jkw))
    got = M.forward(tp, cfg, tt, **tkw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", DENSE + MLA_MOE + SSM_ENCDEC)
def test_prefill_caches_and_decode_match_reference(name):
    """Prefill of 12 tokens (gemma3's window shrunk to 8, so its window
    layers take the roll) into caches of 32, then three greedy decode
    steps: logits and every layer's cache entries after each (k, v,
    pos_k; MLA's c_kv, k_rope; Mamba's conv, h; cross-attention's ck,
    cv)."""
    rcfg, cfg = configs(name)
    p, tp = weights(rcfg, cfg, seed=1)
    B, S, s_max = 2, 12, 32
    toks, stub = inputs(cfg, B, S, seed=1)
    jt, jkw, tt, tkw = both(toks, stub)
    enc_len = cfg.frontend_len if cfg.kind == "encdec" else 0
    rc = RM.init_cache(rcfg, B, s_max, dtype=jnp.float32, enc_len=enc_len)
    tc = M.init_cache(cfg, B, s_max, dtype=torch.float32, device="cpu", enc_len=enc_len)
    want, rc = ref_forward(p, rcfg, jt, caches=rc, mode="prefill", **jkw)
    got, tc = M.forward(tp, cfg, tt, caches=tc, mode="prefill", **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_caches(rc, tc, cfg)
    if name == "gemma3-4b":
        assert tc[0]["k"].shape[1] == 8 < S and tc[5]["k"].shape[1] == s_max

    pos0 = S + (cfg.frontend_len if cfg.frontend == "vision_stub" else 0)
    tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None].astype(np.int32)
    for i in range(3):
        positions = np.full((B, 1), pos0 + i, np.int32)
        want, rc = ref_forward(p, rcfg, jnp.asarray(tok), positions=jnp.asarray(positions),
                              caches=rc, mode="decode")
        got, tc = M.forward(tp, cfg, torch.as_tensor(tok), positions=torch.as_tensor(positions),
                            caches=tc, mode="decode")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_caches(rc, tc, cfg)
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "gemma3-4b"])
def test_teacher_forced_decode_reproduces_train_logits(name):
    """The reference's test_decode_matches_prefill_logits in the port, with
    a prompt longer than gemma3's shrunk window."""
    rcfg, cfg = configs(name)
    _, tp = weights(rcfg, cfg, seed=2)
    toks = torch.as_tensor(inputs(cfg, 1, 20, seed=2)[0])
    full = M.forward(tp, cfg, toks)
    caches = M.init_cache(cfg, 1, 24, dtype=torch.float32, device="cpu")
    pre = 10
    logits, caches = M.forward(tp, cfg, toks[:, :pre], caches=caches, mode="prefill")
    np.testing.assert_allclose(logits.numpy(), full[:, :pre].numpy(), **TOL)
    for i in range(pre, 20):
        logits, caches = M.forward(tp, cfg, toks[:, i:i + 1], caches=caches, mode="decode",
                                   positions=torch.full((1, 1), i, dtype=torch.int32))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i].numpy(), **TOL)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "gemma3-4b"])
def test_bf16_forward_within_ulps_of_reference(name):
    rcfg, cfg = configs(name, param_dtype="bfloat16", compute_dtype="bfloat16")
    p, tp = weights(rcfg, cfg, seed=3)
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np.asarray(p["embed"], np.float32))
    jt, jkw, tt, tkw = both(*inputs(cfg, 2, 16, seed=3))
    want = np.asarray(ref_forward(p, rcfg, jt, **jkw).astype(jnp.float32))
    got = M.forward(tp, cfg, tt, **tkw)
    assert got.dtype == torch.bfloat16
    peak = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    assert np.abs(got.float().numpy() - want).max() <= BF16_ULPS * ulp


def test_model_module_holds_the_same_function():
    rcfg, cfg = configs("gemma3-4b", tie_embeddings=False)
    p, tp = weights(rcfg, cfg)
    model = M.Model(cfg, device="cpu", params=tp)
    assert "top.lm_head" in dict(model.named_parameters())
    assert not any(q.requires_grad for q in model.parameters())
    jt, jkw, tt, tkw = both(*inputs(cfg, 1, 9))
    np.testing.assert_allclose(model(tt).numpy(), np.asarray(ref_forward(p, rcfg, jt)), **TOL)


def test_init_params_layout_dtype_and_count():
    """Random weights on the generator's device in param_dtype, one dict
    per layer, as many parameters as the analytic count and the final
    norm, which that count leaves out."""
    cfg = dataclasses.replace(shrink(get_arch("gemma3-4b").model), param_dtype="bfloat16")
    model = M.Model(cfg, device="cpu", seed=5)
    assert len(model.layers) == cfg.n_layers == 10
    assert all(q.dtype == torch.bfloat16 for q in model.parameters())
    assert sum(q.numel() for q in model.parameters()) == cfg.param_count()[0] + cfg.d_model
    again = M.Model(cfg, device="cpu", seed=5).params()
    assert torch.equal(again["layers"][3]["attn"]["wq"], model.params()["layers"][3]["attn"]["wq"])
    caches = M.init_cache(cfg, 3, 32, device="cpu")
    assert [c["k"].shape[1] for c in caches] == [8] * 5 + [32] + [8] * 4
    assert caches[0]["k"].dtype == torch.bfloat16
    assert int(caches[0]["pos_k"].min()) == np.iinfo(np.int32).max


def test_model_params_from_jax_splits_the_repeats_axis():
    rcfg, cfg = configs("gemma3-4b")
    rcfg = dataclasses.replace(rcfg, blocks=((rcfg.blocks[0][0], 2), rcfg.blocks[1]))
    cfg = dataclasses.replace(cfg, blocks=((cfg.blocks[0][0], 2), cfg.blocks[1]))
    p, tp = weights(rcfg, cfg)
    assert len(tp["layers"]) == 16
    # layer 6 + j is repeat 1, position j of group 0; layer 12 is group 1's first
    np.testing.assert_array_equal(tp["layers"][8]["attn"]["wk"].numpy(),
                                  p["groups"][0][2]["attn"]["wk"][1])
    np.testing.assert_array_equal(tp["layers"][12]["mlp"]["w_up"].numpy(),
                                  p["groups"][1][0]["mlp"]["w_up"][0])
    with pytest.raises(ValueError, match="groups hold"):
        interop.model_params_from_jax(p, configs("gemma3-4b")[1], device="cpu")
