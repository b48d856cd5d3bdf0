"""MLA and the local MoE of the port (``repro_torch.models``) against the
reference's (``repro.models``): the layers alone on seeded numpy inputs,
then shrink(deepseek-v2-lite-16b) and shrink(kimi-k2-1t-a32b) through
``forward`` and the serving loop, on the reference's own weights
(``interop.model_params_from_jax``).

Tolerances are ``tests/test_torch_model.py``'s: logits at rtol = atol =
2e-4 in float32, a layer at rtol = atol = 1e-5, bfloat16 within
BF16_ULPS units in the last place of the largest |value|.

Routing is a discrete choice on float32 probabilities, and XLA's router
product rounds otherwise than torch's.  A token whose k-th and (k+1)-th
probabilities lie within NEAR_TIE of each other may pick another expert,
and that shifts the capacity ranks of the tokens after it.  Every
difference must trace to such a token, which is printed with its margin.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_arch as ref_arch, shrink as ref_shrink
from repro.launch.serve import SlotCache as RefSlotCache
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import interop
from repro_torch.configs import get_arch, shrink
from repro_torch.launch import serve as TS
from repro_torch.models import layers as L
from repro_torch.models import model as M

TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULPS = 8
# Probability margins that a few float32 roundings of the router product
# can cross (float32), or the MoE's input differing in bf16 roundings
# (bf16: a margin of 6.6e-4 flips at seed 0 below).
NEAR_TIE = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -9}
DEEPSEEK, KIMI = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"
ref_forward = jax.jit(RM.forward, static_argnames=("cfg", "mode"))
D, H, KV_LORA, D_NOPE, D_ROPE = 64, 4, 32, 16, 16     # shrink()'s widths


def configs(name, **over):
    return (dataclasses.replace(ref_shrink(ref_arch(name).model), **over),
            dataclasses.replace(shrink(get_arch(name).model), **over))


def weights(rcfg, cfg, seed=0):
    p = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(seed), rcfg))
    return p, interop.model_params_from_jax(p, cfg, device="cpu")


def port(tree):
    return {k: port(v) if isinstance(v, dict) else interop._tensor(v, "cpu")
            for k, v in tree.items()}


def seeded(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32).astype(dtype)


def ulps(want):
    """One bf16 unit in the last place of the largest |value|."""
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


# ------------------------------------------------------------------- MLA
def mla_params(dtype, seed=0):
    p = RL.init_mla(jax.random.PRNGKey(seed), D, H, kv_lora=KV_LORA, d_nope=D_NOPE,
                    d_rope=D_ROPE, d_v=16, dtype=dtype)
    p = jax.tree.map(np.asarray, p)
    return p, port(p)


def mla_caches(B, C, dtype):
    shapes = {"c_kv": (B, C, KV_LORA), "k_rope": (B, C, D_ROPE)}
    rc = {k: jnp.zeros(s, dtype) for k, s in shapes.items()}
    tc = {k: torch.zeros(s, dtype=getattr(torch, jnp.dtype(dtype).name)) for k, s in shapes.items()}
    rc["pos_k"] = jnp.full((B, C), np.iinfo(np.int32).max, jnp.int32)
    tc["pos_k"] = torch.full((B, C), np.iinfo(np.int32).max, dtype=torch.int32)
    return rc, tc


def assert_mla_cache(tc, rc, **tol):
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(rc[name], np.float32), **tol)
    assert tc["pos_k"].dtype == torch.int32
    np.testing.assert_array_equal(tc["pos_k"].numpy(), np.asarray(rc["pos_k"]))


def test_mla_train_prefill_and_decode_match_reference():
    """Train mode; prefill into a cache longer than the prompt (c_kv,
    k_rope and pos_k padded); then four absorbed decode steps, each
    writing slot pos % C in place, with the rows at other offsets."""
    B, S, C = 2, 10, 16
    p, tp = mla_params(jnp.float32)
    x = seeded((B, S + 4, D), 0)
    pos = np.arange(S + 4, dtype=np.int32)[None] + np.array([[0], [3]], np.int32)
    kw = dict(d_nope=D_NOPE, d_rope=D_ROPE, rope_theta=10000.0)

    want, _ = RL.mla_attention(p, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]), **kw)
    got, none = L.mla_attention(tp, torch.as_tensor(x[:, :S]), torch.as_tensor(pos[:, :S]), **kw)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)

    rc, tc = mla_caches(B, C, jnp.float32)
    want, rc = RL.mla_attention(p, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]),
                                cache=rc, **kw)
    got, tc = L.mla_attention(tp, torch.as_tensor(x[:, :S]), torch.as_tensor(pos[:, :S]),
                              cache=tc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert_mla_cache(tc, rc, **LAYER_TOL)
    assert int(tc["pos_k"][0, S]) == np.iinfo(np.int32).max
    for i in range(S, S + 4):
        xs, ps = x[:, i:i + 1], pos[:, i:i + 1]
        want, rc = RL.mla_attention(p, jnp.asarray(xs), jnp.asarray(ps), cache=rc,
                                    decode=True, **kw)
        got, tc2 = L.mla_attention(tp, torch.as_tensor(xs), torch.as_tensor(ps), cache=tc,
                                   decode=True, **kw)
        assert tc2 is tc                      # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
        assert_mla_cache(tc, rc, **LAYER_TOL)
    big = np.iinfo(np.int32).max
    assert tc["pos_k"][0].tolist() == list(range(S + 4)) + [big] * 2
    # row 1: prefill fills slots 0-9 (positions 3-12), decode writes pos % C
    assert tc["pos_k"][1].tolist() == [16] + list(range(4, 13)) + [big] * 3 + [13, 14, 15]


def test_mla_decode_past_the_cache_wraps_like_the_reference():
    """The compressed cache is circular with no window: a position past
    C overwrites slot pos % C, as the reference's does."""
    B, C = 1, 4
    p, tp = mla_params(jnp.float32, seed=1)
    x = seeded((B, 7, D), 1)
    kw = dict(d_nope=D_NOPE, d_rope=D_ROPE)
    rc, tc = mla_caches(B, C, jnp.float32)
    pos = np.arange(7, dtype=np.int32)[None]
    _, rc = RL.mla_attention(p, jnp.asarray(x[:, :3]), jnp.asarray(pos[:, :3]), cache=rc, **kw)
    _, tc = L.mla_attention(tp, torch.as_tensor(x[:, :3]), torch.as_tensor(pos[:, :3]),
                            cache=tc, **kw)
    for i in range(3, 7):
        want, rc = RL.mla_attention(p, jnp.asarray(x[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]),
                                    cache=rc, decode=True, **kw)
        got, tc = L.mla_attention(tp, torch.as_tensor(x[:, i:i + 1]),
                                  torch.as_tensor(pos[:, i:i + 1]), cache=tc, decode=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert tc["pos_k"][0].tolist() == [4, 5, 6, 3]
    assert_mla_cache(tc, rc, **LAYER_TOL)


def test_mla_bf16_within_ulps_of_reference():
    """bf16 weights and input: the score terms are bf16 products added in
    bf16, p·v, p·c_kv and ctx·W_uv float32 products (the reference's
    dtypes, step by step), in train, prefill and two decode steps."""
    B, S, C = 2, 12, 16
    p, tp = mla_params(jnp.bfloat16, seed=2)
    x = seeded((B, S + 2, D), 2, ml_dtypes.bfloat16)
    pos = np.tile(np.arange(S + 2, dtype=np.int32), (B, 1))
    kw = dict(d_nope=D_NOPE, d_rope=D_ROPE)
    rc, tc = mla_caches(B, C, jnp.bfloat16)
    want, rc = RL.mla_attention(p, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]), cache=rc, **kw)
    got, tc = L.mla_attention(tp, interop._tensor(x[:, :S], "cpu"), torch.as_tensor(pos[:, :S]),
                              cache=tc, **kw)
    assert got.dtype == torch.bfloat16 and tc["c_kv"].dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= BF16_ULPS * ulps(want)
    assert_mla_cache(tc, rc, atol=0, rtol=2.0 ** -7)
    for i in range(S, S + 2):
        want, rc = RL.mla_attention(p, jnp.asarray(x[:, i:i + 1]), jnp.asarray(pos[:, i:i + 1]),
                                    cache=rc, decode=True, **kw)
        got, tc = L.mla_attention(tp, interop._tensor(x[:, i:i + 1], "cpu"),
                                  torch.as_tensor(pos[:, i:i + 1]), cache=tc, decode=True, **kw)
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= BF16_ULPS * ulps(want)


def test_mla_prefill_longer_than_its_cache_raises():
    _, tp = mla_params(jnp.float32)
    _, tc = mla_caches(1, 4, jnp.float32)
    with pytest.raises(ValueError, match="does not fit"):
        L.mla_attention(tp, torch.zeros(1, 6, D), torch.arange(6)[None], d_nope=D_NOPE,
                        d_rope=D_ROPE, cache=tc)


# ------------------------------------------------------------------- MoE
E, TOP_K, D_FF = 4, 2, 32


def moe_params(dtype, seed=0):
    p = jax.tree.map(np.asarray, RL.init_moe(jax.random.PRNGKey(seed), D, D_FF, E, 2, D_FF,
                                             dtype))
    routed = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    return routed, port(routed)


def ref_dispatch(router, xt, top_k, capacity_factor):
    """The reference's routing and slot assignment
    (``repro/models/layers.py:302-323``) in jnp, for its picks, probs
    and dispatch rows, which ``moe_apply`` does not return."""
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32), router), axis=-1)
    _, eidx = lax.top_k(probs, top_k)
    T, n_exp = probs.shape
    C = max(int(np.ceil(T * top_k / n_exp * capacity_factor)), top_k)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = jnp.searchsorted(se, jnp.arange(n_exp, dtype=se.dtype), side="left")
    slot_sorted = jnp.arange(T * top_k, dtype=jnp.int32) - first[se].astype(jnp.int32)
    slot = jnp.zeros_like(slot_sorted).at[order].set(slot_sorted)
    dest = jnp.where(slot < C, flat_e * C + slot, n_exp * C)
    return np.asarray(probs), np.asarray(eidx), np.asarray(dest), C


def first_near_tie(probs, picks_got, picks_want, top_k, near_tie):
    """The first token whose picks differ (None if none), after checking
    that its k-th and (k+1)-th probabilities are within ``near_tie``;
    prints the margin."""
    differ = np.flatnonzero((np.sort(picks_got, 1) != np.sort(picks_want, 1)).any(1))
    if not len(differ):
        return None
    t = int(differ[0])
    s = np.sort(probs[t])[::-1]
    margin = float(s[top_k - 1] - s[top_k])
    print(f"token {t} picks {sorted(picks_got[t])} vs {sorted(picks_want[t])}: "
          f"k-th and (k+1)-th probabilities {s[top_k - 1]:.8g} and {s[top_k]:.8g}, "
          f"margin {margin:.3g}")
    assert margin <= near_tie, f"token {t} picks differ on a margin {margin:.3g}"
    return t


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_drops_the_reference_picks(dtype, cf):
    """Same input, same weights: the same top-k picks, the same dispatch
    rows (a pick past its expert's C slots dropped to row E·C, which
    occurs at capacity factor 1.25 and not at 8), and the same output."""
    B, S = 2, 8
    p, tp = moe_params(getattr(jnp, dtype), seed=3)
    assert tp["router"].dtype == torch.float32
    x = seeded((B, S, D), 3, ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    tx = interop._tensor(x, "cpu")
    probs, picks, want_dest, C = ref_dispatch(jnp.asarray(p["router"]),
                                              jnp.asarray(x).reshape(-1, D), TOP_K, cf)
    gate, got_picks, dest, C_port = L.moe_dispatch(tp["router"], tx.reshape(-1, D), TOP_K, cf)
    assert C_port == C and gate.dtype == tx.dtype
    np.testing.assert_allclose(gate.float().sum(-1).numpy(), 1.0, atol=2.0 ** -7)
    dropped = int((want_dest == E * C).sum())
    assert (dropped > 0) == (cf == 1.25), f"{dropped} picks dropped at capacity {C}"
    t = first_near_tie(probs, got_picks.numpy(), np.asarray(picks), TOP_K,
                       NEAR_TIE[torch.float32])
    n = B * S if t is None else t
    np.testing.assert_array_equal(dest.numpy()[:n * TOP_K], want_dest[:n * TOP_K])
    want = np.asarray(RL.moe_apply(p, jnp.asarray(x), top_k=TOP_K, capacity_factor=cf),
                      np.float32).reshape(B * S, D)
    got = L.moe_apply(tp, tx, top_k=TOP_K, capacity_factor=cf)
    assert got.dtype == tx.dtype and got.shape == (B, S, D)
    got = got.float().numpy().reshape(B * S, D)
    # a dropped pick adds nothing: a token with both picks dropped is zero
    both = (want_dest.reshape(-1, TOP_K) == E * C).all(1)
    assert not got[both].any()
    if dtype == "float32":
        # The reference draws the expert stacks at 1/sqrt(E), so outputs are
        # of order 50: LAYER_TOL's atol scales with the largest |value|.
        peak = np.abs(want).max()
        np.testing.assert_allclose(got[:n], want[:n], rtol=LAYER_TOL["rtol"],
                                   atol=LAYER_TOL["atol"] * peak)
    else:
        assert np.abs(got[:n] - want[:n]).max() <= BF16_ULPS * ulps(want)


def test_moe_ep_without_a_mesh_is_the_local_form():
    """moe_ep=True on one card (no mesh with a model axis) computes the
    local form, as the reference does without such a mesh."""
    _, cfg = configs(DEEPSEEK)
    _, tp = weights(*configs(DEEPSEEK))
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)))
    ep = dataclasses.replace(cfg, moe_ep=True)
    assert torch.equal(M.forward(tp, ep, toks), M.forward(tp, cfg, toks))


def test_moe_expert_parallel_raises():
    _, tp = moe_params(jnp.float32)
    with pytest.raises(ValueError, match="ep_group"):
        L.moe_apply(tp, torch.zeros(1, 2, D), top_k=TOP_K, ep_size=2)
    out = L.moe_apply(tp, torch.zeros(1, 2, D), top_k=TOP_K, ep_size=1)
    assert out.shape == (1, 2, D)


def test_moe_capacity_is_the_reference_expression():
    # ceil of T·k/E·cf in float64, never below k
    assert L.moe_capacity(8, 6, 64, 1.25) == 6
    assert L.moe_capacity(256, 6, 64, 1.25) == 30
    assert L.moe_capacity(128, 8, 384, 1.25) == 8
    for T in (1, 7, 96, 1000):
        assert L.moe_capacity(T, 6, 64, 64 / 6) == max(int(np.ceil(T * 6 / 64 * (64 / 6))), 6)


# ------------------------------------------------------------------ model
def moe_margins(fn):
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
@pytest.mark.parametrize("name", [DEEPSEEK, KIMI])
def test_bf16_forward_within_ulps_or_after_a_near_tie(name, seed):
    """In bf16 the MoE's input differs from the reference's by bf16
    roundings, so a token whose k-th and (k+1)-th probabilities lie
    within NEAR_TIE may route elsewhere.  Every token beyond BF16_ULPS
    must come at or after such a token in the call's order (at seed 0,
    deepseek's token 10 does, on a margin of 6.6e-4)."""
    rcfg, cfg = configs(name, param_dtype="bfloat16", compute_dtype="bfloat16")
    p, tp = weights(rcfg, cfg, seed=seed)
    assert tp["layers"][1]["mlp"]["router"].dtype == torch.float32
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(ref_forward(p, rcfg, jnp.asarray(toks)).astype(jnp.float32))
    got, seen = moe_margins(lambda: M.forward(tp, cfg, torch.as_tensor(toks)))
    assert got.dtype == torch.bfloat16
    bad = np.flatnonzero((np.abs(got.float().numpy() - want).max(-1) >
                          BF16_ULPS * ulps(want)).reshape(-1))
    if len(bad):
        s = np.sort(seen[0].numpy(), 1)[:, ::-1]
        margin = s[:, cfg.top_k - 1] - s[:, cfg.top_k]
        ties = np.flatnonzero(margin <= NEAR_TIE[torch.bfloat16])
        print(f"tokens beyond {BF16_ULPS} ulps: {bad.tolist()}; near-ties "
              f"{[(int(t), float(margin[t])) for t in ties]}")
        assert len(ties) and bad.min() >= ties.min()


@pytest.mark.parametrize("name", [DEEPSEEK, KIMI])
def test_init_params_moe_layout_and_count(name):
    """Random MoE/MLA weights on the generator's device: the router in
    float32 under bf16, the shared expert under mlp["shared"], as many
    parameters as the analytic count plus the final norm."""
    cfg = dataclasses.replace(shrink(get_arch(name).model), param_dtype="bfloat16")
    model = M.Model(cfg, device="cpu", seed=5)
    params = model.params()
    moe = params["layers"][1]["mlp"]
    assert moe["router"].dtype == torch.float32 and moe["w_gate"].dtype == torch.bfloat16
    assert moe["w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    assert moe["shared"]["w_up"].shape == (cfg.d_model, cfg.n_shared * cfg.d_ff_expert)
    assert sum(q.numel() for q in model.parameters()) == cfg.param_count()[0] + cfg.d_model
    caches = M.init_cache(cfg, 3, 16, device="cpu")
    if name == DEEPSEEK:
        assert set(params["layers"][0]["attn"]) == {"wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo"}
        assert caches[0]["c_kv"].shape == (3, 16, cfg.kv_lora)
        assert caches[0]["k_rope"].shape == (3, 16, cfg.d_rope)
    else:
        assert caches[0]["k"].shape == (3, 16, cfg.n_kv_heads, cfg.head_dim)
    assert int(caches[1]["pos_k"].min()) == np.iinfo(np.int32).max


def test_expert_stacks_draw_the_reference_distribution():
    """One expert at a time, at the reference's 1/sqrt(n_experts) scale."""
    w = L._init_experts(torch.Generator().manual_seed(0), (64, 256, 32), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (64, 256, 32)
    assert abs(float(w.float().std()) - 64 ** -0.5) < 0.02 * 64 ** -0.5
    assert abs(float(w.float().mean())) < 2e-3
    assert not torch.equal(w[0], w[1])


def test_model_params_from_jax_carries_the_moe_leaves():
    rcfg, cfg = configs(DEEPSEEK, param_dtype="bfloat16", compute_dtype="bfloat16")
    p, tp = weights(rcfg, cfg)
    mlp, ref = tp["layers"][1]["mlp"], p["groups"][1][0]["mlp"]
    assert mlp["router"].dtype == torch.float32
    np.testing.assert_array_equal(mlp["router"].numpy(), ref["router"][0])
    assert mlp["shared"]["w_down"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mlp["shared"]["w_down"].float().numpy(),
                                  np.asarray(ref["shared"]["w_down"][0], np.float32))
    np.testing.assert_array_equal(tp["layers"][0]["attn"]["w_uk"].float().numpy(),
                                  np.asarray(p["groups"][0][0]["attn"]["w_uk"][0], np.float32))


def test_teacher_forced_decode_reproduces_train_logits():
    """The absorbed decode against train mode's plain form, at a
    capacity factor of E/k so that no pick drops in either mode."""
    rcfg, cfg = configs(DEEPSEEK)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    _, tp = weights(rcfg, cfg, seed=2)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 20)))
    full = M.forward(tp, cfg, toks)
    caches = M.init_cache(cfg, 1, 24, dtype=torch.float32, device="cpu")
    logits, caches = M.forward(tp, cfg, toks[:, :10], caches=caches, mode="prefill")
    np.testing.assert_allclose(logits.numpy(), full[:, :10].numpy(), **TOL)
    for i in range(10, 20):
        logits, caches = M.forward(tp, cfg, toks[:, i:i + 1], caches=caches, mode="decode",
                                   positions=torch.full((1, 1), i, dtype=torch.int32))
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i].numpy(), **TOL)


# ---------------------------------------------------------------- serving
def ref_serve(rcfg, p, queue, *, batch, max_new, s_max):
    """The reference's continuous-batching loop (``repro/launch/serve.py``
    main, lines 87-121) over ``repro.models.model.forward``, in float32:
    free slots decode their stale token at their last position."""
    prefill = jax.jit(lambda p, toks, c: RM.forward(p, rcfg, toks, caches=c, mode="prefill"))
    decode = jax.jit(lambda p, c, tok, pos: RM.forward(p, rcfg, tok, positions=pos, caches=c,
                                                       mode="decode"))
    slots = RefSlotCache(rcfg, batch, s_max, jnp.float32)
    cur_tok = np.zeros((batch, 1), np.int32)
    cur_pos = np.zeros((batch,), np.int32)
    remaining = np.zeros((batch,), np.int32)
    outputs = [[] for _ in queue]
    slot_req = [-1] * batch
    next_req = done = 0
    while done < len(queue):
        for s in range(batch):
            if remaining[s] == 0 and next_req < len(queue):
                prompt = queue[next_req][None, :]
                row = RM.init_cache(rcfg, 1, s_max, dtype=jnp.float32)
                logits, row = prefill(p, jnp.asarray(prompt), row)
                slots.splice(row, s)
                cur_tok[s, 0] = int(jnp.argmax(logits[0, -1]))
                cur_pos[s] = prompt.shape[1]
                remaining[s] = max_new - 1
                slot_req[s] = next_req
                outputs[next_req].append(int(cur_tok[s, 0]))
                next_req += 1
        positions = jnp.asarray(cur_pos)[:, None]
        logits, slots.caches = decode(p, slots.caches, jnp.asarray(cur_tok), positions)
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1), np.int32)
        for s in range(batch):
            if remaining[s] > 0:
                outputs[slot_req[s]].append(int(nxt[s]))
                cur_tok[s, 0] = nxt[s]
                cur_pos[s] += 1
                remaining[s] -= 1
                if remaining[s] == 0:
                    done += 1
    return outputs


@pytest.mark.parametrize("batch", [2, 4])
def test_serve_tokens_match_the_reference_loop(batch):
    """Five requests of uneven prompts through both loops: with fewer
    requests than slots at the end, free slots decode stale tokens and
    take expert capacity in both."""
    rcfg, cfg = configs(DEEPSEEK)
    p, tp = weights(rcfg, cfg, seed=6)
    model = M.Model(cfg, device="cpu", params=tp)
    rng = np.random.default_rng(6)
    queue = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (8, 5, 8, 11, 6)]
    want = ref_serve(rcfg, p, queue, batch=batch, max_new=5, s_max=24)
    got, ticks = TS.serve(cfg, model, queue, batch=batch, max_new=5, s_max=24, device="cpu")
    assert all(len(o) == 5 for o in got)
    assert got == want


def test_slot_cache_splice_carries_the_compressed_cache():
    cfg = dataclasses.replace(shrink(get_arch(DEEPSEEK).model), compute_dtype="bfloat16")
    slots = TS.SlotCache(cfg, 3, 16, torch.bfloat16, "cpu")
    row = M.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    for i, layer in enumerate(row):
        layer["c_kv"].fill_(i + 1)
        layer["k_rope"].fill_(-(i + 1))
        layer["pos_k"].copy_(torch.arange(16))
    slots.splice(row, 2)
    for full, r in zip(slots.caches, row):
        assert set(full) == {"c_kv", "k_rope", "pos_k"}
        assert full["c_kv"].dtype == torch.bfloat16
        for name in ("c_kv", "k_rope", "pos_k"):
            assert torch.equal(full[name][2:3].to(r[name].dtype), r[name])
        for s in (0, 1):
            assert not full["c_kv"][s].any() and not full["k_rope"][s].any()
            assert int(full["pos_k"][s].min()) == np.iinfo(np.int32).max
