"""The port's LLM serving path (``repro_torch.launch.{steps,serve,train}``)
against the reference's (``repro.launch``): the steps on the same weights
and inputs, and the continuous-batching driver's greedy tokens on the
``smoke`` preset with the reference's own weights.

Greedy tokens are compared in float32.  Two paths whose logits agree to
rtol 2e-4 and atol 2e-4 (the model contract of
``tests/test_torch_model.py``) can still pick different tokens where the
top two logits lie within that of each other; every difference must
trace to such a near-tie at its first differing step.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as RS
from repro.launch.mesh import local_test_mesh
from repro.launch.serve import main as ref_serve_main
from repro.launch.train import PRESETS as REF_PRESETS, preset_config as ref_preset
from repro.models import model as RM
from repro_torch import interop
from repro_torch.configs import get_arch, shrink
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as TST
from repro_torch.launch.train import PRESETS, preset_config
from repro_torch.models import model as M

FLAGS = ["--preset", "smoke", "--requests", "5", "--prompt-len", "8",
         "--max-new", "6", "--s-max", "32"]


def smoke_model(seed=0):
    """The smoke preset's reference config, params (numpy) and the port's
    config and Model on the same weights, as the reference's main draws
    them from --seed."""
    rcfg, cfg = ref_preset("smoke")[0], preset_config("smoke")[0]
    p = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(seed), rcfg))
    model = M.Model(cfg, device="cpu", params=interop.model_params_from_jax(p, cfg, device="cpu"))
    return rcfg, p, cfg, model


def smoke_queue(cfg, n=5, prompt_len=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=prompt_len).astype(np.int32)
            for _ in range(n)]


def assert_tokens_trace_to_near_ties(model, cfg, queue, got, want):
    """Every request whose tokens differ parts at a step where the port's
    float32 logits put the two tokens within the logits' tolerance."""
    for prompt, g, w in zip(queue, got, want):
        assert len(g) == len(w)
        if g == w:
            continue
        i = next(j for j in range(len(g)) if g[j] != w[j])
        seq = torch.as_tensor(np.concatenate([prompt, np.asarray(w[:i], np.int32)]))[None]
        logits = model(seq)[0, -1]
        a, b = float(logits[g[i]]), float(logits[w[i]])
        margin = 2 * (2e-4 + 2e-4 * max(abs(a), abs(b)))
        assert abs(a - b) <= margin, (
            f"token {i} differs ({g[i]} vs {w[i]}) on a margin {abs(a - b):.3g} "
            f"beyond {margin:.3g}")


@pytest.mark.parametrize("batch", [2, 3])
def test_serve_tokens_match_reference_main(batch):
    """The reference's own test load (test_train_serve_integration.py):
    the port's serve on the reference's weights and prompts gives the
    reference main's greedy tokens."""
    want = ref_serve_main(FLAGS + ["--batch", str(batch)])
    _, _, cfg, model = smoke_model()
    queue = smoke_queue(cfg)
    got, ticks = TS.serve(cfg, model, queue, batch=batch, max_new=6, s_max=32, device="cpu")
    assert all(len(o) == 6 for o in got)
    assert ticks == {2: 15, 3: 10}[batch]
    assert_tokens_trace_to_near_ties(model, cfg, queue, got, want)


def test_serve_batch_8_and_batch_1_agree():
    _, _, cfg, model = smoke_model(seed=1)
    queue = smoke_queue(cfg, n=8, prompt_len=12, seed=1)
    wide, _ = TS.serve(cfg, model, queue, batch=8, max_new=5, s_max=32, device="cpu")
    one, ticks = TS.serve(cfg, model, queue, batch=1, max_new=5, s_max=32, device="cpu")
    assert ticks == 8 * 4
    assert_tokens_trace_to_near_ties(model, cfg, queue, wide, one)


def test_serve_max_new_one_finishes_at_prefill_and_serves_every_request():
    """max_new == 1 finishes each request at its prefill with no decode
    tick.  The reference's loop breaks once every slot is free, so with
    more requests than slots it leaves the rest unserved (ROADMAP.md
    section C); the port serves them, and the tokens of those both serve
    agree."""
    want = ref_serve_main(FLAGS[:2] + ["--requests", "3", "--batch", "2", "--prompt-len", "8",
                                       "--max-new", "1", "--s-max", "16"])
    assert [len(o) for o in want] == [1, 1, 0]
    _, _, cfg, model = smoke_model()
    queue = smoke_queue(cfg, n=3)
    got, ticks = TS.serve(cfg, model, queue, batch=2, max_new=1, s_max=16, device="cpu")
    assert ticks == 0 and [len(o) for o in got] == [1, 1, 1]
    assert_tokens_trace_to_near_ties(model, cfg, queue[:2], got[:2], want[:2])
    alone, _ = TS.serve(cfg, model, queue[2:], batch=1, max_new=1, s_max=16, device="cpu")
    assert got[2] == alone[0]


def test_main_on_cpu_is_greedy_and_batch_invariant(capsys):
    outs = TS.main(FLAGS + ["--batch", "2", "--device", "cpu"])
    assert len(outs) == 5 and all(len(o) == 6 for o in outs)
    assert "[serve] 5 requests, 30 tokens, 15 decode ticks" in capsys.readouterr().out
    assert TS.main(FLAGS + ["--batch", "3", "--device", "cpu"])[0] == outs[0]


def test_steps_match_reference_steps():
    """make_prefill_step over the training layout (S + 1 tokens, the last
    dropped), then make_serve_step for three ticks: next tokens and the
    caches against the reference's steps on a one-device mesh."""
    rcfg, p, cfg, model = smoke_model(seed=2)
    B, S, s_max = 3, 9, 16
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mesh = local_test_mesh()
    with mesh:
        want_tok, rc = jax.jit(RS.make_prefill_step(rcfg, mesh, B, s_max))(
            p, {"tokens": jnp.asarray(toks)}, RM.init_cache(rcfg, B, s_max, dtype=jnp.float32))
    caches = M.init_cache(cfg, B, s_max, dtype=torch.float32, device="cpu")
    params = model.params()
    tok, caches = TST.make_prefill_step(cfg)(params, {"tokens": torch.as_tensor(toks)}, caches)
    assert tok.dtype == torch.int32 and tok.shape == (B, 1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    serve_step, ref_step = TST.make_serve_step(cfg), jax.jit(RS.make_serve_step(rcfg, mesh, B))
    pos = np.full((B,), S, np.int32)
    for _ in range(3):
        with mesh:
            want_tok, rc = ref_step(p, rc, want_tok, jnp.asarray(pos))
        tok, caches = serve_step(params, caches, tok, torch.as_tensor(pos))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
        pos += 1
    for layer, ref in zip(caches, rc[0][0]["k"]):
        np.testing.assert_allclose(layer["k"].numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_steps_take_the_first_index_on_ties():
    """All-zero weights tie every logit: argmax is token 0, as jnp.argmax."""
    def zero(t):
        if isinstance(t, dict):
            return {k: zero(v) for k, v in t.items()}
        return [zero(v) for v in t] if isinstance(t, list) else torch.zeros_like(t)

    cfg = preset_config("smoke")[0]
    zeros = zero(M.Model(cfg, device="cpu").params())
    caches = M.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    tok, caches = TST.make_prefill_step(cfg)(
        zeros, {"tokens": torch.ones(2, 4, dtype=torch.int64)}, caches)
    assert tok.tolist() == [[0], [0]]
    tok, _ = TST.make_serve_step(cfg)(zeros, caches, tok, torch.tensor([3, 3]))
    assert tok.tolist() == [[0], [0]]


def test_vision_stub_prefill_step_puts_the_prefix_first():
    cfg = shrink(get_arch("internvl2-2b").model)
    model = M.Model(cfg, device="cpu", seed=4)
    rs = np.random.default_rng(4)
    toks = torch.as_tensor(rs.integers(0, cfg.vocab_size, (1, 7)))
    embeds = torch.as_tensor(rs.standard_normal((1, cfg.frontend_len, cfg.d_model)),
                             dtype=torch.float32)
    caches = M.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    tok, caches = TST.make_prefill_step(cfg)(
        model.params(), {"tokens": toks, "patch_embeds": embeds}, caches)
    full = model(toks[:, :-1], embeds=embeds)
    assert int(tok[0, 0]) == int(torch.argmax(full[0, -1]))
    assert caches[0]["pos_k"][0, :cfg.frontend_len + 6].tolist() == list(range(cfg.frontend_len + 6))


def test_slot_cache_splice_writes_one_slot():
    cfg = dataclasses.replace(shrink(get_arch("gemma3-4b").model), compute_dtype="bfloat16")
    slots = TS.SlotCache(cfg, 3, 16, torch.bfloat16, "cpu")
    row = M.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    for i, layer in enumerate(row):
        layer["k"].fill_(i + 1)
        layer["v"].fill_(-(i + 1))
        layer["pos_k"].copy_(torch.arange(layer["pos_k"].shape[1]))
    slots.splice(row, 1)
    for i, (full, r) in enumerate(zip(slots.caches, row)):
        assert full["k"].dtype == torch.bfloat16 and full["pos_k"].dtype == torch.int32
        assert torch.equal(full["k"][1:2].float(), r["k"])
        assert torch.equal(full["v"][1:2].float(), r["v"])
        assert torch.equal(full["pos_k"][1:2], r["pos_k"])
        for s in (0, 2):
            assert not full["k"][s].any() and not full["v"][s].any()
            assert int(full["pos_k"][s].min()) == np.iinfo(np.int32).max


@pytest.mark.parametrize("name", list(REF_PRESETS))
def test_preset_config_matches_reference(name):
    ref, port = ref_preset(name), preset_config(name)
    assert dataclasses.asdict(port[0]) == dataclasses.asdict(ref[0])
    assert port[1:] == ref[1:]
    assert PRESETS == REF_PRESETS
