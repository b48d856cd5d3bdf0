"""The training path of the port (``lm_loss``, ``repro_torch.optim``,
``repro_torch.data``, ``repro_torch.checkpoint``, ``make_train_step`` and
``launch.train``) against the reference's, on the CPU at ``shrink()`` and
preset sizes, from the reference's own weights and state
(``interop.model_params_from_jax``, ``interop.train_state_from_jax``).

Tolerances: the loss at rtol = atol = 2e-4 (the reference's logits
contract, ``tests/test_archs_smoke.py:97-98``), each gradient tensor
within 1e-4 of its largest |value|.  The optimizers on the same numpy
gradients agree to float32 rounding (OPT_TOL: a few units in the last
place; XLA and torch round ``pow``, ``rsqrt`` and means in other
orders).  Whole train steps are compared by their losses: Adam's first
step is about ``sign(g)``, so gradients that differ in the last bits
near 0 move a parameter by a whole ``lr``.  Data batches are numpy's
and equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as RC
from repro.data import pipeline as RD
from repro.launch import steps as RS
from repro.launch.mesh import local_test_mesh
from repro.launch.train import build_state as ref_build_state
from repro.launch.train import main as ref_train_main
from repro.models import model as RM
from repro.optim import optimizers as RO
from repro_torch import interop
from repro_torch._tree import flatten
from repro_torch.checkpoint import CheckpointManager, all_steps, restore_state, save_state
from repro_torch.data import DataConfig, TokenDataset, make_batches, synthetic_dataset
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TT
from repro_torch.models import model as M
from repro_torch.optim import (OptConfig, apply_updates, global_norm, init_opt_state,
                               opt_step, opt_update, schedule_lr)
from repro_torch.optim.optimizers import leaf_groups
from test_torch_model import configs, inputs, weights

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 1e-4
OPT_TOL = dict(rtol=2e-6, atol=1e-9)
BF16_ULP = 2.0 ** -7

ref_loss_grad = jax.jit(jax.value_and_grad(RM.lm_loss), static_argnums=(1,))
# The reference's optimizer compiled once per case in float32, where eager
# compiles every op of every shape; eager in bfloat16, where XLA's jit may
# skip the roundings between bfloat16 ops (excess precision).
REF_OPT = {"float32": (jax.jit(RO.opt_update, static_argnums=(3,)), jax.jit(RO.apply_updates)),
           "bfloat16": (RO.opt_update, RO.apply_updates)}


def port_params(p, cfg):
    """The reference's parameters as the port's, leaves requiring grad."""
    tp = interop.model_params_from_jax(p, cfg, device="cpu")
    for t in flatten(tp).values():
        t.requires_grad_(True)
    return tp


def batches(cfg, batch, seq, seed=0):
    """(the reference's, the port's) lm_loss batch: seq + 1 tokens, the
    vision stub's ``patch_embeds`` and the encoder-decoder's
    ``audio_frames``."""
    toks, stub = inputs(cfg, batch, seq + 1, seed)
    names = {"embeds": "patch_embeds", "enc_frames": "audio_frames"}
    ref = {"tokens": jnp.asarray(toks), **{names[k]: jnp.asarray(v) for k, v in stub.items()}}
    got = {"tokens": torch.as_tensor(toks),
           **{names[k]: torch.as_tensor(v) for k, v in stub.items()}}
    return ref, got


def assert_grads(got: dict, want: dict):
    """Every gradient tensor within GRAD_TOL of its largest |value|."""
    assert set(got) == set(want)
    for path, g in got.items():
        w = np.asarray(want[path], np.float32)
        peak = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * peak + 1e-12, f"{path}: max |dg| {err:.3g}, max |g| {peak:.3g}"


# ------------------------------------------------------------------ lm_loss
@pytest.mark.parametrize("name,seq", [
    ("stablelm-1.6b", 16),             # dense GQA
    ("deepseek-v2-lite-16b", 16),      # MLA + MoE with shared experts
    ("falcon-mamba-7b", 256),          # Mamba, the chunked scan
    ("falcon-mamba-7b", 20),           # Mamba, the per-step scan
    ("whisper-base", 12),              # encoder-decoder
    ("internvl2-2b", 12),              # vision stub
])
def test_lm_loss_and_gradients_match_reference(name, seq):
    rcfg, cfg = configs(name)
    p, _ = weights(rcfg, cfg)
    rb, tb = batches(cfg, 2, seq, seed=1)
    # a masked target, as the reference's mask allows
    rb["tokens"] = rb["tokens"].at[0, -1].set(-1)
    tb["tokens"][0, -1] = -1
    want_loss, want_grads = ref_loss_grad(p, rcfg, rb)
    tp = port_params(p, cfg)
    loss = M.lm_loss(tp, cfg, tb)
    flat = flatten(tp)
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **LOSS_TOL)
    want = flatten(interop.model_params_from_jax(jax.tree.map(np.asarray, want_grads), cfg,
                                                 device="cpu"))
    assert_grads(dict(zip(flat, grads)), want)


def test_lm_loss_with_a_negative_input_token_matches_reference():
    """A masked ``-1`` inside a row is a target and an input at once: the
    input reads the embedding's last row, as the reference's indexing
    does, and the loss and gradients hold the reference's."""
    rcfg, cfg = configs("stablelm-1.6b")
    p, _ = weights(rcfg, cfg)
    rb, tb = batches(cfg, 2, 16, seed=2)
    rb["tokens"] = rb["tokens"].at[1, 7].set(-1)
    tb["tokens"][1, 7] = -1
    want_loss, want_grads = ref_loss_grad(p, rcfg, rb)
    loss, grads = _loss_grads(port_params(p, cfg), cfg, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    want = flatten(interop.model_params_from_jax(jax.tree.map(np.asarray, want_grads), cfg,
                                                 device="cpu"))
    assert_grads(grads, want)


REMAT_CASES = [("stablelm-1.6b", 16),     # dense: one layer per region
               ("jamba-v0.1-52b", 20),    # Mamba + attention + MoE: one 8-layer region
               ("whisper-base", 12)]      # encoder layers and decoder layers


def _loss_grads(tp, cfg, tb):
    flat = flatten(tp)
    loss = M.lm_loss(tp, cfg, tb)
    return loss.detach(), dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name,seq", REMAT_CASES)
def test_remat_gradients_are_bit_equal_and_match_reference(name, seq, remat):
    """remat recomputes the same values: the loss and every gradient equal
    those without remat bit for bit; and they hold the reference's
    ``jax.grad(lm_loss)`` under the same ``remat`` within GRAD_TOL."""
    rcfg, cfg = configs(name)
    p, _ = weights(rcfg, cfg)
    rb, tb = batches(cfg, 2, seq, seed=1)
    base_loss, base = _loss_grads(port_params(p, cfg), cfg, tb)
    rcfg_r, cfg_r = (dataclasses.replace(c, remat=remat) for c in (rcfg, cfg))
    loss, grads = _loss_grads(port_params(p, cfg_r), cfg_r, tb)
    assert torch.equal(loss, base_loss)
    assert all(torch.equal(grads[k], base[k]) for k in base)
    want_loss, want_grads = ref_loss_grad(p, rcfg_r, rb)
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    want = flatten(interop.model_params_from_jax(jax.tree.map(np.asarray, want_grads), cfg,
                                                 device="cpu"))
    assert_grads(grads, want)


def _op_calls(cfg, tp, tb):
    """aten op -> calls over one lm_loss and its gradients."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        _loss_grads(tp, cfg, tb)
    return c.n


def test_remat_dots_saves_the_projections_and_recomputes_the_scores():
    """"dots" keeps the outputs of the projections (``mm``, no batch
    dims) and recomputes the rest, the attention's per-head score
    products (``bmm``) among them; "full" recomputes the projections
    too."""
    rcfg, cfg = configs("stablelm-1.6b")
    p, _ = weights(rcfg, cfg)
    _, tb = batches(cfg, 2, 16, seed=1)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    calls = {r: _op_calls(c, port_params(p, c), tb) for r, c in (
        (r, dataclasses.replace(cfg, remat=r)) for r in ("none", "full", "dots"))}
    assert calls["dots"][mm] == calls["none"][mm] < calls["full"][mm]
    assert calls["none"][bmm] < calls["dots"][bmm] == calls["full"][bmm]


def test_embedding_gradient_has_no_atomic_accumulation():
    """The resume fault's cause, pinned: the lookups of ``embed`` and
    ``pos_embed`` go through ``embedding``, whose backward adds repeated
    rows in a fixed order, and never through indexing's backward
    (``index_put_`` with accumulate), which on the CPU adds them with
    atomic float adds across the intra-op threads in an order, and so
    with last bits, that vary from run to run under load.  The gradient
    is then the same bits at 1 thread and at several."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Accumulating(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kw = kwargs or {}
            if func.overloadpacket in (torch.ops.aten.index_put, torch.ops.aten.index_put_,
                                       torch.ops.aten._index_put_impl_) and \
                    (kw.get("accumulate") or (len(args) > 3 and args[3])):
                self.seen.append(str(func))
            return func(*args, **kw)

    for name in ("smoke", "whisper-base"):   # embed; learned positions, encoder's too
        rcfg, cfg = configs(name)
        p, _ = weights(rcfg, cfg)
        _, tb = batches(cfg, 4, 128, seed=1)
        with Accumulating() as mode:
            _loss_grads(port_params(p, cfg), cfg, tb)
        assert mode.seen == [], f"{name}: {mode.seen}"
    w = torch.randn(512, 128, generator=torch.Generator().manual_seed(0), requires_grad=True)
    tok = torch.randint(0, 512, (4, 128), generator=torch.Generator().manual_seed(1))
    up = torch.randn(4, 128, 128, generator=torch.Generator().manual_seed(2))
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = torch.autograd.grad(M._rows(w, tok), w, up)[0]
        torch.set_num_threads(max(threads, 4))
        many = torch.autograd.grad(M._rows(w, tok), w, up)[0]
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(one, many)


def test_scans_are_differentiable_and_unchanged_without_grad():
    """The Mamba scans compute the same bits with and without autograd."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    dA = torch.as_tensor(rng.uniform(0.5, 1.0, (1, 8, 3, 2)).astype(np.float32))
    dBx = torch.as_tensor(rng.standard_normal((1, 8, 3, 2)).astype(np.float32))
    h0 = torch.zeros(1, 3, 2)
    for scan in (lambda a, b: L._ssm_chunk_scan(a, b, h0, 4), lambda a, b: L._ssm_step_scan(a, b, h0)):
        plain, _ = scan(dA, dBx)
        a, b = dA.clone().requires_grad_(True), dBx.clone().requires_grad_(True)
        hs, _ = scan(a, b)
        assert torch.equal(hs.detach(), plain)
        ga, gb = torch.autograd.grad(hs.sum(), (a, b))
        assert torch.isfinite(ga).all() and torch.isfinite(gb).all()
        # d(sum hs)/d dBx_t = 1 + dA_{t+1} + dA_{t+1}·dA_{t+2} + ...
        tail = torch.ones_like(dA[:, -1:])
        want = [tail]
        for t in range(dA.shape[1] - 1, 0, -1):
            want.insert(0, 1 + dA[:, t:t + 1] * want[0])
        torch.testing.assert_close(gb, torch.cat(want, 1), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- optimizer
OPT_CASES = {
    "adamw": OptConfig(kind="adamw", lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                       warmup_steps=2, total_steps=10),
    "adamw-bf16": OptConfig(kind="adamw", lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                            warmup_steps=2, total_steps=10, moment_dtype="bfloat16"),
    "adafactor": OptConfig(kind="adafactor", lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                           warmup_steps=2, total_steps=10),
    "adafactor-bf16": OptConfig(kind="adafactor", lr=1e-2, weight_decay=0.01, grad_clip=0.5,
                                warmup_steps=1, total_steps=4, moment_dtype="bfloat16"),
}


def seeded_grads(p, seed, scale):
    """Numpy gradients shaped like the reference's parameters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32).astype(a.dtype), p)


def as_f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


def assert_opt_close(got, want, what, bf16=False):
    """Float32 within OPT_TOL; a bfloat16 value (a moment or parameter
    rounded from float32 values that differ in their last bits) within
    one bfloat16 unit in its last place."""
    want = as_f32(want)
    rtol = BF16_ULP if bf16 else OPT_TOL["rtol"]
    np.testing.assert_allclose(as_f32(got), want, err_msg=what, rtol=rtol,
                               atol=OPT_TOL["atol"] + 4e-7 * np.abs(want).max())


@pytest.mark.parametrize("kind,arch", [(k, "smoke") for k in sorted(OPT_CASES)]
                         + [("adamw", "whisper-base"), ("adafactor", "whisper-base")])
def test_opt_update_matches_reference_on_the_same_gradients(kind, arch):
    """Three steps of opt_update on the same numpy gradients, each from
    the reference's state before it (so a step's rounding does not carry
    into the next's inputs): updates, moments, Adafactor's stacked
    statistics and the parameters after apply_updates.  The smoke preset
    is one group of two repeats (its norm vectors (2, D) are factored,
    and the clip spans both layers); whisper's encoder is one group of
    two, its decoder of one (a (1, D) stack is not factored).  Step 0's
    gradients are small (no clip), the later ones large (clipped)."""
    ocfg = OPT_CASES[kind]
    rcfg, cfg = configs(arch)
    p, _ = weights(rcfg, cfg, seed=3)
    if ocfg.moment_dtype == "bfloat16":
        p = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), p)
    rp = jax.tree.map(jnp.asarray, p)
    rstate = RO.init_opt_state(rp, ocfg)
    ref_opt_update, ref_apply_updates = REF_OPT[ocfg.moment_dtype]
    fresh = init_opt_state(interop.model_params_from_jax(p, cfg, device="cpu"), ocfg, cfg)

    def port_state():
        return interop.train_state_from_jax({"params": jax.tree.map(np.asarray, rp),
                                             "opt": jax.tree.map(np.asarray, rstate)},
                                            cfg, device="cpu")

    assert {k: (t.shape, t.dtype) for k, t in flatten(port_state()["opt"]).items()} == \
        {k: (t.shape, t.dtype) for k, t in flatten(fresh).items()}
    for step in range(3):
        st = port_state()
        tp = st["params"]
        g = seeded_grads(p, 10 + step, scale=0.5 if step else 0.01)
        rupd, rstate = ref_opt_update(jax.tree.map(jnp.asarray, g), rp, rstate, ocfg)
        rp = ref_apply_updates(rp, rupd)
        tupd, tstate = opt_update(interop.model_params_from_jax(g, cfg, device="cpu"), tp,
                                  st["opt"], ocfg, cfg)
        apply_updates(tp, tupd)
        wupd = flatten(interop.model_params_from_jax(jax.tree.map(np.asarray, rupd), cfg,
                                                     device="cpu"))
        for path, u in flatten(tupd).items():
            assert_opt_close(u, wupd[path], f"step {step} update {path}")
        want = flatten(port_state())
        for path, t in flatten({"params": tp, "opt": tstate}).items():
            w = want[path]
            assert t.dtype == w.dtype, path
            if t.dtype == torch.int32:
                assert torch.equal(t, w)
            else:
                assert_opt_close(t.detach(), w.detach(), f"step {step} {path}",
                                 bf16=t.dtype == torch.bfloat16)


def test_adafactor_groups_follow_the_reference_stacking():
    rcfg, cfg = configs("smoke")
    _, tp = weights(rcfg, cfg)
    groups = leaf_groups(tp, cfg)
    assert groups["groups/0/0/norm1"] == (True, ["layers/0/norm1", "layers/1/norm1"])
    assert groups["embed"] == (False, ["embed"])
    st = init_opt_state(tp, OptConfig(kind="adafactor"), cfg)
    assert st["v"]["groups/0/0/norm1"]["vr"].shape == (2,)
    assert st["v"]["groups/0/0/norm1"]["vc"].shape == (cfg.d_model,)
    assert st["v"]["groups/0/0/attn/wq"]["vr"].shape == (2, cfg.d_model, cfg.n_heads)
    # a tree without layers: every leaf stands alone, as in the reference
    plain = init_opt_state({"w": torch.zeros(8, 4), "b": torch.zeros(4)},
                           OptConfig(kind="adafactor"), cfg)
    assert plain["v"]["w"]["vr"].shape == (8,) and plain["v"]["b"]["v"].shape == (4,)


def test_schedule_clip_and_opt_step():
    ocfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 5, 9, 10, 11, 50, 99, 150):
        np.testing.assert_allclose(float(schedule_lr(ocfg, torch.tensor(s, dtype=torch.int32))),
                                   float(RO.schedule_lr(ocfg, jnp.asarray(s))), rtol=1e-6)
    tree = {"a": torch.tensor([3.0, 4.0]), "b": [torch.tensor([[12.0]])]}
    assert float(global_norm(tree)) == 13.0
    # opt_step is opt_update then apply_updates, bit for bit
    rcfg, cfg = configs("smoke")
    p, _ = weights(rcfg, cfg)
    g = interop.model_params_from_jax(seeded_grads(p, 0, 1.0), cfg, device="cpu")
    for kind in ("adamw", "adafactor"):
        o = OptConfig(kind=kind, grad_clip=0.1)
        a, b = (interop.model_params_from_jax(p, cfg, device="cpu") for _ in range(2))
        sa, sb = init_opt_state(a, o, cfg), init_opt_state(b, o, cfg)
        apply_updates(a, opt_update(g, a, sa, o, cfg)[0])
        opt_step(g, b, sb, o, cfg)
        fb = flatten({"p": b, "s": sb})
        for path, t in flatten({"p": a, "s": sa}).items():
            assert torch.equal(t, fb[path]), path
        assert int(sa["step"]) == 1


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_steps_match_reference_losses(kind):
    """Three whole train steps from the reference's own state: the
    losses agree (each step's parameters come from the one before)."""
    rcfg, cfg = configs("smoke")
    ocfg = OptConfig(kind=kind, lr=1e-2, warmup_steps=1, total_steps=10)
    mesh = local_test_mesh()
    rstate, _, _ = ref_build_state(rcfg, ocfg, mesh, jax.random.PRNGKey(0))
    tstate = interop.train_state_from_jax(jax.tree.map(np.asarray, rstate), cfg, device="cpu")
    rstep = jax.jit(RS.make_train_step(rcfg, ocfg, mesh, 2))
    tstep = TST.make_train_step(cfg, ocfg)
    ds = RD.synthetic_dataset(RD.DataConfig(seq_len=32, global_batch=2, vocab_size=cfg.vocab_size,
                                            seed=5), 1 << 12)
    for s in range(3):
        toks = ds.batch_at(s)
        with mesh:
            rstate, rloss = rstep(rstate, {"tokens": jnp.asarray(toks)})
        tstate, tloss = tstep(tstate, {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(float(tloss), float(rloss), **LOSS_TOL)
    assert int(tstate["opt"]["step"]) == 3


# -------------------------------------------------------------------- data
def _dcfg(mod, **kw):
    return mod.DataConfig(**{**dict(seq_len=16, global_batch=8, vocab_size=97, seed=3), **kw})


@pytest.mark.parametrize("hosts", [1, 2])
def test_batches_equal_reference_bit_for_bit(hosts, tmp_path):
    ref = RD.synthetic_dataset(_dcfg(RD), 1 << 12)
    got = synthetic_dataset(_dcfg(sys.modules[DataConfig.__module__]), 1 << 12)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert _dcfg(RD).fingerprint() == DataConfig(seq_len=16, global_batch=8, vocab_size=97,
                                                 seed=3).fingerprint()
    path = tmp_path / "toks.bin"
    ref.tokens.astype(np.uint16).tofile(path)
    for h in range(hosts):
        rc, tc = _dcfg(RD, host_index=h, host_count=hosts), DataConfig(
            seq_len=16, global_batch=8, vocab_size=97, seed=3, host_index=h, host_count=hosts)
        rds, tds = RD.TokenDataset(ref.tokens, rc), TokenDataset(got.tokens, tc)
        for s in (0, 17, 2**40 + 3):
            np.testing.assert_array_equal(tds.batch_at(s), rds.batch_at(s))
            assert tds.batch_at(s).dtype == np.int32
        mine = [(s, b.copy()) for s, b in make_batches(tds, 3, 7)]
        theirs = [(s, b.copy()) for s, b in RD.make_batches(rds, 3, 7)]
        assert [s for s, _ in mine] == [s for s, _ in theirs] == [3, 4, 5, 6]
        for (_, a), (_, b) in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
        fb = TokenDataset.from_bin(path, tc)
        np.testing.assert_array_equal(fb.batch_at(9), RD.TokenDataset.from_bin(path, rc).batch_at(9))


# -------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_bf16_and_reference_layout(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                        "h": torch.randn(4, generator=torch.Generator().manual_seed(0)).bfloat16(),
                        "layers": [{"n": torch.ones(2)}]},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    final = save_state(tmp_path, 7, state, extras={"data_step": 7})
    assert final.name == "step_000000007" and not (tmp_path / "step_000000007.tmp").exists()
    manifest = json.loads((final / "manifest.json").read_text())
    paths = {r["path"]: r["dtype"] for r in manifest["leaves"]}
    assert paths == {"params/w": "float32", "params/h": "bfloat16", "params/layers/0/n": "float32",
                     "opt/step": "int32"}
    assert np.load(final / "arr_000001.npy").dtype == np.uint16
    restored, extras = restore_state(tmp_path, 7, state, device="cpu")
    for path, t in flatten(state).items():
        r = flatten(restored)[path]
        assert r.dtype == t.dtype and torch.equal(r, t), path
    assert extras["data_step"] == 7
    # the reference's directory protocol: its own lister sees the step
    assert RC.all_steps(tmp_path) == [7]
    with pytest.raises(ValueError, match="missing"):
        restore_state(tmp_path, 7, {**state, "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        restore_state(tmp_path, 7, {**state, "opt": {"step": torch.zeros(2, dtype=torch.int32)}})


def test_checkpoint_atomicity(tmp_path):
    """A .tmp directory (crash mid-write) is never listed as a checkpoint."""
    save_state(tmp_path, 1, {"w": torch.zeros(3)})
    (tmp_path / "step_000000002.tmp").mkdir()
    (tmp_path / "step_000000002.tmp" / "manifest.json").write_text("{}")
    assert all_steps(tmp_path) == [1]


def test_manager_retention_async_and_restore_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "a", keep_last=2, keep_every=4)
    for s in range(1, 7):
        mgr.save_async(s, {"w": torch.full((4,), float(s))}, extras={"data_step": s})
    mgr.wait()
    assert sorted(all_steps(tmp_path / "a")) == [4, 5, 6]
    assert mgr.latest_step() == 6
    restored, extras = mgr.restore({"w": torch.zeros(4)})
    assert extras["data_step"] == 6 and torch.equal(restored["w"], torch.full((4,), 6.0))
    restored, _ = mgr.restore({"w": torch.zeros(4, dtype=torch.float64)}, step=4, device="cpu")
    assert restored["w"].dtype == torch.float64 and float(restored["w"][0]) == 4.0
    assert CheckpointManager(tmp_path / "b").restore({"w": torch.zeros(4)}) == (None, None)


def test_async_save_snapshots_before_training_moves_on(tmp_path):
    mgr = CheckpointManager(tmp_path)
    w = torch.ones(1000)
    mgr.save_async(1, {"w": w})
    w.add_(1.0)               # the next step writes the parameters in place
    mgr.wait()
    assert float(restore_state(tmp_path, 1, {"w": w})[0]["w"].max()) == 1.0


# ------------------------------------------------------------------ driver
def test_train_loss_decreases_and_resume_identical(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    losses = TT.main(["--device", "cpu", "--preset", "smoke", "--steps", "12",
                      "--ckpt-dir", ckpt, "--ckpt-every", "5", "--log-every", "100"])
    assert len(losses) == 12
    assert losses[-1] < losses[0], "loss must decrease"
    assert sorted(all_steps(ckpt)) == [5, 10]
    losses2 = TT.main(["--device", "cpu", "--preset", "smoke", "--steps", "12",
                       "--ckpt-dir", ckpt, "--resume", "--ckpt-every", "100",
                       "--log-every", "100"])
    assert losses2 == losses[10:], "resumed stream must be identical"


def test_train_main_matches_reference_losses(tmp_path):
    """The two drivers from the same state: the reference's main builds
    its state from ``--seed 0``; the port's resumes from that state,
    carried over by ``interop`` and saved as step 0.  The same schedule,
    batch stream and steps give the same losses."""
    argv = ["--preset", "smoke", "--steps", "3", "--log-every", "100"]
    want = ref_train_main(argv)
    rcfg, cfg = configs("smoke")
    # the optimizer main configures for --steps 3 (launch/train.py)
    ocfg = OptConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    rstate, _, _ = ref_build_state(rcfg, ocfg, local_test_mesh(), jax.random.PRNGKey(0))
    save_state(tmp_path, 0, interop.train_state_from_jax(jax.tree.map(np.asarray, rstate), cfg,
                                                         device="cpu"),
               extras={"data_step": 0})
    got = TT.main(["--device", "cpu", *argv, "--ckpt-dir", str(tmp_path), "--resume"])
    assert len(got) == 3
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_train_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main(["--preset", "smoke", "--steps", "1"])


def test_sigterm_leaves_an_emergency_checkpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--preset",
         "smoke", "--steps", "100000", "--ckpt-dir", str(tmp_path), "--ckpt-every", "100000",
         "--log-every", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if "step=" in line:
                break
            assert time.monotonic() < deadline
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    assert "emergency checkpoint" in out
    (step,) = all_steps(tmp_path)
    manifest = json.loads((tmp_path / f"step_{step:09d}" / "manifest.json").read_text())
    assert manifest["extras"]["emergency"] is True
    assert manifest["extras"]["data_step"] == step >= 1
