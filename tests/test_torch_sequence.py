"""The sequence axis of the serving caches (``distributed.sequence``, the
sequence-cut path of ``make_prefill_step`` and ``make_serve_step``) on
the CPU.

Without a process group: the merge of n partials (n = 1 to 4) against
the whole masked softmax·v in the GQA grouped and the MLA absorbed
forms, with a fully masked block, a window mask and a cache length that
n does not divide; the owner's write across the wrap past C and the
prefill's block against the whole layout; ``cache_blocks``' shapes
against ``cache_specs`` at batch 1; over a (1, 1) mesh (a gloo group of
one in this process) the sharded steps' tokens and caches bit for bit
the unsharded ones'.

Over gloo process groups of subprocesses at world sizes 2 and 4
(``torch_train_worker.py seq``, one launch per world size), at batch 1:
the caches cut over the data axes on (2, 1), (4, 1) and (2, 2), and with
``seq_shard_kv`` over ``model`` on (1, 2) and (1, 4); and (2, 2) with
``seq_shard_kv`` at batch 2, where the batch is cut over ``data`` and
the sequence over ``model``.  Cases: shrink(gemma3-4b) (a window of 8
that wraps across the ranks' blocks), shrink(deepseek-v2-lite-16b)
(MLA), shrink(jamba-v0.1-52b) (attention beside Mamba),
shrink(granite-20b) (one KV head) and 6 q heads over 3 KV heads with a
vocabulary of 250.  A prompt of 12, then 9 ticks, in caches of 22 slots.

Tolerances:

* ``ORDER_TOL`` (rtol = atol = 1e-5): the merge against the whole
  softmax·v, and every tick's logits against the whole form's (the steps
  without a mesh).  The merge rescales each block's sum by
  ``exp(m_r - m)`` and adds the blocks in another order: a few float32
  roundings of values of order one, where a block merged wrongly
  (missing, or not rescaled) moves the output by its own weight.
* ``REF_TOL`` (rtol = atol = 2e-4): every tick's logits against the
  reference's unsharded forward on the same weights and tokens, the
  model contract of ``tests/test_torch_model.py``.

Tokens are greedy; where the port and the reference part, the logits
are compared up to there and the near-tie's margin is printed (``-s``).
Every rendezvous goes through a file under the test's temporary
directory; every subprocess has a timeout.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import model as RM
from repro_torch.distributed import sequence as SQ
from repro_torch.distributed.sharded import shard_state
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from test_torch_model import configs, ref_forward
from torch_train_worker import (SEQ_CASES, SEQ_PROMPT, SEQ_RUNS, SEQ_SMAX, SEQ_TICKS,
                                seq_cfg, seq_inputs, serve_steps)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_train_worker.py"
TIMEOUT_S = 240
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)
INT32_MAX = torch.iinfo(torch.int32).max


# ------------------------------------------------------------------ merge
def blocks_of(t, n, dim=1, fill=0):
    """``t`` cut into n blocks of ceil(C/n) along ``dim``, the last ones
    padded with ``fill``."""
    C = t.shape[dim]
    b = SQ.block_len(C, n)
    pad = list(t.shape)
    pad[dim] = n * b - C
    full = torch.cat([t, torch.full(pad, fill, dtype=t.dtype)], dim)
    return list(full.split(b, dim))


#: slot positions of a cache of C = 10 at the token's position 25: "open"
#: holds positions 0-5 and unwritten slots (int32 max) from 6 on, so
#: every block past the first two of 3 or 4 is fully masked; "window" is
#: a wrapped circular buffer of positions 16-25 under a window of 6.
POS = {"open": (np.r_[np.arange(6), [INT32_MAX] * 4], None),
       "window": (np.array([20, 21, 22, 23, 24, 25, 16, 17, 18, 19]), 6)}


def valid_of(case, B=2):
    pk, window = POS[case]
    pc = torch.as_tensor(np.tile(pk, (B, 1)), dtype=torch.int32)
    valid = pc <= 25
    if window is not None:
        valid = valid & (pc > 25 - window)
    return valid


@pytest.mark.parametrize("case", sorted(POS))
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["gqa", "mla"])
def test_merge_of_partials_holds_the_whole_softmax(form, n, case):
    """The partials of n slot blocks merged (``sequence.merge``) against
    the whole form's masked softmax·v of the decode; a fully masked
    block's max is the mask's -1e30 and it adds nothing."""
    g = torch.Generator().manual_seed(n)
    B, C = 2, 10
    valid = valid_of(case, B)
    vb = blocks_of(valid, n, fill=False)
    if form == "gqa":
        H, G, hd = 4, 2, 16
        q = torch.randn(B, 1, H, hd, generator=g)
        k, v = torch.randn(B, C, G, hd, generator=g), torch.randn(B, C, G, hd, generator=g)
        want = L._gqa_out(L._softmax(L._gqa_scores(q, k, H // G), valid[:, None, None, None, :]),
                          v, H // G)
        parts = [L.gqa_partial(q, kb, vb_, H // G, m)
                 for kb, vb_, m in zip(blocks_of(k, n), blocks_of(v, n), vb)]
        got = L.gqa_heads(SQ.merge(parts))
    else:
        H, c, dr, scale = 4, 32, 16, 0.125
        q_abs, q_r = torch.randn(B, 1, H, c, generator=g), torch.randn(B, 1, H, dr, generator=g)
        ckv, kr = torch.randn(B, C, c, generator=g), torch.randn(B, C, dr, generator=g)
        p = L._softmax(L._mla_scores("bshc,btc->bsht", q_abs, ckv, q_r, kr, scale),
                       valid[:, None, None, :])
        want = torch.einsum("bsht,btc->bshc", p, ckv)
        parts = [L.mla_partial(q_abs, q_r, cb, kb, m, scale)
                 for cb, kb, m in zip(blocks_of(ckv, n), blocks_of(kr, n), vb)]
        got = SQ.merge(parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ORDER_TOL)
    for (m, _, _), mask in zip(parts, vb):
        if not mask.any():
            assert bool((m == SQ.MASKED).all())
    if case == "open" and n >= 3:
        assert not vb[-1].any()


def cut(n, r, C):
    """Rank r's cut of C slots over n ranks, no mesh (no collective)."""
    return SQ.SeqCut(("data",), None, n, r, C, SQ.block_len(C, n))


def prefill_layout(x, positions, window, C):
    """The prefill's layout of ``x`` (B, S, ...) in C slots: on a window
    layer shorter than the prompt, each row's last C entries rolled by
    its position S - C modulo C; else padded with zeros (int32 max for
    positions)."""
    B, S = positions.shape
    if window is not None and C < S:
        return torch.stack([torch.roll(x[b, S - C:], int(positions[b, S - C]) % C, 0)
                            for b in range(B)])
    fill = INT32_MAX if x.dtype == torch.int32 else 0
    return torch.cat([x, torch.full((B, C - S) + x.shape[2:], fill, dtype=x.dtype)], 1)


@pytest.mark.parametrize("n", [3, 4])
def test_owner_writes_across_the_wrap_and_prefill_keeps_its_block(n):
    """Blocks of a cache of C = 10 over n ranks (the last padded): a
    prefill's blocks (a global layer, 7 prompt positions, and a window
    layer of 10 slots after a prompt of 13, which takes the roll), then
    the token written at pos % C by its owner for positions up to 2.5 C
    past, two rows 3 positions apart: the blocks put together equal the
    whole cache, written the unsharded way, and the pad slots hold zeros
    and int32 max throughout.  The whole prefill equals the layout built
    here with ``torch.roll`` and padding."""
    C, B, hd = 10, 2, 4
    g = torch.Generator().manual_seed(0)
    for window, S in ((None, 7), (10, 13)):
        k = torch.randn(B, S, 1, hd, generator=g)
        positions = torch.arange(S, dtype=torch.int32).expand(B, S) + torch.tensor([[0], [3]],
                                                                                  dtype=torch.int32)
        whole = {"k": torch.zeros(B, C, 1, hd), "v": torch.zeros(B, C, 1, hd),
                 "pos_k": torch.full((B, C), INT32_MAX, dtype=torch.int32)}
        whole = L._prefill_cache(whole, {"k": k, "v": 2 * k}, positions, window)
        for name, x in (("k", k), ("v", 2 * k), ("pos_k", positions)):
            assert torch.equal(whole[name], prefill_layout(x, positions, window, C)), name
        blocks = []
        for r in range(n):
            b = SQ.block_len(C, n)
            shell = {"k": torch.zeros(B, b, 1, hd), "v": torch.zeros(B, b, 1, hd)}
            blocks.append(L._prefill_cache(shell, {"k": k, "v": 2 * k}, positions, window,
                                           cut(n, r, C)))
        for pos0 in range(S, S + 25):
            pos = positions[:, -1] + 1 + (pos0 - S)
            val = {"k": torch.randn(B, 1, hd, generator=g)}
            val["v"], val["pos_k"] = 3 * val["k"], pos.to(torch.int32)
            L._write_token(whole, pos, val, None)
            for r in range(n):
                L._write_token(blocks[r], pos, val, cut(n, r, C))
            for name in whole:
                put = torch.cat([blk[name] for blk in blocks], 1)
                assert torch.equal(put[:, :C], whole[name]), (window, pos0, name)
                fill = INT32_MAX if name == "pos_k" else 0
                assert bool((put[:, C:] == fill).all())


#: The families of the sequence cases, their shrink()s at full cache
#: length 64 over production-like fake meshes.
@pytest.mark.parametrize("knob", [False, True])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (16, 16), (1, 4)])
def test_cache_blocks_follow_cache_specs(shape, knob):
    """At batch 1, each layer's block from ``cache_blocks`` has every dim
    of the whole cache cut (rounded up) by the axes its ``cache_specs``
    entry names, and the blocks' bytes equal ``bytes_under_specs`` of the
    whole cache: the sequence cut over the data axes where any has more
    than one rank, else over ``model`` with ``seq_shard_kv`` where the KV
    heads do not divide it (no window) and on every MLA layer."""
    mesh = (shape, ("data", "model"))
    sizes = dict(zip(mesh[1], shape))
    for name in SEQ_CASES:
        cfg = seq_cfg(name, seq_shard_kv=knob)
        whole = M.init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
        got = TST.cache_blocks(cfg, mesh, 1, 64, dtype=torch.float32, device="cpu")
        specs = TST.cache_specs(cfg, mesh, 1)
        for w, b, sp, ls in zip(whole, got, specs, M.layer_specs(cfg)):
            for k in w:
                want = tuple(-(-n // math.prod(sizes[a] for a in
                                               (e if isinstance(e, tuple) else (e,)) if a))
                             for n, e in zip(w[k].shape, sp[k]))
                assert tuple(b[k].shape) == want, (name, k, sp[k])
            seq = SQ.seq_entry(sp)
            if ls.kind != "mamba" and shape[0] > 1:
                assert seq == "data"
            elif ls.kind == "mla" or (ls.kind == "attn" and ls.window is None
                                      and cfg.n_kv_heads % shape[1]):
                assert seq == ("model" if knob else None), (name, ls)
            else:
                assert seq is None
        assert sum(t.numel() * 4 for c in got for t in c.values()) == \
            TST.bytes_under_specs(whole, specs, mesh)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process, destroyed after."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_group_of_one_is_the_unsharded_path(world_of_one):
    """Over a (1, 1) mesh every group has one rank: no layer's sequence
    is cut, and the sharded steps' tokens, logits and caches equal the
    unsharded steps' bit for bit, with and without ``seq_shard_kv``."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    for knob in (False, True):
        cfg = seq_cfg("gemma3-4b", seq_shard_kv=knob)
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (1, SEQ_PROMPT))
        pspecs = TST.param_specs(params, cfg, mesh)
        plan, _ = TST._serving_plan(cfg, mesh, pspecs, 1, SEQ_SMAX)
        assert len(plan.seq) == cfg.n_layers and not any(plan.seq)
        t0, l0, c0 = serve_steps(cfg, params, prompts)
        t1, l1, c1 = serve_steps(cfg, shard_state(params, pspecs, mesh), prompts, mesh, pspecs, 1)
        assert torch.equal(t0, t1) and np.array_equal(l0, l1)
        assert all(torch.equal(a[k], b[k]) for a, b in zip(c0, c1) for k in a)


# ------------------------------------------------------------ over gloo
def ref_cfg(name):
    """The reference's shrink() config of a case, the MoE at capacity
    factor E/k as the port's."""
    arch, over = SEQ_CASES[name]
    rcfg, _ = configs(arch, **over)
    if rcfg.n_experts:
        rcfg = dataclasses.replace(rcfg, capacity_factor=rcfg.n_experts / rcfg.top_k)
    return rcfg


def ref_params(params, cfg):
    """The port's parameters in the reference's layout (numpy): each
    group's layers stacked on a leading ``repeats`` axis, the inverse of
    ``interop.model_params_from_jax``."""
    def stacked(trees):
        if isinstance(trees[0], dict):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return np.stack([t.numpy() for t in trees])

    out = {k: v.numpy() for k, v in params.items() if k != "layers"}
    out["groups"], j = [], 0
    for pattern, reps in cfg.blocks:
        n = len(pattern)
        out["groups"].append(tuple(stacked([params["layers"][j + r * n + i] for r in range(reps)])
                                   for i in range(n)))
        j += n * reps
    return out


def ref_serve(name):
    """The reference's unsharded forward on the case's weights, greedy
    over both prompts (:func:`torch_train_worker.seq_inputs`): a prefill,
    then SEQ_TICKS decode steps.  Returns (tokens (2, ticks + 1), every
    step's last logits (ticks + 1, 2, V))."""
    rcfg = ref_cfg(name)
    params, prompts = seq_inputs(name)
    p = jax.tree.map(jnp.asarray, ref_params(params, seq_cfg(name)))
    caches = RM.init_cache(rcfg, 2, SEQ_SMAX, dtype=jnp.float32)
    logits, caches = ref_forward(p, rcfg, jnp.asarray(prompts), caches=caches, mode="prefill")
    steps = [np.asarray(logits[:, -1])]
    tok = np.argmax(steps[-1], -1).astype(np.int32)[:, None]
    toks = [tok]
    for i in range(SEQ_TICKS):
        pos = np.full((2, 1), SEQ_PROMPT + i, np.int32)
        logits, caches = ref_forward(p, rcfg, jnp.asarray(tok), positions=jnp.asarray(pos),
                                     caches=caches, mode="decode")
        steps.append(np.asarray(logits[:, -1]))
        tok = np.argmax(steps[-1], -1).astype(np.int32)[:, None]
        toks.append(tok)
    return np.concatenate(toks, 1), np.stack(steps)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers at world sizes 2 and 4, run while this process
    computes the reference's tokens and logits."""
    base = tmp_path_factory.mktemp("sequence")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs, logs = [], []
    for world in SEQ_RUNS:
        (base / f"w{world}").mkdir()
        for r in range(world):
            logs.append(open(base / f"w{world}" / f"log{r}.txt", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world), str(base / f"w{world}" / "init"),
                 str(base / f"w{world}"), "seq"],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    try:
        ref = {name: ref_serve(name) for name in SEQ_CASES}
        for p, log in zip(procs, logs):
            p.wait(timeout=TIMEOUT_S)
            log.close()
            assert p.returncode == 0, Path(log.name).read_text()[-4000:]
    finally:
        for p in procs:
            p.kill()
    ranks = {w: [pickle.loads((base / f"w{w}" / f"seq{r}.pkl").read_bytes()) for r in range(w)]
             for w in SEQ_RUNS}
    return {"ranks": ranks, "ref": ref}


def each_run(run, name):
    """(world, mesh shape, seq_shard_kv, rank, record) of every run of ``name``."""
    for world, recs in run["ranks"].items():
        for shape, knob, _ in SEQ_RUNS[world]:
            for r, rec in enumerate(recs):
                yield world, shape, knob, r, rec[(name, shape, knob)]


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_seq_cut_serving_equals_unsharded_serve(run, name):
    """Every run gives ``launch.serve.serve``'s tokens unsharded, and
    every step's logits (the prefill's and each tick's) hold the whole
    form's at ORDER_TOL."""
    for world, shape, knob, r, rec in each_run(run, name):
        where = f"world {world} mesh {shape} seq_shard_kv {knob} rank {r}"
        assert rec["got"] == rec["want"] == rec["whole_tokens"], where
        assert all(len(t) == SEQ_TICKS + 1 for t in rec["got"])
        np.testing.assert_allclose(rec["logits"], rec["whole"], **ORDER_TOL, err_msg=where)


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_seq_cut_logits_hold_the_reference(run, name):
    """Every run's logits against the reference's unsharded forward on
    the same weights and prompts at REF_TOL, up to the first step where
    the reference's greedy token parts from the port's (none here; a
    near-tie's margin is printed)."""
    ref_toks, ref_logits = run["ref"][name]
    for world, shape, knob, r, rec in each_run(run, name):
        for i, row in enumerate(rec["rows"]):
            got, want = np.asarray(rec["got"][i]), ref_toks[row]
            upto = int(np.argmax(got != want)) + 1 if (got != want).any() else len(got)
            if upto < len(got):
                top = np.sort(ref_logits[upto - 1, row])[-2:]
                print(f"{name} world {world} {shape} row {row}: tokens part at step "
                      f"{upto - 1}, the reference's top two logits {top[1] - top[0]:.3g} apart")
                assert top[1] - top[0] <= 2 * (2e-4 + 2e-4 * abs(top[1]))
            np.testing.assert_allclose(rec["logits"][:upto, i], ref_logits[:upto, row],
                                       **REF_TOL, err_msg=f"world {world} {shape} rank {r}")


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_seq_cut_caches_hold_only_the_rank_block(run, name):
    """Each rank's cache bytes equal ``bytes_under_specs`` of the whole
    cache under ``cache_specs``; the sequence of every GQA and MLA cache
    is cut over 'data' where the data axis has more than one rank (7a),
    and with ``seq_shard_kv`` over 'model' where the KV heads do not
    divide it (no window) and on every MLA layer (7b); a cut layer's
    cache holds its block of ceil(C / n) slots."""
    cfg = seq_cfg(name)
    for world, shape, knob, r, rec in each_run(run, name):
        where = (world, shape, knob, r)
        assert rec["cache_bytes"] == rec["under_specs"] > 0, where
        for spec, c, cache in zip(M.layer_specs(cfg), rec["cuts"], rec["cache"]):
            if spec.kind == "mamba":
                assert c is None
                continue
            if shape[0] > 1 and not knob:
                want = ("data",)
            elif knob and (spec.kind == "mla" or (spec.window is None
                                                  and cfg.n_kv_heads % shape[1])):
                want = ("model",)
            else:
                want = None
            assert (c and c[0]) == want, (where, spec)
            if c is not None:
                axes, block, length = c
                n = shape[0] if axes == ("data",) else shape[1]
                assert block == SQ.block_len(length, n)
                slots = cache["k"][1] if "k" in cache else cache["c_kv"][1]
                assert slots == block, where
    cuts = {(world, shape, knob) for world, shape, knob, _, rec in each_run(run, name)
            if any(rec["cuts"])}
    assert {(2, (2, 1), False), (4, (4, 1), False), (4, (2, 2), False)} <= cuts
    if name in ("deepseek-v2-lite-16b", "granite-20b", "h6-kv3-v250"):
        assert {(2, (1, 2), True), (4, (1, 4), True), (4, (2, 2), True)} <= cuts
