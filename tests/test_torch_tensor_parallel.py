"""Tensor parallelism over ``model`` (``distributed.tensor_parallel``, the
sharded path of ``make_train_step``, ``make_prefill_step`` and
``make_serve_step``) on the CPU: over gloo process groups of
subprocesses at world sizes 2 and 4 (``torch_train_worker.py tp``), one
launch per world size, against the whole form (every rank the whole
state, the compute replicated over ``model``) over the same mesh, and
against the reference's train step from the same initial state; then
with ``seq_parallel`` (the stream between layers the rank's block of
the sequence) against the cut form without it.

Meshes (1, 2), (2, 2) and (1, 4).  Cases at ``shrink()`` sizes: stablelm
(dense), deepseek (MLA and the MoE, expert-parallel over ``model``),
jamba (Mamba, attention, the MoE), whisper (encoder-decoder), granite
(one KV head, whole at any tp), stablelm with 6 q heads, 3 KV heads
and a vocabulary of 250, none of which divides 4, internvl2 (the vision
prefix) with a vocabulary of 250, and jamba and deepseek with ``moe_ep``
off (each rank computes its E/tp experts' rows and the group sums them).
Three AdamW steps at lr 1e-3 each.  ``seq_parallel`` runs on every case
but granite and the two without ``moe_ep``, at 32 tokens and at 29,
which divides neither 2 nor 4.  Tolerances:

* The blocks' losses hold the whole form's at rtol = atol = 1e-5
  (``ORDER_TOL``), and so does the first step's gradient of every block,
  against the whole form's cut (the largest |difference| of a leaf
  within atol + rtol times its largest |value|): the cut compute adds
  the same terms in another order (partial products summed over the
  group), so the gradients agree to float32 rounding; shrink(jamba)'s
  Mamba channels part the most, by 1.1e-5 of a leaf's largest value.
* The state after the three steps (parameters and both moments),
  element by element, holds the whole form's within lr / 4 = 2.5e-4
  (``STATE_ATOL``): AdamW's first step moves an element by
  lr·g/(|g| + eps), eps = 1e-8, so where a gradient is near 0 a
  rounding-level difference δ of it moves the parameter by up to about
  lr·δ/(δ/2 + eps) more in one form (the largest here, shrink(jamba)'s
  embedding over (1, 2), 5.2e-5), where a wrong update moves an element
  by about lr = 1e-3.
* Against the reference's step: rtol = atol = 2e-4, the contract of
  ``tests/test_torch_train.py``; under ``seq_parallel`` the reference's
  with ``seq_parallel=True``.
* ``seq_parallel`` against the cut form without it: the same ORDER_TOL
  and STATE_ATOL (the reduce-scatters sum the same partial products as
  the all-reduces, in their own order); remat "dots" and "full" give
  the same gradients bit for bit; the prefill step's tokens are equal and
  its caches hold the other form's at ORDER_TOL.

Every rendezvous goes through a file under the test's temporary
directory; every subprocess has a timeout.
"""
from __future__ import annotations

import dataclasses
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.optim import OptConfig as RefOptConfig
from repro.optim import optimizers as RO
from repro_torch.configs import get_arch, shrink
from repro_torch.distributed import tensor_parallel as TP
from test_torch_model import configs, inputs
from torch_train_worker import (BATCH, REPAIR_SERVE, SEQ, SEQ_TICKS, SERVE_ARCHS, SERVE_SMAX,
                                SERVE_TICKS, SP_CASES, SP_PREFILL, SP_REMAT, SP_TICKS, STEPS,
                                TP_CASES, TP_MESHES, opt_cfg, tp_cfg)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_train_worker.py"
TIMEOUT_S = 240
REF_TOL = dict(rtol=2e-4, atol=2e-4)
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
#: The state after the steps, element by element (the module's docstring).
STATE_ATOL = 2.5e-4
#: What a part of a gradient misses of the whole: well above rounding.
UNSUMMED_REL = 1e-2


def ref_cfg(name, **extra):
    """The reference's shrink() config of a case, the MoE at capacity
    factor E/k as the port's (``moe_ep`` is the port's layout)."""
    arch, over = TP_CASES[name]
    rcfg, _ = configs(arch, **over, **extra)
    if rcfg.n_experts:
        rcfg = dataclasses.replace(rcfg, capacity_factor=rcfg.n_experts / rcfg.top_k)
    return rcfg


def case_data(name):
    """The reference's initial AdamW state (numpy) and three steps'
    batches of a case."""
    rcfg, cfg = ref_cfg(name), tp_cfg(name)
    toks, stub = inputs(cfg, STEPS * BATCH, SEQ + 1, seed=4)
    out = {"tokens": toks.reshape(STEPS, BATCH, SEQ + 1)}
    if "enc_frames" in stub:
        out["frames"] = stub["enc_frames"].reshape(STEPS, BATCH, *stub["enc_frames"].shape[1:])
    if "embeds" in stub:
        out["patch"] = stub["embeds"].reshape(STEPS, BATCH, *stub["embeds"].shape[1:])
    params = jax.jit(RM.init_params, static_argnums=(1,))(jax.random.PRNGKey(0), rcfg)
    opt = RO.init_opt_state(params, RefOptConfig(**dataclasses.asdict(opt_cfg("adamw"))))
    out["state"] = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    return out


def ref_losses(name, data, **extra):
    """The reference's three jitted AdamW steps from the case's state."""
    rcfg = ref_cfg(name, **extra)
    loss_grad = jax.jit(jax.value_and_grad(RM.lm_loss), static_argnums=(1,))
    update = jax.jit(RO.opt_update, static_argnums=(3,))
    apply = jax.jit(RO.apply_updates)
    ocfg = RefOptConfig(**dataclasses.asdict(opt_cfg("adamw")))
    st = jax.tree.map(jnp.asarray, data["state"])
    params, opt, losses = st["params"], st["opt"], []
    for s in range(STEPS):
        b = {"tokens": jnp.asarray(data["tokens"][s])}
        if "frames" in data:
            b["audio_frames"] = jnp.asarray(data["frames"][s])
        if "patch" in data:
            b["patch_embeds"] = jnp.asarray(data["patch"][s])
        loss, g = loss_grad(params, rcfg, b)
        upd, opt = update(g, params, opt, ocfg)
        params = apply(params, upd)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers at world sizes 2 and 4, run while this process
    computes the reference's losses."""
    base = tmp_path_factory.mktemp("tensor_parallel")
    data = {name: case_data(name) for name in TP_CASES}
    (base / "data.pkl").write_bytes(pickle.dumps(data))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs, logs = [], []
    for world in TP_MESHES:
        (base / f"w{world}").mkdir()
        for r in range(world):
            logs.append(open(base / f"w{world}" / f"log{r}.txt", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world), str(base / f"w{world}" / "init"),
                 str(base / f"w{world}"), "tp", str(base / "data.pkl")],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    try:
        ref = {name: ref_losses(name, data[name]) for name in TP_CASES}
        ref_sp = {name: ref_losses(name, data[name], seq_parallel=True) for name in SP_CASES}
        for p, log in zip(procs, logs):
            p.wait(timeout=TIMEOUT_S)
            log.close()
            assert p.returncode == 0, Path(log.name).read_text()[-4000:]
    finally:
        for p in procs:
            p.kill()
    ranks = {w: [pickle.loads((base / f"w{w}" / f"tp{r}.pkl").read_bytes()) for r in range(w)]
             for w in TP_MESHES}
    return {"ranks": ranks, "ref": ref, "ref_sp": ref_sp}


def within(grads, path):
    """Whether the blocks' gradient of ``path`` holds the whole form's:
    its largest |difference| within ORDER_TOL of its largest |value|."""
    diff, scale = grads["diff"][path]
    return diff <= ORDER_TOL["atol"] + ORDER_TOL["rtol"] * scale


def each_run(run, name, part="families"):
    """(world, mesh shape, rank, record) of every run of case ``name``
    (``part``: "sp" for its ``seq_parallel`` runs)."""
    for world, recs in run["ranks"].items():
        for shape in TP_MESHES[world]:
            for r, rec in enumerate(recs):
                yield world, shape, r, rec[part][(name, shape)]


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_steps_match_the_whole_form(run, name):
    """Three steps of the cut compute hold the whole form's losses and,
    element by element, its state after them; the first step's gradient
    of every block (the rank's heads, channels or rows computed from its
    block) holds the whole form's; every rank of a mesh reports the same
    losses."""
    for world, shape, r, rec in each_run(run, name):
        np.testing.assert_allclose(rec["blocks"], rec["whole"], **ORDER_TOL,
                                   err_msg=f"world {world} mesh {shape} rank {r}")
        path, (worst, _) = max(rec["state_spread"].items(), key=lambda kv: kv[1][0])
        assert worst <= STATE_ATOL, (world, shape, r, path, worst)
        bad = {p: rec["grads"]["diff"][p] for p in rec["grads"]["diff"]
               if not within(rec["grads"], p)}
        assert not bad, (world, shape, r, bad)
        assert rec["blocks"] == run["ranks"][world][0]["families"][(name, shape)]["blocks"]


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_steps_match_reference(run, name):
    """The cut compute's three steps against the reference's three
    steps on the whole batches, from the same initial state."""
    for world, shape, r, rec in each_run(run, name):
        np.testing.assert_allclose(rec["blocks"], run["ref"][name], **REF_TOL,
                                   err_msg=f"world {world} mesh {shape} rank {r}")


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_state_bytes_equal_bytes_under_specs(run, name):
    """Each rank stores exactly the bytes the reference's specs give it."""
    for world, shape, r, rec in each_run(run, name):
        assert rec["bytes"] == rec["under_specs"] > 0, (world, shape, r)


@pytest.mark.parametrize("name", list(TP_CASES))
def test_no_leaf_cut_over_model_is_gathered_over_model(run, name):
    """A step gathers a leaf that the specs cut over ``model`` over the
    data axes only (the rank computes with its block), Mamba's
    ``in_proj`` aside, whose x and z columns lie in two blocks; the data
    axes are gathered where the mesh has them."""
    for world, shape, r, rec in each_run(run, name):
        g = rec["grads"]
        cut = set(g["cut_over_model"])
        assert cut, (world, shape)
        over_model = {p for p, axes in g["gathered"].items() if "model" in axes}
        assert over_model == {p for p in cut if p.endswith("/in_proj")}, (world, shape, r)
        assert bool(over_model) == (TP_CASES[name][0] == "jamba-v0.1-52b")
        if shape[0] > 1:
            assert any("data" in axes for axes in g["gathered"].values())
    # under seq_parallel too, and the expert stacks stay the rank's E/tp
    # slices whether or not the MoE is expert-parallel
    for world, shape, r, rec in each_run(run, name, "sp") if name in SP_CASES else ():
        g = rec["grads"]
        over_model = {p for p, axes in g["gathered"].items() if "model" in axes}
        assert over_model == {p for p in g["cut_over_model"] if p.endswith("/in_proj")}
    if tp_cfg(name).n_experts:
        for world, shape, r, rec in each_run(run, name):
            stacks = [p for p in rec["grads"]["cut_over_model"]
                      if p.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down") and "/mlp/" in p
                      and "/shared/" not in p]
            assert stacks, (world, shape)


#: The leaves whose gradient each rank holds a part of, by case and tp:
#: MLA's w_dkv and w_kr; GQA's wk and wv where the KV heads do not
#: divide and the q heads do.
PARTIAL = {("deepseek-v2-lite-16b", 2): ("w_dkv", "w_kr"),
           ("deepseek-v2-lite-16b", 4): ("w_dkv", "w_kr"),
           ("deepseek-noep", 2): ("w_dkv", "w_kr"), ("deepseek-noep", 4): ("w_dkv", "w_kr"),
           ("granite-20b", 2): ("wk", "wv"), ("granite-20b", 4): ("wk", "wv"),
           ("h6-kv3-v250", 2): ("wk", "wv")}


@pytest.mark.parametrize("name", list(TP_CASES))
def test_partial_gradients_are_summed_and_stream_gradients_are_not(run, name):
    """Case by case: the leaves whole on every rank but read by its heads
    only are exactly those of PARTIAL, and their gradients, summed over
    ``model``, hold the whole form's, where each rank's part alone does
    not; a leaf of the replicated stream (norms, the router,
    ``pos_embed``, an uncut embedding) is not summed and holds the whole
    form's on every rank."""
    for world, shape, r, rec in each_run(run, name):
        g = rec["grads"]
        want = PARTIAL.get((name, shape[1]), ())
        assert sorted({p.rsplit("/", 1)[-1] for p in g["partial"]}) == sorted(want), (shape, r)
        assert all("/attn/" in p for p in g["partial"])
        for p in g["partial"]:
            assert within(g, p) and g["unsummed"][p] > UNSUMMED_REL, (shape, r, p)
        stream = [p for p in g["diff"] if p not in g["cut_over_model"] and p not in g["partial"]]
        assert any(p.rsplit("/", 1)[-1].startswith("norm") for p in stream)
        assert all(within(g, p) for p in stream), (shape, r)
        if name == "h6-kv3-v250" and shape[1] == 4:   # 250 rows over 4: the embedding whole
            assert "embed" in stream
    # seq_parallel: every leaf whole over model is read by the rank's
    # block of the sequence, its gradient a part, summed; the norms and
    # pos_embed among them, which the replicated stream does not sum
    for world, shape, r, rec in each_run(run, name, "sp") if name in SP_CASES else ():
        g = rec["grads"]
        want = {p for p in g["diff"] if p not in g["cut_over_model"]}
        assert set(g["partial"]) == want, (shape, r)
        summed = [p for p in want if p.rsplit("/", 1)[-1].startswith("norm")
                  or p.endswith("final_norm") or p.endswith("pos_embed")]
        assert summed and (name != "whisper-base" or "pos_embed" in summed)
        off = run["ranks"][world][r]["families"][(name, shape)]["grads"]["partial"]
        assert not set(summed) & set(off), (shape, r)
        for p in g["partial"]:
            assert within(g, p), (shape, r, p)
        for p in summed:
            assert g["unsummed"][p] > UNSUMMED_REL, (shape, r, p)


# -------------------------------------------------------------- operators
@pytest.mark.parametrize("shape", [s for m in TP_MESHES.values() for s in m])
def test_vocab_parallel_loss_argmax_and_lookup(run, shape):
    """Over each mesh's ``model`` group: the loss from the rank's columns
    and its gradient against ``torch.logsumexp`` less the target's logit;
    the argmax against ``torch.argmax`` on rows whose maximum ties
    across two ranks' blocks (the lowest index wins) and inside one
    (float32 and bfloat16); the lookup against the whole table's rows,
    negative ids among them, exactly."""
    world = next(w for w, m in TP_MESHES.items() if shape in m)
    for r, rec in enumerate(run["ranks"][world]):
        v = rec["vocab"][shape]
        assert v["loss"] <= 1e-6 and v["grad"] <= 1e-6, (r, v)
        assert v["argmax"] == v["argmax_bf16"][:3] + v["argmax"][3:] == v["want_argmax"]
        assert v["argmax"][:3] == v["tie_cols"]
        assert v["lookup_equal"]


class SimGroup:
    """A ``model`` group of ``n`` ranks simulated by ``n`` threads of one
    process: the all-gather and the reduce-scatter of
    ``tensor_parallel`` read every rank's operand once all have put it
    in (``install``), in rank order."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n, timeout=30)

    def _exchange(self, rank, t):
        self.slots[rank] = t.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def install(self, monkeypatch):
        def all_gather(out, inp, group):
            sim, rank = group
            out.copy_(torch.cat(sim._exchange(rank, inp)))

        def reduce_scatter(out, inp, group):
            sim, rank = group
            n = out.shape[0]
            out.copy_(sum(t[rank * n:(rank + 1) * n] for t in sim._exchange(rank, inp)))

        monkeypatch.setattr(TP, "_ALL_GATHER", all_gather)
        monkeypatch.setattr(TP, "_REDUCE_SCATTER", reduce_scatter)

    def run(self, fn):
        """``fn(rank, sp_group)`` on every rank at once; their results."""
        out, errors = [None] * self.n, []

        def one(r):
            try:
                out[r] = fn(r, TP.ModelGroup((self, r), self.n, r))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        if errors:
            raise errors[0]
        return out


@pytest.mark.parametrize("length", [7, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_operators_against_slicing_and_padding(monkeypatch, n, length):
    """Without a process group (``n`` ranks simulated by threads), at a
    length that divides ``n`` and one that does not: ``gather_seq`` gives
    the whole sequence with the padding stripped, its backward the sum
    of the ranks' gradients at the rank's block; ``reduce_scatter_seq``
    the rank's block of the sum (the padded positions zero), its backward
    the whole sequence of the blocks' gradients; ``own_seq_block`` the
    rank's block, its backward that gradient in place and zeros
    elsewhere; ``own_seq_grad`` the identity, its backward the rank's
    block of the gradient.  Exact: each sum adds the same terms."""
    sim = SimGroup(n)
    sim.install(monkeypatch)
    rng = np.random.default_rng(3)
    whole = torch.as_tensor(rng.standard_normal((2, length, 3)))
    per_rank = torch.as_tensor(rng.standard_normal((n, 2, length, 3)))
    block = -(-length // n)
    padded = torch.cat([whole, whole.new_zeros((2, n * block - length, 3))], 1)
    part = [padded[:, r * block:(r + 1) * block] for r in range(n)]
    pad_g = torch.cat([per_rank, per_rank.new_zeros((n, 2, n * block - length, 3))], 2)
    sum_g = pad_g.sum(0)

    def step(r, tp):
        sp = TP.SeqSplit(tp, length)
        assert sp.block == block
        x = part[r].clone().requires_grad_(True)
        g = TP.gather_seq(x, sp)
        (gx,) = torch.autograd.grad(g, x, per_rank[r])
        y = per_rank[r].clone().requires_grad_(True)
        rs = TP.reduce_scatter_seq(y, sp)
        (gy,) = torch.autograd.grad(rs, y, part[r])
        z = whole.clone().requires_grad_(True)
        own = TP.own_seq_block(z, sp)
        (gz,) = torch.autograd.grad(own, z, part[r])
        w = whole.clone().requires_grad_(True)
        kept = TP.own_seq_grad(w, sp)
        (gw,) = torch.autograd.grad(kept, w, per_rank[r])
        return g.detach(), gx, rs.detach(), gy, own.detach(), gz, kept.detach(), gw

    for r, (g, gx, rs, gy, own, gz, kept, gw) in enumerate(sim.run(step)):
        mine = slice(r * block, (r + 1) * block)
        assert torch.equal(g, whole)
        assert torch.equal(gx, sum_g[:, mine])
        assert torch.equal(rs, sum_g[:, mine])
        assert torch.equal(gy, whole)
        assert torch.equal(own, part[r])
        in_place = torch.zeros_like(padded)
        in_place[:, mine] = part[r]
        assert torch.equal(gz, in_place[:, :length])
        assert torch.equal(kept, whole)
        in_place = torch.zeros_like(pad_g[r])
        in_place[:, mine] = pad_g[r][:, mine]
        assert torch.equal(gw, in_place[:, :length])


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_tp_serving_equals_unsharded_serve(run, arch):
    """Over (1, 2), the prefill step and four decode ticks with the
    parameters as the rank's blocks (heads, channels and the vocabulary
    cut) give ``launch.serve.serve``'s tokens; the caches hold the rank's
    KV heads or Mamba channels, and the parameters exactly the bytes the
    specs give the rank."""
    cfg = shrink(get_arch(arch).model)
    for r, rec in enumerate(run["ranks"][2]):
        s = rec["serving"][arch]
        assert s["got"] == s["want"], (r, s)
        assert all(len(t) == SERVE_TICKS + 1 for t in s["got"])
        assert s["param_bytes"] == s["under_specs"] > 0
        first = s["cache"][0]
        if "k" in first:
            assert first["k"] == (2, SERVE_SMAX, cfg.n_kv_heads // 2, cfg.head_dim)
        else:
            assert first["h"] == (2, cfg.d_inner // 2, cfg.d_state)
            assert first["conv"] == (2, cfg.d_conv - 1, cfg.d_inner // 2)


# ----------------------------------------------------- sequence parallelism
@pytest.mark.parametrize("name", SP_CASES)
def test_sp_steps_match_the_cut_form(run, name):
    """With ``seq_parallel`` three steps hold the cut form's losses
    without it and, element by element, its state after them; the first
    step's gradient of every leaf holds its gradient; every rank of a
    mesh reports the same losses."""
    for world, shape, r, rec in each_run(run, name, "sp"):
        off = run["ranks"][world][r]["families"][(name, shape)]
        np.testing.assert_allclose(rec["losses"], off["blocks"], **ORDER_TOL,
                                   err_msg=f"world {world} mesh {shape} rank {r}")
        path, (worst, _) = max(rec["state_spread"].items(), key=lambda kv: kv[1][0])
        assert worst <= STATE_ATOL, (world, shape, r, path, worst)
        bad = {p: rec["grads"]["diff"][p] for p in rec["grads"]["diff"]
               if not within(rec["grads"], p)}
        assert not bad, (world, shape, r, bad)
        assert rec["losses"] == run["ranks"][world][0]["sp"][(name, shape)]["losses"]


@pytest.mark.parametrize("name", SP_CASES)
def test_sp_steps_match_reference(run, name):
    """``seq_parallel``'s three steps against the reference's, with
    ``seq_parallel=True``, from the same initial state."""
    for world, shape, r, rec in each_run(run, name, "sp"):
        np.testing.assert_allclose(rec["losses"], run["ref_sp"][name], **REF_TOL,
                                   err_msg=f"world {world} mesh {shape} rank {r}")


@pytest.mark.parametrize("name", SP_CASES)
def test_sp_length_that_does_not_divide_the_group(run, name):
    """At 29 tokens (blocks of 15 over 2 ranks, of 8 over 4, the last
    padded) the loss and every gradient hold the cut form's without
    ``seq_parallel``: no padded position reaches a layer or the loss."""
    for world, shape, r, rec in each_run(run, name, "sp"):
        odd = rec["odd"]
        np.testing.assert_allclose(*odd["loss"], **ORDER_TOL)
        bad = {p: d for p, d in odd["diff"].items() if not within(odd, p)}
        assert not bad, (world, shape, r, bad)


def test_sp_remat_gradients_equal_no_remat(run):
    """Under ``seq_parallel`` remat "dots" and "full" recompute the
    gathers inside their regions, on every rank in the same order: the
    gradients are the same bits as without remat."""
    seen = 0
    for world, shape, r, rec in each_run(run, SP_REMAT, "sp"):
        assert rec["remat_equal"] == {"dots": True, "full": True}, (world, shape, r)
        seen += 1
    assert seen == sum(w * len(m) for w, m in TP_MESHES.items())


@pytest.mark.parametrize("name", SP_PREFILL)
def test_sp_prefill_matches_the_cut_steps(run, name):
    """Over (1, 2) and (1, 4) the prefill step with ``seq_parallel`` (a
    prompt of 13, the blocks padded) and two decode ticks after it give
    the tokens of the steps without it, and its caches hold theirs."""
    for world, recs in run["ranks"].items():
        for r, rec in enumerate(recs):
            for shape in [s for s in TP_MESHES[world] if s[0] == 1]:
                p = rec["sp_prefill"][(name, shape)]
                assert p["sp"] == p["off"], (shape, r)
                assert all(len(t) == SP_TICKS + 1 for t in p["sp"])
                for layer in p["cache_diff"]:
                    for k, (diff, scale) in layer.items():
                        assert diff <= ORDER_TOL["atol"] + ORDER_TOL["rtol"] * scale, (shape, r, k)


@pytest.mark.parametrize("name", REPAIR_SERVE)
def test_moe_without_ep_serves_the_unsharded_tokens(run, name):
    """The MoE without expert parallelism at batch 1 over (1, 2) and
    (1, 4), each rank computing its experts' rows of the same dispatch:
    the sharded prefill and decode steps give the unsharded ``serve``'s
    tokens (the smallest gap between the two largest logits printed: a
    near-tie could pick otherwise)."""
    for world, recs in run["ranks"].items():
        for r, rec in enumerate(recs):
            for shape in [s for s in TP_MESHES[world] if s[0] == 1]:
                s = rec["repair_serving"][(name, shape)]
                print(f"{name} {shape} rank {r}: smallest top-2 logit gap {s['margin']:.3e}")
                assert s["got"] == s["want"], (shape, r, s)
                assert len(s["got"][0]) == SEQ_TICKS + 1
