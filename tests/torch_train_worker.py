"""One rank of the port's multi-rank training pieces on the CPU, for
``test_torch_distributed.py``.

    python tests/torch_train_worker.py RANK WORLD INIT_FILE OUT_DIR
    python tests/torch_train_worker.py RANK WORLD INIT_FILE OUT_DIR sharded DATA_PKL
    python tests/torch_train_worker.py RANK WORLD INIT_FILE OUT_DIR seq

Joins a gloo process group of WORLD ranks through ``file://INIT_FILE``
and runs, on every rank, with inputs from numpy and torch seeds that
every rank draws alike: ``compressed_psum`` and ``compress_grads_tree``
over each mesh of :data:`MESHES`, the GPipe pipeline over a ``pod`` axis, the expert-parallel
MoE (``moe_apply`` with distinct tokens per rank, ``_moe`` under a mesh
with the same tokens on every rank, ``lm_loss`` of shrink(deepseek) with
``moe_ep``) against its local form, values and gradients, and train
steps over a mesh against the unsharded steps.  Writes what it found to
``OUT_DIR/rank{RANK}.json``.

With ``sharded`` it runs the training state held as each rank's blocks
(``distributed.sharded``; ``test_torch_sharded_state.py``) on the inputs
of ``DATA_PKL`` (numpy only: the reference's initial states, batches,
whole leaves to cut and a checkpoint's path): :func:`sharded_cases`,
written to ``OUT_DIR/sharded{RANK}.pkl``.

With ``tp`` it runs tensor parallelism over ``model``
(``distributed.tensor_parallel``; ``test_torch_tensor_parallel.py``),
with and without ``seq_parallel``, on
the reference's initial states and batches of ``DATA_PKL``:
:func:`tp_cases`, written to ``OUT_DIR/tp{RANK}.pkl``.

With ``seq`` it serves with the caches cut on their sequence
(``distributed.sequence``; ``test_torch_sequence.py``) from seeded
weights and prompts (:func:`seq_inputs`): :func:`seq_cases`, written to
``OUT_DIR/seq{RANK}.pkl``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import json
import pickle
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch._tree import flatten, map_tree
from repro_torch.checkpoint import CheckpointManager, restore_state, save_state
from repro_torch.configs import get_arch, shrink
from repro_torch.distributed.compression import (compress_grads_tree, compressed_psum,
                                                 init_residuals, quantize_int8)
from repro_torch.distributed.pipeline import bubble_fraction, make_pipelined_fn
from repro_torch.distributed import sharded
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharded import (block_bytes, gather_state, shard_leaf,
                                             shard_state)
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, global_norm, init_opt_state, opt_update

# (shape, dim names, the dims a sum runs over), by world size
MESHES = {2: (((2,), ("data",), ("data",)),),
          4: (((2, 2), ("data", "model"), ("data",)),
              ((2, 2), ("data", "model"), ("data", "model")))}
# tests/test_moe_ep.py's experts, at its capacity factor E/k (no drops)
E, D, F, TOP_K, CF = 16, 8, 16, 2, 8.0


def rel(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def moe_params():
    p = L.init_moe(torch.Generator().manual_seed(0), D, F, E, 0, F, torch.float32)
    return {k: p[k].requires_grad_(True) for k in ("router", "w_gate", "w_up", "w_down")}


def local_moe(x):
    """The local form's loss sum(y²), its output and gradients."""
    p = moe_params()
    x = x.clone().requires_grad_(True)
    y = L.moe_apply(p, x, top_k=TOP_K, capacity_factor=CF)
    g = torch.autograd.grad((y ** 2).sum(), [x, *p.values()])
    return y.detach(), dict(zip(["x", *p], g))


def ep_moe_apply(rank, world):
    """moe_apply's expert-parallel form, each rank its own tokens and
    E/ep experts, against the local form over every rank's tokens."""
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((4, 16, D)), dtype=torch.float32)
    want_y, want_g = local_moe(x)
    group = make_mesh((world,), ("model",), device="cpu").get_group("model")
    n, b = E // world, x.shape[0] // world
    p = moe_params()
    mine = {"router": p["router"], **{k: p[k][rank * n:(rank + 1) * n]
                                      for k in ("w_gate", "w_up", "w_down")}}
    xr = x[rank * b:(rank + 1) * b].clone().requires_grad_(True)
    y = L.moe_apply(mine, xr, top_k=TOP_K, capacity_factor=CF, ep_group=group, ep_size=world)
    g = dict(zip(["x", *p], torch.autograd.grad((y ** 2).sum(), [xr, *p.values()])))
    dist.all_reduce(g["router"], group=group)   # the router's share of every rank's tokens
    rows = slice(rank * b, (rank + 1) * b)
    experts = slice(rank * n, (rank + 1) * n)
    return {"y": rel(y.detach(), want_y[rows]), "x": rel(g["x"], want_g["x"][rows]),
            "router": rel(g["router"], want_g["router"]),
            **{k: rel(g[k][experts], want_g[k][experts]) for k in ("w_gate", "w_up", "w_down")}}


def ep_mesh_moe(world):
    """``_moe`` under a ``model`` mesh, the same tokens on every rank
    (tests/test_moe_ep.py's shard_map), against the local form: the loss
    and the whole gradient of every input."""
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((4, 16, D)), dtype=torch.float32)
    want_y, want_g = local_moe(x)
    mesh = make_mesh((world,), ("model",), device="cpu")
    cfg = M.ModelConfig(name="ep", d_model=D, n_heads=1, n_kv_heads=1, head_dim=D, d_ff=F,
                        vocab_size=8, blocks=(), n_experts=E, top_k=TOP_K, d_ff_expert=F,
                        capacity_factor=CF, moe_ep=True)
    p = moe_params()
    xr = x.clone().requires_grad_(True)
    y = M._moe(p, xr, cfg, mesh)
    loss = (y ** 2).sum()
    g = dict(zip(["x", *p], torch.autograd.grad(loss, [xr, *p.values()])))
    return {"loss": abs(float(loss) - float((want_y ** 2).sum())) / float((want_y ** 2).sum()),
            **{k: rel(g[k], want_g[k]) for k in g}}


def deepseek(world):
    """lm_loss of shrink(deepseek-v2-lite-16b) with moe_ep under a
    ``model`` mesh against the local form: the loss and every gradient."""
    cfg = shrink(get_arch("deepseek-v2-lite-16b").model)
    params = M.init_params(cfg, torch.Generator().manual_seed(2))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 17)))
    mesh = make_mesh((world,), ("model",), device="cpu")
    out = {}
    for name, c, m in (("local", cfg, None), ("ep", dataclasses.replace(cfg, moe_ep=True), mesh)):
        flat = flatten(params)
        for t in flat.values():
            t.requires_grad_(True)
        loss = M.lm_loss(params, c, {"tokens": toks}, m)
        out[name] = (float(loss), dict(zip(flat, torch.autograd.grad(loss, list(flat.values())))))
    (l0, g0), (l1, g1) = out["local"], out["ep"]
    return {"loss": abs(l1 - l0) / abs(l0), "grad": max(rel(g1[k], g0[k]) for k in g0)}


def remat_ep(world):
    """lm_loss of shrink(deepseek) and shrink(jamba) (one 8-layer
    checkpoint region holding Mamba, attention and the MoE) with moe_ep
    under a ``model`` mesh, remat "full" and "dots" against none: the
    all_to_all runs again in the backward on every rank.  Returns the
    largest |difference| of the loss and of any gradient (0: bit-equal)."""
    mesh = make_mesh((world,), ("model",), device="cpu")
    out = {}
    for arch in ("deepseek-v2-lite-16b", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(shrink(get_arch(arch).model), moe_ep=True)
        params = M.init_params(cfg, torch.Generator().manual_seed(2))
        toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 17)))
        got = {}
        for remat in ("none", "full", "dots"):
            flat = flatten(params)
            for t in flat.values():
                t.requires_grad_(True)
            loss = M.lm_loss(params, dataclasses.replace(cfg, remat=remat), {"tokens": toks}, mesh)
            got[remat] = [loss.detach(), *torch.autograd.grad(loss, list(flat.values()))]
        out[arch] = {r: max(float((a - b).abs().max()) for a, b in zip(got[r], got["none"]))
                     for r in ("full", "dots")}
    return out


def train_steps(world, rank, mesh_shape, arch):
    """Three make_train_step steps over a mesh, each rank its share of
    the batch along ``data``, against the same steps unsharded.  A data
    shard's MoE dispatch shares each expert's capacity among its own
    tokens only (the reference's ``P(dp)``), so the MoE case runs without
    drops."""
    if arch == "smoke":
        cfg = TT.preset_config("smoke")[0]
    else:   # at capacity factor E/k no pick drops, so the data split moves no token
        cfg = shrink(get_arch(arch).model)
        cfg = dataclasses.replace(cfg, moe_ep=True, capacity_factor=cfg.n_experts / cfg.top_k)
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 4, 33))
    d, n = mesh.get_local_rank("data"), mesh_shape[0]
    losses = {}
    for name, m, rows in (("unsharded", None, slice(None)), ("mesh", mesh, slice(d * 4 // n, (d + 1) * 4 // n))):
        state = TT.build_state(cfg, ocfg, seed=6, device="cpu")
        step = TST.make_train_step(cfg, ocfg, m, 4)
        losses[name] = [float(step(state, {"tokens": torch.as_tensor(t[rows])})[1]) for t in toks]
    return losses


def pipeline(world):
    """The 2-stage GPipe over ``pod`` against the layers applied in order
    (tests/test_distributed.py's case)."""
    shape, names = ((2,), ("pod",)) if world == 2 else ((2, 2), ("pod", "data"))
    mesh = make_mesh(shape, names, device="cpu")
    n_layers, d, m, mb = 4, 8, 4, 2
    rng = np.random.default_rng(0)
    ws = torch.as_tensor(rng.normal(size=(n_layers, d, d)).astype(np.float32) * 0.3)
    x = torch.as_tensor(rng.normal(size=(m, mb, d)).astype(np.float32))

    def layer_fn(stage_ws, h):
        for i in range(stage_ws.shape[0]):
            h = torch.tanh(h @ stage_ws[i])
        return h

    y = make_pipelined_fn(layer_fn, mesh, axis="pod")(ws, x)
    seq = x
    for i in range(n_layers):
        seq = torch.tanh(seq @ ws[i])
    return {"err": float((y - seq).abs().max()), "bubble": bubble_fraction(2, m)}


def compression(rank, world):
    out = []
    for shape, names, axes in MESHES[world]:
        mesh = make_mesh(shape, names, device="cpu")
        x = torch.as_tensor(np.random.default_rng(10 + rank).normal(size=(32,)) * 3,
                            dtype=torch.float32)
        approx, resid = compressed_psum(x, mesh, axes)
        q, s = quantize_int8(x)
        out.append({"axes": list(axes), "x": x.tolist(), "q": q.tolist(), "scale": float(s),
                    "approx": approx.tolist(), "resid": resid.tolist(),
                    "tree": compressed_tree(rank, mesh, axes)})
    return out


def compressed_tree(rank, mesh, axes):
    """compress_grads_tree over two calls, its residuals carried from the
    first into the second: a float32 leaf and a bfloat16 one.  Returns
    each call's gradients, sums and new residuals by leaf path."""
    rng = np.random.default_rng(30 + rank)
    calls = [{"a": torch.as_tensor(rng.normal(size=(6,)) * 2, dtype=torch.float32),
              "b": {"c": torch.as_tensor(rng.normal(size=(2, 3)), dtype=torch.bfloat16)}}
             for _ in range(2)]
    resid = init_residuals(calls[0])
    out = []
    for g in calls:
        sums, resid = compress_grads_tree(g, resid, mesh, axes)
        out.append({k: {path: (t.float().flatten().tolist(), str(t.dtype))
                        for path, t in flatten(tree).items()}
                    for k, tree in (("g", g), ("sum", sums), ("resid", resid))})
    return out


# ---------------------------------------------------------- sharded state
#: The families of the sharded-state cases: dense GQA, MLA + MoE, Mamba +
#: attention + MoE, and the encoder-decoder.
FAMILIES = ("stablelm-1.6b", "deepseek-v2-lite-16b", "jamba-v0.1-52b", "whisper-base")
KINDS = ("adamw", "adafactor")
#: The (data, model) meshes of the train cases, by world size.
SHARDED_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
#: The meshes of the block-order check, by world size: {name: (shape, axes)}.
BLOCK_MESHES = {2: {"2x1": ((2, 1), ("data", "model")), "1x2": ((1, 2), ("data", "model"))},
                4: {"2x2": ((2, 2), ("data", "model")),
                    "pod2x2x1": ((2, 2, 1), ("pod", "data", "model"))}}
#: Three steps of four sequences of 32 tokens (and one more).
STEPS, BATCH, SEQ = 3, 4, 32
#: The checkpoint cases: stablelm, AdamW without the clip (each step then
#: bit for bit the whole form's), over (2, 1) at world 2 and (2, 2) at 4.
CKPT_ARCH, CKPT_MESH = "stablelm-1.6b", {2: (2, 1), 4: (2, 2)}
#: The family also run with remat "full" and "dots" (MLA and the EP MoE).
REMAT_ARCH = "deepseek-v2-lite-16b"


def family_cfg(arch, **over):
    """shrink() of ``arch`` (``over`` applied); an MoE with ``moe_ep`` at
    capacity factor E/k, where no pick drops, so the data split moves no
    token."""
    cfg = shrink(get_arch(arch).model, **over)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_ep=True, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def opt_cfg(kind, clip=1.0):
    """The sharded cases' optimizer: full lr from the first step, 1e-3.
    Adam's first steps move each parameter by about lr whatever its
    gradient's size, so a gradient near 0 that two frameworks round to
    other last bits moves a parameter by up to 2·lr: at lr 1e-2 one
    element of jamba's first expert stack (gradient 1.5e-8 of a largest
    0.018) takes such a flip, and the third loss of the port, whole or
    sharded, leaves the reference's by 4.7e-4 relative."""
    return OptConfig(kind=kind, lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=clip)


def same(a, b) -> bool:
    """Two trees of tensors equal bit for bit, leaf by leaf."""
    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k].detach(), fb[k].detach())
                                          for k in fa)


def spread(a, b):
    """{path: (the largest |a - b| of the leaf's elements, the largest
    |b|)} of two trees of tensors."""
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    return {k: (float((fa[k].detach().double() - fb[k].detach().double()).abs().max()),
                float(fb[k].detach().double().abs().max())) for k in fb if fb[k].numel()}


def run_steps(cfg, ocfg, mesh, state, data, specs=None, steps=range(STEPS)):
    """make_train_step's losses over ``steps`` of ``data``'s batches, this
    rank's share of each along ``data``."""
    d = mesh.get_local_rank("data")
    n = mesh.shape[mesh.mesh_dim_names.index("data")]
    rows = slice(d * BATCH // n, (d + 1) * BATCH // n)
    step = TST.make_train_step(cfg, ocfg, mesh, BATCH, specs=specs)
    out = []
    for s in steps:
        b = {"tokens": torch.as_tensor(data["tokens"][s][rows])}
        if cfg.kind == "encdec":
            b["audio_frames"] = torch.as_tensor(data["frames"][s][rows])
        if "patch" in data:
            b["patch_embeds"] = torch.as_tensor(data["patch"][s][rows])
        out.append(float(step(state, b)[1]))
    return out


def reductions(cfg, mesh):
    """``global_norm`` and one Adafactor update of seeded gradients, on
    blocks against the whole leaves: the largest relative differences of
    the norm, the gathered ``vr``/``vc``/``v`` and the gathered updates."""
    params = M.init_params(cfg, torch.Generator().manual_seed(6))
    pspecs = TST.param_specs(params, cfg, mesh)
    rng = np.random.default_rng(11)
    grads = map_tree(lambda _, p: torch.as_tensor(rng.standard_normal(tuple(p.shape)),
                                                  dtype=torch.float32), params)
    gb, pb = shard_state(grads, pspecs, mesh), shard_state(params, pspecs, mesh)
    o = OptConfig(kind="adafactor", grad_clip=0.0)
    sw = init_opt_state(params, o, cfg)
    sb = init_opt_state(pb, o, cfg, pspecs, mesh)
    uw, _ = opt_update(grads, params, sw, o, cfg)
    ub, _ = opt_update(gb, pb, sb, o, cfg, pspecs, mesh)
    vspecs = TST.state_specs({"params": params, "opt": sw}, pspecs, cfg)["opt"]["v"]
    stats, want = flatten(gather_state(sb["v"], vspecs, mesh)), flatten(sw["v"])
    ups, want_u = flatten(gather_state(ub, pspecs, mesh)), flatten(uw)
    return {"norm": rel(global_norm(gb, pspecs, mesh), global_norm(grads)),
            "stats": max(rel(stats[k], want[k]) for k in want),
            "updates": max(rel(ups[k], want_u[k]) for k in want_u)}


def sharded_family(arch, mesh, data):
    """One family over one mesh.  AdamW without the clip from
    ``build_state``'s seed: the blocks against the whole state cut, three
    steps' losses and the gathered state against the whole form's over
    the same mesh, and for :data:`REMAT_ARCH` the same steps with remat
    "full" and "dots".  AdamW and Adafactor with the clip from the
    reference's initial state (``interop``'s mesh form): the state's
    bytes against ``bytes_under_specs``, three steps' losses of the
    blocks and of the whole form."""
    cfg = family_cfg(arch)
    ocfg = opt_cfg("adamw", clip=0.0)
    specs = TST.train_specs(cfg, ocfg, mesh)
    blocks = TT.build_state(cfg, ocfg, seed=6, device="cpu", mesh=mesh, specs=specs)
    whole = TT.build_state(cfg, ocfg, seed=6, device="cpu")
    out = {"init_equal": same(blocks, shard_state(whole, specs, mesh)),
           "exact": {"blocks": run_steps(cfg, ocfg, mesh, blocks, data, specs),
                     "whole": run_steps(cfg, ocfg, mesh, whole, data)}}
    gathered = gather_state(blocks, specs, mesh)
    out["exact"]["state_equal"] = same(gathered, whole)
    out["exact"]["state_spread"] = spread(gathered, whole)
    if arch == REMAT_ARCH:  # remat regions that hold the gathers and the EP exchange
        for remat in ("full", "dots"):
            rcfg = dataclasses.replace(cfg, remat=remat)
            st = TT.build_state(rcfg, ocfg, seed=6, device="cpu", mesh=mesh, specs=specs)
            out["exact"][remat] = run_steps(rcfg, ocfg, mesh, st, data, specs)
    for kind in KINDS:
        ocfg = opt_cfg(kind)
        specs = TST.train_specs(cfg, ocfg, mesh)
        st = interop.train_state_from_jax(data["state"][kind], cfg, device="cpu", mesh=mesh)
        out[kind] = {
            "bytes": block_bytes(st),
            "under_specs": TST.bytes_under_specs(TST.state_shapes(cfg, ocfg), specs, mesh),
            "blocks": run_steps(cfg, ocfg, mesh, st, data, specs),
            "whole": run_steps(cfg, ocfg, mesh,
                               interop.train_state_from_jax(data["state"][kind], cfg,
                                                            device="cpu"), data)}
    out["reductions"] = reductions(cfg, mesh)
    return out


def block_order(world, data):
    """Every rank's block of each whole leaf of ``data["blocks"]`` over
    each mesh of :data:`BLOCK_MESHES`."""
    out = {}
    for key, (shape, names) in BLOCK_MESHES[world].items():
        mesh = make_mesh(shape, names, device="cpu")
        out[key] = {path: shard_leaf(torch.as_tensor(a), spec, mesh).numpy()
                    for path, (a, spec) in data["blocks"][key].items()}
    return out


def checkpoints(world, data, out_dir):
    """The world-1 checkpoint at ``data["ckpt"]`` (step 1) restored as
    blocks, against the whole leaves cut; saved again at this world size
    (step 1); two steps, then an async save of the blocks (step 3), a
    save of the blocks gathered (``gathered/``) and one of the whole form
    after the same two steps (``whole/``)."""
    cfg, ocfg = family_cfg(CKPT_ARCH), opt_cfg("adamw", clip=0.0)
    mesh = make_mesh(CKPT_MESH[world], ("data", "model"), device="cpu")
    specs = TST.train_specs(cfg, ocfg, mesh)
    like = TT.build_state(cfg, ocfg, seed=7, device="cpu", mesh=mesh, specs=specs)
    st, extras = CheckpointManager(data["ckpt"], specs=specs, mesh=mesh).restore(like)
    whole, _ = restore_state(data["ckpt"], 1, TT.build_state(cfg, ocfg, seed=7, device="cpu"))
    cut_equal = same(st, shard_state(whole, specs, mesh))
    mine = CheckpointManager(Path(out_dir) / f"ckpt{world}", specs=specs, mesh=mesh)
    mine.save(1, st, extras)
    for s in (st, whole):
        map_tree(lambda _, p: p.requires_grad_(True), s["params"])
    steps = range(1, 3)
    losses = {"blocks": run_steps(cfg, ocfg, mesh, st, data["families"][CKPT_ARCH], specs, steps),
              "whole": run_steps(cfg, ocfg, mesh, whole, data["families"][CKPT_ARCH], None, steps)}
    mine.save_async(3, st, {"data_step": 3})
    mine.wait()
    gathered = gather_state(st, specs, mesh)
    if dist.get_rank() == 0:
        save_state(Path(out_dir) / f"ckpt{world}" / "whole", 3, whole, {"data_step": 3})
        save_state(Path(out_dir) / f"ckpt{world}" / "gathered", 3, gathered, {"data_step": 3})
    return {"cut_equal": cut_equal, "losses": losses}


def resume(world, out_dir):
    """launch.train.main under the group (the sharded path) for 5 steps
    with a checkpoint at step 3, then resumed from it: both runs' losses."""
    argv = ["--device", "cpu", "--preset", "smoke", "--steps", "5", "--log-every", "100",
            "--ckpt-dir", str(Path(out_dir) / f"resume{world}")]
    if world == 4:
        argv += ["--model-parallel", "2"]
    first = TT.main(argv + ["--ckpt-every", "3"])
    return {"first": first, "resumed": TT.main(argv + ["--resume", "--ckpt-every", "100"])}


def sharded_cases(rank, world, data, out_dir):
    out = {"families": {}}
    for shape in SHARDED_MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for arch in FAMILIES:
            out["families"][(arch, shape)] = sharded_family(arch, mesh, data["families"][arch])
    out["blocks"] = block_order(world, data)
    out["ckpt"] = checkpoints(world, data, out_dir)
    out["resume"] = resume(world, out_dir)
    return out


# ---------------------------------------------------------- tensor parallelism
#: The (data, model) meshes of the tensor-parallel cases, by world size.
TP_MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
#: name -> (architecture, overrides of its shrink()): the sharded-state
#: families, granite's single KV head (whole at any tp), q heads, KV
#: heads and a vocabulary that do not divide 4 (6 q heads read 3 KV
#: heads: at tp 2 a rank's three q heads read two KV heads), the vision
#: stub's prefix before the tokens (a vocabulary of 250: cut at tp 2,
#: whole at tp 4), and the two MoE families without expert parallelism
#: (the expert stacks' E/tp slices, each rank's experts' rows summed over
#: ``model``).
TP_CASES = {**{a: (a, {}) for a in FAMILIES}, "granite-20b": ("granite-20b", {}),
            "h6-kv3-v250": ("stablelm-1.6b", dict(n_heads=6, n_kv_heads=3, vocab_size=250)),
            "internvl2-v250": ("internvl2-2b", dict(vocab_size=250)),
            "jamba-noep": ("jamba-v0.1-52b", dict(moe_ep=False)),
            "deepseek-noep": ("deepseek-v2-lite-16b", dict(moe_ep=False))}
#: The serving cases over (1, 2): two prompts, a prefill and four ticks.
SERVE_ARCHS, SERVE_PROMPT, SERVE_TICKS, SERVE_SMAX = ("stablelm-1.6b", "falcon-mamba-7b"), 12, 4, 32
#: The cases also run with ``seq_parallel`` (the stream between layers
#: the rank's block of the sequence): every block cut, replicated
#: attention and an uncut vocabulary at tp 4, MLA and the expert-parallel
#: MoE, Mamba, attention and that MoE in one 8-layer region, the
#: encoder-decoder, and the vision prefix.
SP_CASES = ("stablelm-1.6b", "h6-kv3-v250", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
            "whisper-base", "internvl2-v250")
#: A length that divides neither 2 nor 4 (blocks of 15 and of 8, the
#: last padded), and the case run with remat "dots" and "full" under
#: ``seq_parallel``.
SP_ODD_SEQ, SP_REMAT = 29, "stablelm-1.6b"
#: The prefill step under ``seq_parallel`` over the meshes without a data
#: axis: two prompts of SP_PROMPT (odd, so the blocks are padded), the
#: prefill and SP_TICKS decode ticks, caches of SERVE_SMAX.
SP_PREFILL, SP_PROMPT, SP_TICKS = ("stablelm-1.6b", "jamba-v0.1-52b"), 13, 2
#: The MoE without expert parallelism served at batch 1 over the meshes
#: without a data axis, against the unsharded ``serve``: a prompt of
#: SEQ_PROMPT and SEQ_TICKS ticks in caches of SEQ_SMAX.
REPAIR_SERVE = ("jamba-noep", "deepseek-noep")


def tp_cfg(name, **extra):
    """A case's config; its ``moe_ep`` override, if any, after
    ``family_cfg`` (which turns it on for an MoE)."""
    arch, over = TP_CASES[name]
    over = dict(over, **extra)
    ep = over.pop("moe_ep", None)
    cfg = family_cfg(arch, **over)
    return cfg if ep is None else dataclasses.replace(cfg, moe_ep=ep)


@contextlib.contextmanager
def gathered_axes(params):
    """{path: the mesh axes the leaf was gathered over} of the parameter
    blocks ``params`` while inside: ``sharded.gather_leaf`` (the
    forward's gathers and the backward's regathers) and its
    ``_gather_dim`` wrapped."""
    paths = {id(t): p for p, t in flatten(params).items()}
    axes, current = defaultdict(set), [None]
    leaf, dim = sharded.gather_leaf, sharded._gather_dim

    def gather_leaf(block, *a, **k):
        current[0] = paths.get(id(block))
        return leaf(block, *a, **k)

    def gather_dim(t, d, axis, mesh):
        axes[current[0]].add(axis)
        return dim(t, d, axis, mesh)

    sharded.gather_leaf, sharded._gather_dim = gather_leaf, gather_dim
    try:
        yield axes
    finally:
        sharded.gather_leaf, sharded._gather_dim = leaf, dim


def tp_gradients(cfg, mesh, specs, blocks, want, batch):
    """One step's gradients of the blocks (the compute cut over
    ``model``) against ``want`` (a cut form's), each as (max |difference|,
    max |want|); the leaves whose parts are summed over ``model`` and
    their gradients without that sum (max |difference| / max |want|);
    the axes every leaf was gathered over.  Returns the record and the
    gradients."""
    pspecs = specs["params"]
    with gathered_axes(blocks["params"]) as axes:
        _, gb = TST.make_loss_and_grads(cfg, mesh, pspecs)(blocks["params"], batch)
    real = TST.partial_grad_paths
    TST.partial_grad_paths = lambda *a: []
    try:
        _, gu = TST.make_loss_and_grads(cfg, mesh, pspecs)(blocks["params"], batch)
    finally:
        TST.partial_grad_paths = real
    fs = sharded.spec_paths(pspecs)
    partial = real(pspecs, mesh, cfg.seq_parallel)
    return {"diff": {p: (float((gb[p] - want[p]).abs().max()), float(want[p].abs().max()))
                     for p in gb},
            "partial": partial,
            "unsummed": {p: rel(gu[p], want[p]) for p in partial},
            "cut_over_model": [p for p in fs if any("model" in a for a in
                                                   sharded.cut_axes(fs[p], mesh))],
            "gathered": {p: sorted(a) for p, a in axes.items()}}, gb


def first_batch(cfg, mesh, data, seq=SEQ):
    """The rank's rows of the case's first batch, ``seq`` tokens and one more."""
    d = mesh.get_local_rank("data")
    n = mesh.shape[mesh.mesh_dim_names.index("data")]
    rows = slice(d * BATCH // n, (d + 1) * BATCH // n)
    first = {"tokens": torch.as_tensor(data["tokens"][0][rows, :seq + 1])}
    if cfg.kind == "encdec":
        first["audio_frames"] = torch.as_tensor(data["frames"][0][rows])
    if "patch" in data:
        first["patch_embeds"] = torch.as_tensor(data["patch"][0][rows])
    return first


def tp_family(name, mesh, data):
    """One case over one mesh, AdamW at lr 1e-3 from the reference's
    initial state: the state's bytes against ``bytes_under_specs``, the
    first step's gradients against the whole form's (:func:`tp_gradients`),
    three steps' losses of the blocks and of the whole form, and the
    state after them, the blocks gathered against the whole form's
    (:func:`spread`).  Returns the record, and the first gradients and
    the state after the steps (gathered) for :func:`sp_family`."""
    cfg, ocfg = tp_cfg(name), opt_cfg("adamw")
    specs = TST.train_specs(cfg, ocfg, mesh)
    blocks = interop.train_state_from_jax(data["state"], cfg, device="cpu", mesh=mesh)
    whole = interop.train_state_from_jax(data["state"], cfg, device="cpu")
    first = first_batch(cfg, mesh, data)
    _, gw = TST.make_loss_and_grads(cfg, mesh)(whole["params"], first)
    grads, gb = tp_gradients(cfg, mesh, specs, blocks, shard_state(gw, specs["params"], mesh),
                             first)
    out = {"bytes": block_bytes(blocks),
           "under_specs": TST.bytes_under_specs(TST.state_shapes(cfg, ocfg), specs, mesh),
           "grads": grads,
           "blocks": run_steps(cfg, ocfg, mesh, blocks, data, specs),
           "whole": run_steps(cfg, ocfg, mesh, whole, data)}
    gathered = gather_state(blocks, specs, mesh)
    out["state_spread"] = spread(gathered, whole)
    return out, {"grads": gb, "state": gathered}


def sp_family(name, mesh, data, off):
    """One case with ``seq_parallel`` over one mesh, from the same state
    as :func:`tp_family` (``off``: its first gradients and its state after
    the steps, the cut form without ``seq_parallel``): the first
    gradients against ``off``'s; at SP_ODD_SEQ tokens the loss and the
    gradients of both forms; for SP_REMAT the gradients under remat
    "dots" and "full", bit for bit against none; three steps' losses and
    the state after them against ``off``'s."""
    cfg, ocfg = tp_cfg(name, seq_parallel=True), opt_cfg("adamw")
    specs = TST.train_specs(cfg, ocfg, mesh)
    blocks = interop.train_state_from_jax(data["state"], cfg, device="cpu", mesh=mesh)
    grads, gs = tp_gradients(cfg, mesh, specs, blocks, off["grads"],
                             first_batch(cfg, mesh, data))
    out = {"grads": grads}
    odd = first_batch(cfg, mesh, data, SP_ODD_SEQ)
    pspecs = specs["params"]
    lo, go = TST.make_loss_and_grads(tp_cfg(name), mesh, pspecs)(blocks["params"], odd)
    ls, gso = TST.make_loss_and_grads(cfg, mesh, pspecs)(blocks["params"], odd)
    out["odd"] = {"loss": (float(ls), float(lo)),
                  "diff": {p: (float((gso[p] - go[p]).abs().max()), float(go[p].abs().max()))
                           for p in go}}
    if name == SP_REMAT:
        out["remat_equal"] = {
            remat: same(TST.make_loss_and_grads(dataclasses.replace(cfg, remat=remat), mesh,
                                                pspecs)(blocks["params"],
                                                        first_batch(cfg, mesh, data))[1], gs)
            for remat in ("dots", "full")}
    out["losses"] = run_steps(cfg, ocfg, mesh, blocks, data, specs)
    out["state_spread"] = spread(gather_state(blocks, specs, mesh), off["state"])
    return out


def sp_prefill(name, mesh):
    """Two prompts of SP_PROMPT through the sharded prefill step and
    SP_TICKS decode ticks with ``seq_parallel`` and without, from the
    same seeded parameters: both forms' tokens and the largest |difference|
    of each cache leaf after the prefill (and the largest |value|)."""
    out = {}
    for sp in (False, True):
        cfg = tp_cfg(name, seq_parallel=sp)
        params = M.init_params(cfg, torch.Generator().manual_seed(3))
        pspecs = TST.param_specs(params, cfg, mesh)
        blocks = shard_state(params, pspecs, mesh)
        caches = TST.cache_blocks(cfg, mesh, 2, SERVE_SMAX, dtype=torch.float32, device="cpu")
        toks = torch.as_tensor(np.random.default_rng(8).integers(
            1, cfg.vocab_size, (2, SP_PROMPT + 1)), dtype=torch.long)
        kw = dict(batch=2, s_max=SERVE_SMAX)
        nxt, caches = TST.make_prefill_step(cfg, mesh, pspecs, **kw)(blocks, {"tokens": toks},
                                                                      caches)
        after = [{k: t.clone() for k, t in c.items()} for c in caches]
        got, pos = [nxt], torch.full((2,), SP_PROMPT, dtype=torch.int32)
        tick = TST.make_serve_step(cfg, mesh, pspecs, **kw)
        for _ in range(SP_TICKS):
            nxt, caches = tick(blocks, caches, nxt, pos)
            got.append(nxt)
            pos = pos + 1
        out[sp] = {"tokens": torch.cat(got, 1).tolist(), "caches": after}
    return {"off": out[False]["tokens"], "sp": out[True]["tokens"],
            "cache_diff": [{k: (float((a[k] - b[k]).abs().max()), float(b[k].abs().max()))
                            for k in b} for a, b in zip(out[True]["caches"],
                                                        out[False]["caches"])]}


def vocab_ops(mesh):
    """The vocab-parallel loss (and its gradient), argmax and lookup over
    the mesh's ``model`` group against ``torch.logsumexp``,
    ``torch.argmax`` and the whole table's rows, on logits whose rows 0
    and 1 tie across two ranks' blocks and row 2 within one rank's."""
    tp = TP.model_group(mesh, specs={})
    n, rank = 12, tp.rank
    V = n * tp.size
    rng = np.random.default_rng(20)
    logits = torch.as_tensor(rng.standard_normal((6, V)), dtype=torch.float32)
    logits[0, [1, n + 1]] = 9.0              # ranks 0 and 1: the lower index wins
    logits[1, [n + 2, V - 1]] = 9.0          # rank 1 and the last rank
    logits[2, [n + 3, n + 5]] = 9.0          # inside rank 1's block
    targets = torch.as_tensor(rng.integers(0, V, 6))
    whole = logits.clone().requires_grad_(True)
    want = torch.logsumexp(whole, -1) - whole.gather(-1, targets[:, None])[:, 0]
    (gw,) = torch.autograd.grad((want * torch.arange(1.0, 7.0)).sum(), whole)
    cols = slice(rank * n, (rank + 1) * n)
    block = logits[:, cols].clone().requires_grad_(True)
    got = TP.vocab_parallel_cross_entropy(block, targets, tp)
    (gb,) = torch.autograd.grad((got * torch.arange(1.0, 7.0)).sum(), block)
    table = torch.as_tensor(rng.standard_normal((V, 8)), dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(-V, V, (3, 5)))
    rows = TP.vocab_lookup(table[cols], ids, tp)
    return {"loss": rel(got.detach(), want.detach()), "grad": rel(gb, gw[:, cols]),
            "argmax": TP.vocab_parallel_argmax(logits[:, cols], tp).tolist(),
            "argmax_bf16": TP.vocab_parallel_argmax(logits[:, cols].bfloat16(), tp).tolist(),
            "want_argmax": torch.argmax(logits, -1).tolist(), "tie_cols": [1, n + 2, n + 3],
            "lookup_equal": bool(torch.equal(rows, M._rows(table, ids)))}


def tp_serving():
    """Two prompts through the prefill step and SERVE_TICKS decode ticks
    over a (1, 2) mesh (the parameters as the rank's blocks, the caches
    as :func:`launch.steps.cache_blocks` gives them) against
    ``launch.serve.serve`` unsharded, for each of SERVE_ARCHS."""
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in SERVE_ARCHS:
        cfg = shrink(get_arch(arch).model)
        model = M.Model(cfg, device="cpu", seed=3)
        rng = np.random.default_rng(7)
        queue = [rng.integers(1, cfg.vocab_size, SERVE_PROMPT).astype(np.int32) for _ in range(2)]
        want, _ = serve(cfg, model, queue, batch=2, max_new=SERVE_TICKS + 1, s_max=SERVE_SMAX,
                        device="cpu")
        params = model.params()
        pspecs = TST.param_specs(params, cfg, mesh)
        blocks = shard_state(params, pspecs, mesh)
        caches = TST.cache_blocks(cfg, mesh, 2, SERVE_SMAX, dtype=torch.float32, device="cpu")
        toks = torch.as_tensor(np.stack(queue), dtype=torch.long)
        batch = {"tokens": torch.cat([toks, torch.zeros((2, 1), dtype=torch.long)], 1)}
        kw = dict(batch=2, s_max=SERVE_SMAX)
        nxt, caches = TST.make_prefill_step(cfg, mesh, pspecs, **kw)(blocks, batch, caches)
        got, pos = [nxt], torch.full((2,), SERVE_PROMPT, dtype=torch.int32)
        tick = TST.make_serve_step(cfg, mesh, pspecs, **kw)
        for _ in range(SERVE_TICKS):
            nxt, caches = tick(blocks, caches, nxt, pos)
            got.append(nxt)
            pos = pos + 1
        out[arch] = {"want": want, "got": torch.cat(got, 1).tolist(),
                     "cache": [{k: tuple(t.shape) for k, t in c.items()} for c in caches],
                     "param_bytes": block_bytes(blocks),
                     "under_specs": TST.bytes_under_specs(params, pspecs, mesh)}
    return out


def repair_serving(name, mesh):
    """A batch-1 prompt of the MoE without expert parallelism through the
    sharded prefill step and SEQ_TICKS ticks (each rank's experts) against
    the unsharded ``serve``'s tokens, with the smallest gap between the
    two largest logits of the unsharded steps (a near-tie could route or
    pick otherwise)."""
    cfg = tp_cfg(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (1, SEQ_PROMPT))
    prompts = prompts.astype(np.int32)
    want, _ = serve(cfg, M.Model(cfg, device="cpu", params=params), list(prompts), batch=1,
                    max_new=SEQ_TICKS + 1, s_max=SEQ_SMAX, device="cpu")
    whole = serve_steps(cfg, params, prompts)[1]
    top2 = np.sort(whole, -1)[..., -2:]
    pspecs = TST.param_specs(params, cfg, mesh)
    got = serve_steps(cfg, shard_state(params, pspecs, mesh), prompts, mesh, pspecs, 1)[0]
    return {"want": want, "got": got.tolist(), "margin": float((top2[..., 1] - top2[..., 0]).min())}


def tp_cases(rank, world, data):
    out = {"families": {}, "vocab": {}, "sp": {}, "sp_prefill": {}, "repair_serving": {}}
    for shape in TP_MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        out["vocab"][shape] = vocab_ops(mesh)
        for name in TP_CASES:
            out["families"][(name, shape)], off = tp_family(name, mesh, data[name])
            if name in SP_CASES:
                out["sp"][(name, shape)] = sp_family(name, mesh, data[name], off)
        if shape[0] == 1:
            for name in SP_PREFILL:
                out["sp_prefill"][(name, shape)] = sp_prefill(name, mesh)
            for name in REPAIR_SERVE:
                out["repair_serving"][(name, shape)] = repair_serving(name, mesh)
    if world == 2:
        out["serving"] = tp_serving()
    return out


# ----------------------------------------------------------- sequence cut
#: name -> (architecture, overrides of its shrink()): gemma3's window of
#: 8 wraps across the ranks' blocks, MLA, attention beside Mamba, one KV
#: head, and 6 q heads over 3 KV heads with a vocabulary of 250.
SEQ_CASES = {"gemma3-4b": ("gemma3-4b", {}),
             "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
             "jamba-v0.1-52b": ("jamba-v0.1-52b", {}), "granite-20b": ("granite-20b", {}),
             "h6-kv3-v250": TP_CASES["h6-kv3-v250"]}
#: A prompt of 12 (past gemma3's window, so its window layers take the
#: roll), 9 ticks (the window caches wrap), caches of 22 slots: over 4
#: ranks blocks of 6, the last padded by 2.
SEQ_PROMPT, SEQ_TICKS, SEQ_SMAX = 12, 9, 22
#: By world size, (mesh, seq_shard_kv, global batch): at batch 1 every
#: data axis of more than one rank cuts the sequence (7a); with
#: seq_shard_kv and no such axis, 'model' does (7b); (2, 2) at batch 2
#: cuts the batch over 'data' and the sequence over 'model' at once.
SEQ_RUNS = {2: (((2, 1), False, 1), ((1, 2), True, 1)),
            4: (((4, 1), False, 1), ((2, 2), False, 1), ((1, 4), True, 1), ((2, 2), True, 2))}


def seq_cfg(name, **over):
    arch, base = SEQ_CASES[name]
    return family_cfg(arch, **base, **over)


def whole_logits(logits, plan):
    """The (B, V) logits whole: the rank's columns gathered over
    ``model`` where the plan cuts the vocabulary."""
    logits = logits.reshape(logits.shape[0], -1)
    tp = plan.head_tp if plan is not None else None
    if tp is None:
        return logits
    out = logits.new_empty((tp.size * logits.shape[0], logits.shape[1]))
    sharded._ALL_GATHER(out, logits.contiguous(), group=tp.group)
    return torch.cat(list(out.view(tp.size, *logits.shape)), -1)


def serve_steps(cfg, params, prompts, mesh=None, specs=None, batch=None):
    """A prefill of ``prompts`` and SEQ_TICKS decode ticks through the
    steps (with ``mesh`` and ``specs`` the sharded ones, the caches
    :func:`launch.steps.cache_blocks`'); returns the tokens (B,
    SEQ_TICKS + 1), every step's whole logits (SEQ_TICKS + 1, B, V) and
    the caches."""
    seen, real = [], TST._next_token

    def spy(logits, plan):
        seen.append(whole_logits(logits, plan))
        return real(logits, plan)

    B = prompts.shape[0]
    caches = (M.init_cache(cfg, B, SEQ_SMAX, dtype=torch.float32, device="cpu") if mesh is None
              else TST.cache_blocks(cfg, mesh, batch, SEQ_SMAX, dtype=torch.float32,
                                    device="cpu"))
    toks = torch.cat([torch.as_tensor(prompts, dtype=torch.long),
                      torch.zeros((B, 1), dtype=torch.long)], 1)
    TST._next_token = spy
    try:
        kw = dict(batch=batch, s_max=SEQ_SMAX)
        nxt, caches = TST.make_prefill_step(cfg, mesh, specs, **kw)(params, {"tokens": toks},
                                                                     caches)
        tick = TST.make_serve_step(cfg, mesh, specs, **kw)
        out, pos = [nxt], torch.full((B,), prompts.shape[1], dtype=torch.int32)
        for _ in range(SEQ_TICKS):
            nxt, caches = tick(params, caches, nxt, pos)
            out.append(nxt)
            pos = pos + 1
    finally:
        TST._next_token = real
    return torch.cat(out, 1), torch.stack(seen).numpy(), caches


def seq_inputs(name):
    """A case's parameters (``init_params`` from seed 0) and two prompts
    of SEQ_PROMPT tokens (numpy, seed 5)."""
    cfg = seq_cfg(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, SEQ_PROMPT))
    return params, prompts.astype(np.int32)


@functools.lru_cache(maxsize=None)
def seq_unsharded(name, batch):
    """The unsharded ``serve``'s tokens and the whole form's tokens and
    logits (the steps without a mesh) of a case's first ``batch``
    prompts, with its parameters and prompts."""
    cfg = seq_cfg(name)
    params, prompts = seq_inputs(name)
    prompts = prompts[:batch]
    want, _ = serve(cfg, M.Model(cfg, device="cpu", params=params), list(prompts), batch=batch,
                    max_new=SEQ_TICKS + 1, s_max=SEQ_SMAX, device="cpu")
    return params, prompts, want, *serve_steps(cfg, params, prompts)[:2]


def seq_case(name, shape, knob, batch):
    """One case over one mesh: the unsharded ``serve``'s tokens and the
    whole form's logits for the rank's rows, and the sharded steps'
    tokens, logits, cache bytes against ``bytes_under_specs`` of the
    whole cache under ``cache_specs``, and each layer's cut (its axes
    and block)."""
    cfg = seq_cfg(name, seq_shard_kv=knob)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    params, prompts, want, whole_toks, whole = seq_unsharded(name, batch)
    pspecs = TST.param_specs(params, cfg, mesh)
    rows = shard_leaf(torch.arange(batch), TST.batch_specs(cfg, mesh, batch)["tokens"][:1],
                      mesh).tolist()
    toks, logits, caches = serve_steps(cfg, shard_state(params, pspecs, mesh), prompts[rows],
                                       mesh, pspecs, batch)
    cspecs = TST.cache_specs(cfg, mesh, batch)
    plan, _ = TST._serving_plan(cfg, mesh, pspecs, batch, SEQ_SMAX)
    return {"rows": rows, "want": [want[r] for r in rows], "got": toks.tolist(),
            "whole_tokens": whole_toks[rows].tolist(), "whole": whole[:, rows],
            "logits": logits, "cache_bytes": block_bytes(caches),
            "under_specs": TST.bytes_under_specs(
                M.init_cache(cfg, batch, SEQ_SMAX, dtype=torch.float32, device="cpu"), cspecs,
                mesh),
            "cuts": [None if c is None else (c.axes, c.block, c.length) for c in plan.seq],
            "cache": [{k: tuple(t.shape) for k, t in c.items()} for c in caches]}


def seq_cases(world):
    out = {}
    for shape, knob, batch in SEQ_RUNS[world]:
        for name in SEQ_CASES:
            out[(name, shape, knob)] = seq_case(name, shape, knob, batch)
    return out


def main(rank: int, world: int, init_file: str, out_dir: str, mode=None, data=None) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        if mode == "sharded":
            data = pickle.loads(Path(data).read_bytes())
            out = sharded_cases(rank, world, data, out_dir)
            Path(out_dir, f"sharded{rank}.pkl").write_bytes(pickle.dumps(out))
            return
        if mode == "tp":
            out = tp_cases(rank, world, pickle.loads(Path(data).read_bytes()))
            Path(out_dir, f"tp{rank}.pkl").write_bytes(pickle.dumps(out))
            return
        if mode == "seq":
            out = seq_cases(world)
            Path(out_dir, f"seq{rank}.pkl").write_bytes(pickle.dumps(out))
            return
        out = {"compression": compression(rank, world), "pipeline": pipeline(world),
               "ep_moe_apply": ep_moe_apply(rank, world), "ep_mesh_moe": ep_mesh_moe(world),
               "deepseek": deepseek(world)}
        if world == 2:
            out["remat_ep"] = remat_ep(world)
            out["train"] = train_steps(world, rank, (2, 1), "smoke")
            out["main"] = TT.main(["--device", "cpu", "--preset", "smoke", "--steps", "3",
                                   "--log-every", "100"])
        else:
            out["train"] = train_steps(world, rank, (2, 2), "deepseek-v2-lite-16b")
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], *sys.argv[5:])
