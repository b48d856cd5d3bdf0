"""One rank of the port's multi-rank training pieces on the CPU, for
``test_torch_distributed.py``.

    python tests/torch_train_worker.py RANK WORLD INIT_FILE OUT_DIR

Joins a gloo process group of WORLD ranks through ``file://INIT_FILE``
and runs, on every rank, with inputs from numpy and torch seeds that
every rank draws alike: ``compressed_psum`` and ``compress_grads_tree``
over each mesh of :data:`MESHES`, the GPipe pipeline over a ``pod`` axis, the expert-parallel
MoE (``moe_apply`` with distinct tokens per rank, ``_moe`` under a mesh
with the same tokens on every rank, ``lm_loss`` of shrink(deepseek) with
``moe_ep``) against its local form, values and gradients, and train
steps over a mesh against the unsharded steps.  Writes what it found to
``OUT_DIR/rank{RANK}.json``.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import flatten
from repro_torch.configs import get_arch, shrink
from repro_torch.distributed.compression import (compress_grads_tree, compressed_psum,
                                                 init_residuals, quantize_int8)
from repro_torch.distributed.pipeline import bubble_fraction, make_pipelined_fn
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import OptConfig

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


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
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
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
