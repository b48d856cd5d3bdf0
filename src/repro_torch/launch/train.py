"""End-to-end training driver: data pipeline -> train step ->
checkpoint/restart -> monitoring, the counterpart of
``repro.launch.train``.  The same code runs a preset on the CPU
(``--device cpu``) and an architecture at full width on the card; only
flags differ.  Under a ``torch.distributed`` process group (the
caller's, or under ``torchrun`` the one its environment describes, which
``main`` starts and ends) it trains over a ``(data, model)`` mesh of every rank
(``--model-parallel`` sizes ``model``), each data coordinate reading its
own share of every batch, and each rank storing its block of the state
by the reference's specs (``launch.steps.train_specs``) and computing
with its blocks over ``model`` (tensor parallelism); checkpoints hold
whole leaves whatever the world size.

Fault-tolerance behaviour (held by tests/test_torch_train.py):
* resume: ``--resume`` restores the latest checkpoint (params + opt + data
  step) and continues with the *identical* batch stream (deterministic
  pipeline);
* emergency save: SIGTERM/SIGINT triggers a final synchronous checkpoint
  before exit (preemption path on real clusters);
* step timing: per-step EWMA (``distributed.monitor.StepTimer``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset smoke --steps 12
  PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300 \\
      --ckpt-dir /tmp/ckpt --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --seq 512 --batch 4
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --preset smoke --steps 12
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch._tree import at, flatten, map_tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, make_batches, synthetic_dataset
from repro_torch.distributed import sharded
from repro_torch.distributed.monitor import StepTimer
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (BACKENDS, dp_axes, local_test_mesh, shard_count,
                                     shard_index)
from repro_torch.models import model as M
from repro_torch.models.model import LayerSpec, ModelConfig
from repro_torch.optim import OptConfig, init_opt_state

PRESETS = {
    # name -> (ModelConfig kwargs, seq, batch)  (vocab kept modest for CPU)
    "smoke": (dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                   d_ff=512, vocab_size=512, n_layers=2), 128, 4),
    "20m": (dict(d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
                 d_ff=1536, vocab_size=8192, n_layers=6), 256, 4),
    "100m": (dict(d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                  d_ff=3072, vocab_size=32768, n_layers=12), 512, 8),
}


def preset_config(name: str) -> tuple[ModelConfig, int, int]:
    """(config, seq, batch) of a preset: ``n_layers`` dense global
    attention layers, ``max_seq = seq``."""
    kw, seq, batch = PRESETS[name]
    kw = dict(kw)  # PRESETS must survive repeated calls
    n_layers = kw.pop("n_layers")
    spec = LayerSpec(kind="attn", window=None, mlp="dense")
    cfg = ModelConfig(name=f"preset-{name}", blocks=(((spec,), n_layers),),
                      max_seq=seq, **kw)
    return cfg, seq, batch


def build_state(cfg: ModelConfig, ocfg: OptConfig, *, seed: int = 0, device=None,
                mesh=None, specs=None) -> dict:
    """``{"params", "opt"}``: random parameters from ``seed``
    (``models.model.init_params``) as leaves that require grad, and the
    optimizer's zero state beside them, on ``device`` (default: the
    card).  Every rank draws the same values from the same seed.

    Under ``mesh`` each rank keeps its block of every leaf by ``specs``
    (default ``launch.steps.train_specs``): it draws each leaf whole, in
    ``init_params``' order from the same generator, keeps its block and
    frees the rest before the next draw, so no more than one whole leaf
    is held; the blocks equal ``sharded.shard_state`` of the whole state
    bit for bit."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        params = M.init_params(cfg, gen)
        params = map_tree(lambda _, p: p.requires_grad_(True), params)
        return {"params": params, "opt": init_opt_state(params, ocfg, cfg)}
    pspecs = (specs if specs is not None else S.train_specs(cfg, ocfg, mesh))["params"]
    params = M.init_params(cfg, gen, place=lambda path, whole: sharded.shard_leaf(
        whole, at(pspecs, path), mesh))
    params = map_tree(lambda _, p: p.requires_grad_(True), params)
    return {"params": params, "opt": init_opt_state(params, ocfg, cfg, pspecs, mesh)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=sorted(PRESETS))
    ap.add_argument("--arch", default=None,
                    help="assigned arch id (full config)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--record", default=None,
                    help="write this rank's losses, step times and peak card memory as JSON "
                         "to this path ('{rank}' in it becomes the rank)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # torchrun describes the group in the environment (RANK, WORLD_SIZE,
        # MASTER_ADDR, MASTER_PORT, LOCAL_RANK): one card per rank
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(BACKENDS[dev.type])
        started = True
    if args.arch:
        from repro_torch.configs import get_arch
        cfg = get_arch(args.arch).model
        seq, batch = args.seq or 4096, args.batch or 256
    else:
        cfg, seq, batch = preset_config(args.preset)
        seq = args.seq or seq
        batch = args.batch or batch

    mesh, host_index, host_count = None, 0, 1
    if dist.is_available() and dist.is_initialized():
        mesh = local_test_mesh(model=args.model_parallel, device=dev)
        host_index, host_count = shard_index(mesh, dp_axes(mesh)), shard_count(mesh, dp_axes(mesh))
    elif args.model_parallel != 1:
        raise ValueError("--model-parallel needs a torch.distributed process group "
                         "(run under torchrun)")
    ocfg = OptConfig(lr=args.lr, total_steps=max(args.steps, 100),
                     warmup_steps=min(50, max(5, args.steps // 10)))

    specs = S.train_specs(cfg, ocfg, mesh) if mesh is not None else None
    state = build_state(cfg, ocfg, seed=args.seed, device=dev, mesh=mesh, specs=specs)
    whole = S.state_shapes(cfg, ocfg) if mesh is not None else state
    n_params = sum(p.numel() for p in flatten(whole["params"]).values())
    print(f"[train] model={cfg.name} params={n_params/1e6:.1f}M "
          f"seq={seq} batch={batch} device={dev} "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None}")
    if mesh is not None:
        print(f"[train] rank {dist.get_rank()}: state {sharded.block_bytes(state)} bytes, "
              f"under the reference's specs {S.bytes_under_specs(whole, specs, mesh)}", flush=True)

    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab_size=cfg.vocab_size,
                      seed=args.seed, host_index=host_index, host_count=host_count)
    ds = synthetic_dataset(dcfg, n_tokens=max(1 << 18, 4 * batch * (seq + 1)))

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last=3, specs=specs, mesh=mesh)
        if args.resume and mgr.latest_step() is not None:
            state, extras = mgr.restore(state, device=dev)
            map_tree(lambda _, p: p.requires_grad_(True), state["params"])
            start_step = int(extras["data_step"])
            print(f"[train] resumed at step {start_step}")

    train_step = S.make_train_step(cfg, ocfg, mesh, batch, specs=specs)

    # Emergency checkpoint on preemption (SIGTERM) / Ctrl-C.
    stop = {"now": False}

    def _sig(signum, frame):
        stop["now"] = True

    old_term = signal.signal(signal.SIGTERM, _sig)
    old_int = signal.signal(signal.SIGINT, _sig)

    timer = StepTimer()
    losses, step_s = [], []
    t_start = time.time()
    try:
        for step, host_tokens in make_batches(ds, start_step, args.steps):
            timer.start()
            batch_data = {"tokens": torch.as_tensor(host_tokens).to(dev)}
            state, loss = train_step(state, batch_data)
            loss = float(loss)
            losses.append(loss)
            dt = timer.stop()
            step_s.append(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                tps = batch * seq / max(dt, 1e-9)
                print(f"[train] step={step:5d} loss={loss:8.4f} "
                      f"dt={dt*1e3:7.1f}ms tok/s={tps:9.0f}", flush=True)
            if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, state,
                               extras={"data_step": step + 1, "loss": loss,
                                       "data_fingerprint": dcfg.fingerprint()})
            if stop["now"]:
                print("[train] interrupt — emergency checkpoint", flush=True)
                if mgr:
                    mgr.save(step + 1, state,
                             extras={"data_step": step + 1, "loss": loss,
                                     "emergency": True,
                                     "data_fingerprint": dcfg.fingerprint()})
                break
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        if mgr:
            mgr.wait()

    wall = time.time() - t_start
    if losses:
        peak = (f"; peak card memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB"
                if dev.type == "cuda" else "")
        print(f"[train] done: {len(losses)} steps in {wall:.1f}s "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}{peak}")
    if args.record:
        rank = dist.get_rank() if dist.is_initialized() else 0
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
        path = Path(args.record.format(rank=rank))
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"rank": rank, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))
                                    if mesh is not None else None, "losses": losses,
                                    "step_ms": [1e3 * t for t in step_s], "peak_mib": peak_mib}))
    if started:
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
