"""One rank of a sharded-ladder run on the CPU, for ``test_torch_sharded.py``.

    python tests/torch_sharded_worker.py RANK WORLD INIT_FILE OUT_DIR

Joins a gloo process group of WORLD ranks through ``file://INIT_FILE``,
runs every case of :data:`CASES` on each mesh of :data:`MESHES` (by world
size) through ``sa_minimize(mesh=...)``, twice, and writes its results to
``OUT_DIR/rank{RANK}.json``.  Rank 0 also runs each case unsharded and
derives the history the reference defines for a sharded run (the first
shard's local best-so-far) from that unsharded run, level by level.
Floats travel as the hex of their bytes, so the test compares bits.
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

from repro_torch.core import SAConfig, annealing, sa_minimize
from repro_torch.core.metropolis import DTYPES
from repro_torch.launch.mesh import make_mesh
from repro_torch.objectives import functions as F
from repro_torch.objectives import get

# The reference's own sharded-ladder contract (tests/test_distributed.py).
CONTRACT = dict(T0=50.0, T_min=0.5, rho=0.8, N=10, n_chains=256)
CONTRACT_SEEDS = (0, 1, 2, 3)

# (label, objective, SAConfig overrides): B1's and B2's plain versions
# (Schwefel-8 has a kernel_id), and the plain sweep (a suite objective
# without one) in both precisions.
CASES = (
    ("schwefel8 sync full", "schwefel8", dict(exchange="sync")),
    ("schwefel8 sync delta", "schwefel8", dict(exchange="sync", use_delta_eval=True)),
    ("schwefel8 sos", "schwefel8", dict(exchange="sos", seed=3)),
    ("schwefel8 async", "schwefel8", dict(exchange="async", seed=1)),
    ("F11_b sync float32", "F11_b", dict(exchange="sync", n_chains=64)),
    ("F11_b sos float64", "F11_b", dict(exchange="sos", n_chains=64,
                                        dtype="float64")),
)

# Mesh shape, dim names and the dims the chains are cut along, by world.
MESHES = {
    2: (((2,), ("data",), None),),
    4: (((2, 2), ("data", "model"), None),
        ((2, 2), ("data", "model"), ("data",))),
}


def objective(name):
    return F.schwefel(8) if name == "schwefel8" else get(name)


def bits(a) -> str:
    return np.ascontiguousarray(np.asarray(a)).tobytes().hex()


def derived_history(obj, cfg, n_shards):
    """The first shard's best-so-far, from the unsharded run: the running
    min of the values of chains ``[0, n/R)`` after each level's exchange."""
    gen = torch.Generator()
    gen.manual_seed(cfg.seed)
    x0c = obj.sample_uniform(gen, (cfg.n_chains,), DTYPES[cfg.dtype])
    per = cfg.n_chains // n_shards
    state = annealing.init_state(x0c, objective=obj, cfg=cfg)
    best = state.fx[:per].min()
    out = []
    for lvl, T in enumerate(cfg.ladder().tolist()):
        state = annealing.level_step(state, lvl, T, objective=obj, cfg=cfg)
        best = torch.minimum(best, state.fx[:per].min())
        out.append(best)
    return torch.stack(out).numpy()


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {"meshes": []}
        for shape, names, axes in MESHES[world]:
            mesh = make_mesh(shape, names, device="cpu")
            n_shards = int(np.prod([shape[names.index(a)]
                                    for a in (axes or names)]))
            runs = {}
            for label, name, over in CASES:
                obj = objective(name)
                cfg = dataclasses.replace(SAConfig(**CONTRACT), **over)
                r1 = sa_minimize(obj, cfg, mesh=mesh, mesh_axes=axes)
                r2 = sa_minimize(obj, cfg, mesh=mesh, mesh_axes=axes)
                rec = {"f": bits(np.float64(r1.f_best)), "x": bits(r1.x_best),
                       "hist": None if r1.history_f is None else bits(r1.history_f),
                       "again": bits(np.float64(r2.f_best)) == bits(np.float64(r1.f_best))
                       and bits(r2.x_best) == bits(r1.x_best),
                       "err": abs(r1.f_best - obj.f_opt)}
                if rank == 0:
                    u = sa_minimize(obj, cfg, device="cpu")
                    rec["unsharded"] = {
                        "f": bits(np.float64(u.f_best)), "x": bits(u.x_best),
                        "f_x": float(obj(torch.from_numpy(r1.x_best)[None])[0]),
                        "hist": (None if cfg.exchange == "async" else
                                 bits(derived_history(obj, cfg, n_shards))),
                        "hist_unsharded": (None if u.history_f is None
                                           else bits(u.history_f))}
                runs[label] = rec
            contract = []
            for seed in CONTRACT_SEEDS:
                obj = F.schwefel(8)
                cfg = SAConfig(**CONTRACT, seed=seed, record_history=False)
                r = sa_minimize(obj, cfg, mesh=mesh, mesh_axes=axes)
                contract.append(abs(r.f_best - obj.f_opt))
            try:
                sa_minimize(F.schwefel(8), SAConfig(**{**CONTRACT, "n_chains": n_shards + 1}),
                            mesh=mesh, mesh_axes=axes)
                indivisible = None
            except ValueError as e:
                indivisible = str(e)
            out["meshes"].append({"shape": shape, "axes": axes, "runs": runs,
                                  "contract_err": contract,
                                  "indivisible": indivisible})
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
