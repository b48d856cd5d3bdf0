"""Dry run of the port: every (arch × shape × mesh) cell's step run once
on fake tensors over a fake world of the production mesh's size,
allocating nothing and launching nothing, with its roofline terms.  The
counterpart of ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sa   # the SA production cell

Where the reference lowers and compiles each cell with XLA and reads its
HLO (``repro.launch.hloparse``), the port runs its own step
(``launch.steps.build_cell``) under an op census (``launch.opcensus``):
FLOPs, the bytes every aten op reads and writes, the collectives' bytes
on the wire and the peak of live bytes, all per rank.  The world is
torch's fake process group (``launch.mesh.start_fake_world``), whose
collectives move no data.  One JSON record per cell goes to ``--out``
(default ``artifacts/dryrun_torch``), with the reference's keys where
they mean the same.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.kernels.bounds import (BF16_OPS_PER_S, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S,
                                        TERM_INSTR, b1_cost, b2_cost)
from repro_torch.launch.mesh import make_production_mesh, mesh_size, start_fake_world
from repro_torch.launch.opcensus import Census, op_census, wire_bytes
from repro_torch.launch.steps import build_cell, bytes_under_specs, mesh_axes



def collective_bytes(census: dict) -> dict:
    """Operand bytes of every collective kind in a census's result (the
    reference's census of the HLO's collectives, before the ring model)."""
    return dict(census["coll_operands"])


def roofline_terms(flops: float, bytes_acc: float, coll: dict) -> dict:
    """Per-rank quantities over per-card peaks (the census counts one
    rank's work), as the reference's terms over its per-chip peaks."""
    cbytes = float(sum(coll.values()))
    return {
        "compute_s": flops / BF16_OPS_PER_S,
        "memory_s": bytes_acc / HBM_BYTES_PER_S,
        "collective_s": cbytes / NVLINK_BYTES_PER_S,
        "collective_bytes": cbytes,
    }


def _bottleneck(terms: dict) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]).replace("_s", "")


def _suffix(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def _tag(overrides) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted((overrides or {}).items()))


def record_path(out_dir: Path, arch_id: str, shape_name: str, multi_pod: bool,
                overrides=None) -> Path:
    """A cell's record: ``{arch}__{shape}__{single|multi}.json``, a knob's
    with ``__{tag}`` before the suffix."""
    tag = _tag(overrides)
    return out_dir / f"{arch_id}__{shape_name}__{_suffix(multi_pod)}{'__' + tag if tag else ''}.json"


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool, out_dir: Path,
             mesh=None, spec=None, overrides: dict = None) -> dict:
    """One cell's step under the census; writes and returns its record.
    ``mesh`` defaults to the production mesh over the fake world the
    caller started; ``spec`` to ``get_arch(arch_id)``.  ``overrides``
    (ModelConfig fields, e.g. ``{"seq_shard_kv": True}``) make a knob's
    record: its tag names them, and its file carries the tag beside the
    default record's name."""
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh_size(mesh)
    spec = spec if spec is not None else get_arch(arch_id)
    t0 = time.time()
    cell = build_cell(spec, shape_name, mesh, overrides=overrides)
    tag = _tag(overrides)
    t_build = time.time() - t0
    with cell.mode:
        sizes = {k: Census().hold(v) for k, v in cell.parts.items()}
        under_specs = bytes_under_specs(cell.whole, cell.specs, mesh)
        cache_under = (None if cell.kind == "train" else
                       bytes_under_specs(cell.whole_cache, cell.cache_specs, mesh))
        groups = {a: mesh.get_group(a) for a, n in mesh_axes(mesh).items() if n > 1}
        with op_census(*cell.args, groups=groups) as census:
            cell.fn(*cell.args)
    t_measure = time.time() - t0 - t_build
    res = census.result()
    held = sum(sizes.values())
    terms = roofline_terms(res["flops"], res["hbm_bytes"], res["wire"])
    tot, act = cell.model_cfg.param_count()
    seq_len, batch, kind = SHAPES[shape_name]
    tokens = batch * (seq_len if kind != "decode" else 1)
    # 6ND for a train step (fwd+bwd), 2ND for inference FLOPs
    model_flops = (6 if kind == "train" else 2) * act * tokens
    flops = res["flops"]
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": list(mesh_axes(mesh).values()),
        "multi_pod": multi_pod, "n_chips": n_chips, "kind": kind, "tag": tag,
        "params_total": tot, "params_active": act,
        "model_cfg": {"param_dtype": cell.model_cfg.param_dtype,
                      "compute_dtype": cell.model_cfg.compute_dtype,
                      "remat": cell.model_cfg.remat, "moe_ep": cell.model_cfg.moe_ep,
                      "seq_shard_kv": cell.model_cfg.seq_shard_kv,
                      "seq_parallel": cell.model_cfg.seq_parallel},
        "optimizer": dataclasses.asdict(cell.ocfg) if cell.ocfg else None,
        "layout": cell.layout,
        "bytes_per_device": {
            **{k: sizes.get(k, 0) for k in ("state", "params", "batch", "cache")},
            "activations_peak": res["peak"] - held,
            "peak": res["peak"],
            "state_under_specs": under_specs,
            **({} if cache_under is None else {"cache_under_specs": cache_under}),
        },
        "flops": flops, "bytes": res["hbm_bytes"],
        "by_op": res["by_op"], "calls": res["calls"],
        "collectives": res["wire"], "collectives_by_axis": res["wire_by_group"],
        "collective_calls_by_axis": res["calls_by_group"],
        "collective_operands": collective_bytes(res),
        "roofline": terms,
        "model_flops": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "useful_flops_frac": (model_flops / n_chips) / flops if flops else None,
        "build_s": t_build, "measure_s": t_measure,
    }
    rec["bottleneck"] = _bottleneck(terms)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = _suffix(multi_pod)
    path = record_path(out_dir, arch_id, shape_name, multi_pod, overrides)
    path.write_text(json.dumps(rec, indent=1))
    print(f"[ok] {arch_id:24s} {shape_name:12s} {suffix:12s}{' ' + tag if tag else ''} "
          f"compute={terms['compute_s']:.3e}s memory={terms['memory_s']:.3e}s "
          f"coll={terms['collective_s']:.3e}s dom={rec['bottleneck']} "
          f"peak={res['peak'] / 2**30:.2f}GiB state_under_specs={under_specs / 2**30:.2f}GiB "
          f"(build {t_build:.1f}s measure {t_measure:.1f}s)", flush=True)
    return rec


def _sa_measure(n_local: int, dim: int, n_steps: int, n_chips: int) -> dict:
    """One ladder level on one rank, by the kernels' cost models: one B1
    ``full`` launch over the rank's chains, two B2 over their values, and
    the champions' all-gather over every rank (one row of f and x each),
    ring model."""
    b1_bytes, b1_ops_s = b1_cost(n_local, dim, n_steps)["full"]
    b2_bytes, b2_ops_s = b2_cost(n_local)
    gathered = n_chips * (dim + 1) * 4
    return {"launches": {"b1": 1, "b2": 2, "all-gather": 1},
            "bytes": b1_bytes + 2 * b2_bytes, "ops_s": b1_ops_s + 2 * b2_ops_s,
            "wire": wire_bytes("all-gather", 0, gathered, n_chips)}


def run_sa_cell(*, multi_pod: bool, out_dir: Path, n_chains: int = 1 << 22,
                dim: int = 512, n_steps: int = 100, mesh=None) -> dict:
    """The paper's own technique at production scale: Schwefel-``dim``,
    ``n_chains`` chains cut over every rank, the ladder T0 = 1000 to
    T_min = 0.01 at rho = 0.99 (1146 levels) of ``n_steps`` steps each,
    each chain's full re-evaluation per step (the reference's default),
    with the sync exchange (the champions gathered every level).

    The reference solved loop algebra because XLA counts a loop body
    once; the port counts launches: each level's (:func:`_sa_measure`)
    times the levels, each launch charged its kernel's cost model
    (``kernels.bounds``)."""
    from repro_torch.core import SAConfig
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh_size(mesh)
    cfg = SAConfig(T0=1000.0, T_min=0.01, rho=0.99, N=n_steps, n_chains=n_chains,
                   exchange="sync", record_history=False)
    n_local = n_chains // n_chips
    level = _sa_measure(n_local, dim, n_steps, n_chips)
    L = cfg.n_levels
    coll = {"all-gather": L * level["wire"]}
    terms = {"compute_s": L * level["ops_s"], "memory_s": L * level["bytes"] / HBM_BYTES_PER_S,
             "collective_s": coll["all-gather"] / NVLINK_BYTES_PER_S,
             "collective_bytes": coll["all-gather"]}
    rec = {
        "arch": f"sa-schwefel-{dim}", "shape": f"chains_{n_chains}",
        "mesh": list(mesh_axes(mesh).values()), "multi_pod": multi_pod,
        "n_chips": n_chips, "kind": "sa", "tag": "",
        "exchange": "sync", "n_evals": cfg.n_evals,
        "delta_eval": False, "levels": L, "N": n_steps,
        "chains_per_rank": n_local, "term_instr": TERM_INSTR,
        "launches": {k: L * v for k, v in level["launches"].items()},
        "per_level": level,
        "bytes_per_device": {"state": n_local * (dim + 1) * 4},
        "bytes": L * level["bytes"], "ops_s": L * level["ops_s"],
        "collectives": coll, "roofline": terms,
    }
    rec["bottleneck"] = _bottleneck(terms)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = _suffix(multi_pod)
    path = out_dir / f"sa_schwefel{dim}__sync__{suffix}.json"
    path.write_text(json.dumps(rec, indent=1))
    print(f"[ok] SA sync chains={n_chains} dim={dim} {suffix} "
          f"compute={terms['compute_s']:.3e}s memory={terms['memory_s']:.3e}s "
          f"coll={terms['collective_s']:.3e}s dom={rec['bottleneck']}", flush=True)
    return rec


@contextlib.contextmanager
def fake_world(multi_pod: bool):
    """A fake world of the production mesh's size and the mesh over it,
    torn down on leaving."""
    start_fake_world(512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()


def jobs_of(args) -> list:
    """The reference's list of (arch or "sa", shape, multi_pod) jobs."""
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = []
    if args.sa:
        for mp in meshes:
            jobs.append(("sa", None, mp))
    if args.all:
        for aid in ARCH_IDS:
            for shape_name, _ in get_arch(aid).shapes():
                for mp in meshes:
                    jobs.append((aid, shape_name, mp))
    elif args.arch:
        shapes = ([args.shape] if args.shape
                  else [s for s, _ in get_arch(args.arch).shapes()])
        for s in shapes:
            for mp in meshes:
                jobs.append((args.arch, s, mp))
    return jobs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sa", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    jobs = jobs_of(args)

    failures, records = [], []
    for mp in sorted({mp for _, _, mp in jobs}):
        with fake_world(mp) as mesh:
            for aid, shape_name, _ in [j for j in jobs if j[2] == mp]:
                suffix = _suffix(mp)
                if args.skip_existing and aid != "sa":
                    if record_path(out_dir, aid, shape_name, mp).exists():
                        print(f"[skip] {aid} {shape_name} {suffix}")
                        continue
                try:
                    if aid == "sa":
                        records.append(run_sa_cell(multi_pod=mp, out_dir=out_dir, mesh=mesh))
                    else:
                        records.append(run_cell(aid, shape_name, multi_pod=mp,
                                                out_dir=out_dir, mesh=mesh))
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures.append((aid, shape_name, mp, repr(e)))
                    print(f"[FAIL] {aid} {shape_name} {suffix}: {e!r}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(records)} dry-run cells passed")
    return records


if __name__ == "__main__":
    main()
