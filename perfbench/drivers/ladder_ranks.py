"""The V2 ladder over ranks, one process per card: every rank calls
``repro_torch.sa_minimize(..., mesh=)`` on its slice of the traffic's
chains, a mesh of the cell's cards along ``data``, and the champion is
all-gathered over NCCL at every level.

``run.py`` starts the ranks (``prestart``) before it imports torch and
looks for the cards, so that the ranks' own start-up (imports, the
process group on a free localhost port, the NCCL communicator) runs
beside the parent's; where no card is found it stops them.  The ranks
load no kernel until the parent has built the library and said so
(``Ranks.release``), so they never race on its build.  The ranks agree
on the window: after each solve rank 0 decides whether another starts
and tells the others.  ``sa_proposals_per_s`` counts every card's
chains.  The check sweeps each rank's slice on its own card and
combines the slices' champions in chain order.  Rank 0 hands its outcome
back through a file in a temporary directory, with the set-up's stages
(``extra`` ``setup_stages_s``: seconds from the parent's start at which
the ranks were started and the library built, and each rank had
entered, imported, joined the process group, formed its NCCL
communicator, been released, warmed up, and started the window).

  python -m perfbench.drivers.ladder_ranks <spec.json> <rank>

is a rank's entry (the parent writes the spec).
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RELEASE_POLL_S = 0.02


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The rank processes of one run, their spec and their temporary
    directory.  ``close`` stops whatever still runs and waits for it."""

    def __init__(self, spec: dict, root: Path):
        self.tmp = tempfile.TemporaryDirectory(prefix="perfbench-ranks-")
        d = Path(self.tmp.name)
        self.spec = dict(spec, port=_free_port(), out=str(d / "rank0.pkl"),
                         release=str(d / "released"), root=str(root))
        path = d / "spec.json"
        path.write_text(json.dumps(self.spec))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root / "src"), str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
        self.started = time.time() - spec["t_start"]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "perfbench.drivers.ladder_ranks",
             str(path), str(r)], cwd=str(root), env=env)
            for r in range(spec["world"])]

    def release(self):
        Path(self.spec["release"]).write_text("")

    def wait(self, timeout_s: float) -> dict:
        limit = time.monotonic() + timeout_s
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, limit - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} failed or timed out")
        with open(self.spec["out"], "rb") as f:
            return pickle.load(f)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        self.tmp.cleanup()


def _spec(cell, seed, seconds, trace, device, config, traffic, world, t_start):
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": bool(trace),
            "device": device, "config": config, "traffic": traffic,
            "world": world, "t_start": t_start}


def prestart(args, bench, root: Path, t_start: float) -> Ranks:
    """Start the ranks of ``args``' cell (``run.py``'s arguments) on the
    cards, before the parent's own start-up."""
    from perfbench.lib import cells
    cell = cells.cell(bench, args.workload)
    spec = _spec(args.workload, args.seed, args.seconds, args.trace, "cuda",
                 cells.load_config(bench, cell["config"], root),
                 cells.load_traffic(cell["traffic"], root / "perfbench"),
                 cell["chips"], t_start)
    return Ranks(spec, root)


def run(ctx) -> dict:
    ranks = ctx.early
    if ranks is None:
        world = ctx.chips if ctx.on_card else ctx.traffic["cpu_ranks"]
        ranks = Ranks(_spec(ctx.cell_name, ctx.seed, ctx.seconds, ctx.trace,
                            ctx.device, ctx.config, ctx.traffic, world,
                            ctx.t_start), ctx.root)
    try:
        if ctx.on_card:
            from repro_torch.kernels import _build
            _build.build()
        built = time.time() - ctx.t_start
        ranks.release()
        out = ranks.wait(ctx.traffic["rank_timeout_s"])
    finally:
        ranks.close()
    ctx.window_start = out["window_start"]
    stages = out.setdefault("extra", {}).setdefault("setup_stages_s", {})
    stages.update(started=ranks.started, built=built)
    return out


RANK_STAGES = ("entered", "imported", "joined", "communicator", "released",
               "warmed", "window")


def rank_main(spec_path: str, rank: int) -> int:
    stamps = [time.time()]
    spec = json.loads(Path(spec_path).read_text())
    root = Path(spec["root"])
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import run as runmod
    runmod.cache_env(root)
    import numpy as np
    import torch
    import torch.distributed as dist

    from perfbench.lib import ladder
    from perfbench.lib.records import Records
    from perfbench.lib.trace import Tracer, union_s
    from perfbench.reference import ladder_check
    from repro_torch.core.annealing import sa_minimize
    from repro_torch.launch.mesh import make_mesh

    stamps.append(time.time())
    world, dev_type = spec["world"], spec["device"]
    on_card = dev_type != "cpu"
    if on_card:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=world, rank=rank)
    stamps.append(time.time())
    try:
        # The first collective forms the communicator (NCCL: lazily).
        dist.barrier()
        stamps.append(time.time())
        limit = time.monotonic() + spec["traffic"]["rank_timeout_s"]
        while not Path(spec["release"]).exists():
            if time.monotonic() > limit:
                raise TimeoutError("the parent never released the ranks")
            time.sleep(RELEASE_POLL_S)
        stamps.append(time.time())
        mesh = make_mesh((world,), ("data",), device=dev_type)
        cfg, tr, seed = spec["config"], spec["traffic"], spec["seed"]
        n = tr["n_chains"]
        per = n // world
        obj = ladder.objective(cfg)

        def sync():
            if on_card:
                torch.cuda.synchronize()

        def solve(s, levels=None):
            return sa_minimize(obj, ladder.sa_config(cfg, n, s, levels),
                               device=device, mesh=mesh)

        solve(ladder.solve_seed(seed, 10**6), tr["warm_levels"])
        sync()
        stamps.append(time.time())
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        tracer = Tracer(on_card)
        traced = 1 if spec["trace"] else None
        rec = ladder.Recorder(timed=spec["trace"] and rank == 0)
        solves = []

        def run_solve(i):
            rec.keep_spans = i != traced
            s = ladder.solve_seed(seed, i)
            rec.begin()
            r = solve(s)
            solves.append({"seed": s, "f_best": r.f_best, "x_best": r.x_best,
                           "history": r.history_f})

        def keep_going(elapsed):
            go = elapsed < spec["seconds"] or (traced is not None
                                               and len(solves) <= traced)
            flag.fill_(int(go))
            dist.broadcast(flag, 0)
            return bool(flag.item())

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        window_start = time.time()
        stamps.append(window_start)
        with rec:
            count, wall = ladder.window(
                run_solve, spec["seconds"], keep_going,
                (traced, tracer.stretch) if spec["trace"] else None)
        peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        levels = ladder_check.n_levels(cfg)
        for i, s in enumerate(solves):
            s["f"], s["x"] = rec.champions(i)
        spans = list(rec.spans)
        del rec
        sync()

        def gather(part):
            parts = [None] * world
            dist.all_gather_object(parts, part)
            return parts

        nums = ladder.judge(cfg, solves, n, device, seed, tr["check_levels"],
                            levels, slices=(rank * per, (rank + 1) * per),
                            gather=gather)
        st = tracer.result
        times = [None] * world
        dist.all_gather_object(times, (peak, union_s(st.device) if st else 0.0,
                                       st.window_s if st else 0.0,
                                       [t - spec["t_start"] for t in stamps]))
        if rank == 0:
            out = {"attempted": count, "failed": 0, "checks": nums,
                   "e2e": {"sa_proposals_per_s": count * levels * cfg["N"] * n / wall},
                   "memory_peak_bytes": max(t[0] for t in times),
                   "window_start": window_start,
                   "extra": {"setup_stages_s": {
                       k: [t[3][i] for t in times]
                       for i, k in enumerate(RANK_STAGES)}}}
            if spec["trace"]:
                out["device_times"] = (float(np.mean([t[1] for t in times])),
                                       float(np.mean([t[2] for t in times])))
                out["records"] = Records(
                    cell=spec["cell"], config=cfg, traffic=tr, stretch=st,
                    host_spans={"level_step": spans},
                    counts={"levels": levels, "chains": per})
            bad = runmod.forbidden_modules()
            if bad:
                print(f"rank 0: modules of the JAX side loaded: {bad}",
                      file=sys.stderr)
                return 3
            with open(spec["out"], "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
