"""The V2 ladder on one card: whole ``repro_torch.sa_minimize`` solves of
the configuration at the traffic's chain count, back to back.

Set-up imports, starts the card and runs a short solve at the full chain
count, which builds the kernel library on a checkout's first run and
warms every shape the window uses.  ``sa_proposals_per_s`` is levels x N
x chains of every solve over the window, the last solve counted whole.
The traced run profiles its second solve and times each level on the
host in the others.
"""
from __future__ import annotations

from perfbench.lib import ladder
from perfbench.lib.records import Records
from perfbench.reference import ladder_check


def run(ctx) -> dict:
    from repro_torch.core.annealing import sa_minimize
    cfg, tr = ctx.config, ctx.traffic
    n = tr["n_chains"]
    obj = ladder.objective(cfg)
    dev = ctx.device

    warm = ladder.sa_config(cfg, n, ladder.solve_seed(ctx.seed, 10**6),
                            levels=tr["warm_levels"])
    sa_minimize(obj, warm, device=dev)
    ctx.sync()
    levels = ladder_check.n_levels(cfg)
    solves = []
    rec = ladder.Recorder(timed=ctx.trace)
    traced = 1 if ctx.trace else None

    def run_solve(i):
        rec.keep_spans = i != traced
        seed = ladder.solve_seed(ctx.seed, i)
        rec.begin()
        r = sa_minimize(obj, ladder.sa_config(cfg, n, seed), device=dev)
        solves.append({"seed": seed, "f_best": r.f_best, "x_best": r.x_best,
                       "history": r.history_f})

    def keep_going(elapsed):
        return elapsed < ctx.seconds or (ctx.trace and len(solves) <= traced)

    ctx.reset_peak()
    ctx.mark_window_start()
    with rec:
        count, wall = ladder.window(
            run_solve, ctx.seconds, keep_going,
            (traced, ctx.tracer.stretch) if ctx.trace else None)
    peak = ctx.peak_bytes()
    for i, s in enumerate(solves):
        s["f"], s["x"] = rec.champions(i)
    spans = list(rec.spans)
    del rec
    ctx.free()
    nums = ladder.judge(cfg, solves, n, dev, ctx.seed, tr["check_levels"],
                        levels)
    out = {"attempted": count, "failed": 0, "checks": nums,
           "e2e": {"sa_proposals_per_s": count * levels * cfg["N"] * n / wall},
           "memory_peak_bytes": peak}
    if ctx.trace:
        out["records"] = Records(
            cell=ctx.cell_name, config=cfg, traffic=tr,
            stretch=ctx.tracer.result, host_spans={"level_step": spans},
            counts={"levels": levels, "chains": n})
    return out
