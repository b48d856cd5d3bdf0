"""The control of the ladder cells' comparison: the plain reference in
bfloat16, the precision below the configuration's float32, put in the
program's place, and judged by the cell's own check: ``run.run_cell``
with this module as the driver, so ``lib/ladder.judge`` computes the
numbers and ``run_cell`` holds them to the limits in
``traffic/<mix>.json``.  A control that came out correct would show that
the limits cannot tell the precisions apart.

  python3 perfbench/control.py --workload <cell> --seeds 1 2 3

on one card, at the cell's chain count (a four-card cell's chains all on
the one card: the check's champion over slices in chain order is the
champion over all of them).  The control's solve is the first
``control_levels`` levels of the cell's ladder: each level swept by the
bfloat16 reference from the champion of the level before, its
best-so-far carried from the best start.  Prints one JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.lib import ladder  # noqa: E402
from perfbench.reference import ladder_check  # noqa: E402
from perfbench.reference import objectives as ob  # noqa: E402

LOW = torch.bfloat16


def control_solve(cfg: dict, n: int, seed: int, levels: int, device) -> dict:
    """What the program hands the check, from the bfloat16 reference: the
    champion of each of the first ``levels`` levels, the best-so-far
    after each and the answer."""
    T = ladder_check.temperatures(cfg, levels)
    x0 = ladder_check.start_states(cfg, n, seed, device)
    best_f, best_x = float("inf"), None
    for a in range(0, n, ladder_check.BLOCK):
        f = ob.full_value("schwefel", x0[a:a + ladder_check.BLOCK].to(LOW))
        i = int(torch.argmin(f))
        if float(f[i]) < best_f:
            best_f, best_x = float(f[i]), x0[a + i].float().cpu().numpy()
    fs, xs, hist = [], [], []
    x_in = x0
    del x0
    for L in range(levels):
        _, f, x = ladder_check.level_champion(cfg, x_in, L, float(T[L]), seed,
                                              0, n, dtype=LOW)
        del x_in
        fs.append(f)
        xs.append(x)
        if f < best_f:
            best_f, best_x = f, x
        hist.append(best_f)
        x_in = torch.as_tensor(x, device=device)
    return {"seed": seed, "f": np.asarray(fs, np.float32), "x": np.stack(xs),
            "history": hist, "f_best": best_f, "x_best": best_x}


def run(ctx) -> dict:
    """A driver's ``run``: one control solve, judged as the cell's are."""
    cfg, tr = ctx.config, ctx.traffic
    n = tr["n_chains"]
    ctx.mark_window_start()
    solve = control_solve(cfg, n, ladder.solve_seed(ctx.seed, 0),
                          tr["control_levels"], ctx.device)
    ctx.free()
    nums = ladder.judge(cfg, [solve], n, ctx.device, ctx.seed,
                        tr["check_levels"], tr["control_levels"])
    return {"attempted": 1, "failed": 0, "checks": nums, "e2e": {},
            "memory_peak_bytes": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench import run as runmod
    this = sys.modules[__name__]
    for s in args.seeds:
        res = runmod.run_cell(args.workload, s, 0.0, False, device=args.device,
                              driver=this)
        print(json.dumps({"seed": s, "correct": res["correct"],
                          "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
