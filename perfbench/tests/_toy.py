"""Toy sizes of the cells for the CPU tests: the same drivers and checks,
the program's plain path, seconds of work."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import run as runmod  # noqa: E402
from perfbench.lib import cells  # noqa: E402

BENCH = cells.load_benchmark(ROOT)
LADDER = "schwefel512-v2.chains1m"
RANKS = "schwefel512-v2.chains4m-4cards"


def ladder_parts(cell=LADDER):
    cfg = cells.load_config(BENCH, "schwefel512-v2", ROOT)
    cfg.update(suite_id="F0_b", dim=16, rho=0.8, T0=100.0)
    tr = cells.load_traffic(cells.cell(BENCH, cell)["traffic"])
    tr.update(n_chains=256, check_levels=2)
    return cfg, tr


def run_toy(cell, seed=2**31 + 77, seconds=1.0, trace=False, driver=None):
    cfg, tr = ladder_parts(cell)
    return runmod.run_cell(cell, seed, seconds, trace, device="cpu",
                           config=cfg, traffic=tr, driver=driver)
