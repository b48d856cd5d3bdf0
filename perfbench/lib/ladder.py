"""What the two ladder drivers share: the solve loop of the window, the
recorder of the program's per-level champions, and the check.

A window runs whole ``sa_minimize`` solves back to back, each from its
own seed drawn from ``--seed``; the last solve started before the window
ran out finishes and counts whole.  The recorder wraps
``core.annealing.level_step`` and keeps each level's champion, the state
every chain restarts from (V2), as a reference to the program's own
tensors: no copy and no synchronisation, unless a state it would keep
holds more than one row's storage.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.reference import ladder_check

ROW_BYTES = 1 << 20


def solve_seed(seed: int, i: int) -> int:
    return int(np.random.default_rng([seed & (2**63 - 1), i, 31]).integers(0, 2**31 - 1))


def sa_config(cfg: dict, n_chains: int, seed: int, levels: int = None):
    from repro_torch.core.annealing import SAConfig
    T_min = cfg["T_min"] if levels is None else cfg["T0"] * cfg["rho"] ** (levels - 0.5)
    return SAConfig(T0=cfg["T0"], T_min=T_min, rho=cfg["rho"], N=cfg["N"],
                    n_chains=n_chains, exchange=cfg["exchange"], seed=seed,
                    dtype=cfg["dtype"], use_delta_eval=cfg["variant"] == "delta")


def objective(cfg: dict):
    from repro_torch import objectives
    return objectives.get(cfg["suite_id"])


def _row(t):
    """Row 0 of ``t``, copied only when it would pin a large storage."""
    r = t[0]
    return r if t.untyped_storage().nbytes() <= ROW_BYTES else r.clone()


class Recorder:
    """Wraps ``level_step``: each level's champion (value, state) and, with
    ``timed``, the host seconds of each call."""

    def __init__(self, timed: bool):
        from repro_torch.core import annealing
        self.mod = annealing
        self.orig = annealing.level_step
        self.timed = timed
        self.solves = []
        self.spans = []
        self.keep_spans = True

    def __enter__(self):
        self.mod.level_step = self._step
        return self

    def __exit__(self, *exc):
        self.mod.level_step = self.orig
        return False

    def begin(self):
        self.solves.append([])

    def _step(self, state, lvl, T, **kw):
        if self.timed:
            t0 = time.perf_counter()
            new = self.orig(state, lvl, T, **kw)
            if self.keep_spans:
                self.spans.append(time.perf_counter() - t0)
        else:
            new = self.orig(state, lvl, T, **kw)
        self.solves[-1].append((_row(new.fx), _row(new.x)))
        return new

    def champions(self, i: int):
        """(f (levels,), x (levels, dim)) numpy of solve ``i``."""
        rec = self.solves[i]
        f = torch.stack([r[0] for r in rec]).float().cpu().numpy()
        x = torch.stack([r[1] for r in rec]).float().cpu().numpy()
        return f, x


def window(run_solve, seconds: float, keep_going=None, traced_solve=None):
    """Solves back to back for ``seconds``.  ``run_solve(i)`` runs solve
    ``i``; ``keep_going(elapsed)`` decides after each (default: elapsed <
    seconds); ``traced_solve`` (i, context manager factory) profiles one
    solve.  Returns (number of solves, window seconds)."""
    t0 = time.perf_counter()
    i = 0
    while True:
        if traced_solve is not None and i == traced_solve[0]:
            with traced_solve[1]():
                run_solve(i)
        else:
            run_solve(i)
        i += 1
        elapsed = time.perf_counter() - t0
        go = keep_going(elapsed) if keep_going else elapsed < seconds
        if not go:
            return i, elapsed


def judge(cfg: dict, solves: list, n_chains: int, device, seed: int,
          extra_levels: int, levels: int, slices=None, gather=None):
    """The numbers of every solve (``ladder_check.judge_solve``), worst
    over solves, and ``level_count_gap``: how far a solve's count of
    levels is from ``levels``.  ``solves`` holds each solve's seed,
    champions, history and answer.  ``slices`` is this rank's chain
    range; ``gather(part)`` lists every rank's part in rank order (None:
    one rank).  Over ranks the best-so-far is each shard's own and the
    history the first shard's, so the history's start is the first
    slice's best start."""
    lo, hi = slices or (0, n_chains)
    worst = {"level_count_gap": 0.0}
    for s in solves:
        worst["level_count_gap"] = max(worst["level_count_gap"],
                                       float(abs(len(s["f"]) - levels)))
        checked = ladder_check.checked_levels(len(s["f"]), s["seed"], extra_levels)
        T = ladder_check.temperatures(cfg, len(s["f"]))

        def champion_of(L, x_in, s=s):
            if x_in is None:
                x_in = ladder_check.start_states(cfg, n_chains, s["seed"],
                                                 device, (lo, hi))
            else:
                x_in = torch.as_tensor(x_in, device=device)
            part = ladder_check.level_champion(cfg, x_in, L, float(T[L]),
                                               s["seed"], lo, hi)
            return ladder_check.combine(gather(part)) if gather else part

        init = ladder_check.start_best(cfg, n_chains, s["seed"], device, lo, hi)
        if gather:
            init = gather(init)[0]
        nums = ladder_check.judge_solve(cfg, s, checked, champion_of, init[0])
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
