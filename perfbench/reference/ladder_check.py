"""The comparison that decides ``correct`` in the ladder cells.

A V2 solve restarts every chain from the champion after each level, so
the state a level starts from is the previous level's champion on every
chain (level 0: the uniform start, ``torch.rand`` from a generator on the
card seeded with the solve's seed, mapped to ``lo + u * (hi - lo)``).
The check follows the program level by level from its own champions:

* ``level_f_gap``, ``level_x_gap``: for each checked level the reference
  sweeps every chain of the cell from the program's previous champion
  (or the start) and takes its champion; the gap of the values over
  ``max(1, |f|)`` and the widest coordinate gap over the box width.
* ``level_count_gap``: how many levels a solve ran more or fewer than
  its ladder has (exact: limit 0).
* ``answer_f_gap``: the returned value against the reference's value of
  the returned state, and the program's history against the best-so-far
  over its champions (from the reference's value of the best starting
  chain; over ranks, of the first slice's, whose history the program
  returns), the widest over ``max(1, |f|)``.

``chain_lo``/``chain_hi`` cut the chains into the slice one rank holds;
the caller combines the slices' champions (``combine``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import objectives as ob
from perfbench.reference import sweep

BLOCK = 1 << 18     # chains swept at a time, so the reference fits


def n_levels(cfg: dict) -> int:
    """Levels of the configuration's ladder: the paper's do/while loop,
    cooling by ``rho`` from ``T0`` until the temperature is under
    ``T_min``."""
    return max(1, int(math.ceil(math.log(cfg["T_min"] / cfg["T0"])
                                / math.log(cfg["rho"]))))


def temperatures(cfg: dict, levels: int) -> np.ndarray:
    k = np.arange(levels)
    return (cfg["T0"] * cfg["rho"] ** k).astype(np.float32)


def start_states(cfg: dict, n_chains: int, seed: int, device, lo_hi=None):
    """The uniform start of all ``n_chains`` chains, rows ``lo_hi``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dim = cfg["dim"]
    lo = torch.full((dim,), cfg["box"][0], dtype=torch.float32, device=device)
    hi = torch.full((dim,), cfg["box"][1], dtype=torch.float32, device=device)
    u = torch.rand((n_chains, dim), generator=gen, device=device,
                   dtype=torch.float32)
    x = lo + u * (hi - lo)
    if lo_hi is not None:
        x = x[lo_hi[0]:lo_hi[1]]
    return x


def level_champion(cfg: dict, x_in, L: int, T: float, seed: int,
                   chain_lo: int, chain_hi: int, dtype=torch.float32):
    """Champion (global chain index, value, state) of level ``L`` over
    chains ``[chain_lo, chain_hi)`` from ``x_in``: a (dim,) state shared by
    every chain, or the (chain_hi - chain_lo, dim) start."""
    dev = x_in.device
    best = None
    for a in range(chain_lo, chain_hi, BLOCK):
        b = min(a + BLOCK, chain_hi)
        xb = (x_in.expand(b - a, -1) if x_in.ndim == 1
              else x_in[a - chain_lo:b - chain_lo])
        cidx = torch.arange(a, b, device=dev, dtype=torch.int64)
        xo, fo = sweep.full_level(xb, T, seed, L * cfg["N"], cfg["N"], cidx,
                                  dtype)
        i, f = sweep.champion(fo)
        if best is None or float(f) < best[1]:
            best = (a + i, float(f), xo[i].float().cpu().numpy())
        del xo, fo
    return best


def combine(parts):
    """The first champion over slices given in chain order."""
    best = None
    for p in parts:
        if best is None or p[1] < best[1]:
            best = p
    return best


def start_best(cfg, n_chains, seed, device, chain_lo, chain_hi):
    """(value, state) of the best starting chain among the slice, by the
    full sweep's value."""
    x0 = start_states(cfg, n_chains, seed, device, (chain_lo, chain_hi))
    best = None
    for a in range(0, x0.shape[0], BLOCK):
        f = ob.full_value("schwefel", x0[a:a + BLOCK])
        i, v = sweep.champion(f)
        if best is None or float(v) < best[0]:
            best = (float(v), x0[a + i].cpu().numpy())
    return best


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def judge_solve(cfg: dict, rec: dict, levels_to_check, champion_of,
                init_best) -> dict:
    """Numbers of one solve.  ``rec`` holds the program's champions per
    level (``f`` (levels,), ``x`` (levels, dim) numpy), its history and
    its answer (``f_best``, ``x_best``).  ``champion_of(L, x_in)`` gives
    the reference's champion of level ``L`` (from all slices);
    ``init_best`` the reference's best start value."""
    width = cfg["box"][1] - cfg["box"][0]
    f_gap = x_gap = 0.0
    for L in levels_to_check:
        x_in = None if L == 0 else rec["x"][L - 1]
        _, f_r, x_r = champion_of(L, x_in)
        f_gap = max(f_gap, rel(rec["f"][L], f_r))
        x_gap = max(x_gap, float(np.max(np.abs(rec["x"][L] - x_r))) / width)
    best = init_best
    b_gap = 0.0
    for L, f in enumerate(rec["f"]):
        best = min(best, float(f))
        b_gap = max(b_gap, rel(rec["history"][L], best))
    xa = torch.as_tensor(np.asarray(rec["x_best"], np.float32))[None]
    a_gap = rel(rec["f_best"], float(ob.full_value("schwefel", xa)[0]))
    return {"level_f_gap": f_gap, "level_x_gap": x_gap,
            "answer_f_gap": max(a_gap, b_gap)}


def checked_levels(n_levels: int, seed: int, extra: int):
    """Level 0, the last level and ``extra`` others drawn from ``seed``."""
    rng = np.random.default_rng([seed, 7919])
    mid = rng.choice(np.arange(1, n_levels - 1), size=min(extra, max(0, n_levels - 2)),
                     replace=False) if n_levels > 2 else []
    return sorted({0, n_levels - 1, *[int(v) for v in mid]})
