"""Schwefel, the objective the ladder cells run, as per-coordinate terms,
and the summation order the card's full sweep defines its value by.

Term of coordinate ``i`` with value ``x``: ``x sin(sqrt|x|)``; the value
is ``f = -S / n`` over the ``n`` terms' sum ``S``.

Sums are float32 and rounded at every add, so a value is defined with
its order.  The full sweep's order (``full_value``): 32 lane partials,
lane ``l`` folding coordinates ``l, l + 32, ...`` from 0, then a halving
tree (lane ``l`` plus lane ``l + 16``, and so on).
"""
from __future__ import annotations

import numpy as np
import torch

BOX = {"schwefel": (-512.0, 512.0)}
LANES = 32


def box32(name: str):
    """(lo, width) rounded to float32, width = float32(hi) - float32(lo)."""
    lo, hi = (np.float32(v) for v in BOX[name])
    return float(lo), float(hi - lo)


def terms(name: str, x, coord):
    """(s0, None, None): the terms of values ``x`` (any float dtype)."""
    if name == "schwefel":
        return x * torch.sin(torch.sqrt(torch.abs(x))), None, None
    raise ValueError(f"unknown objective {name!r}")


def tree_total(partials):
    """The halving tree over the last axis of 32 lane partials."""
    v = partials
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def lane_partials(t):
    """(chains, 32) lane partials of per-coordinate terms ``t`` (chains,
    dim): lane ``l`` folds coordinates ``l, l + 32, ...`` in order."""
    n, dim = t.shape
    k = -(-dim // LANES)
    pad = t.new_zeros((n, k * LANES))
    pad[:, :dim] = t
    v = pad.view(n, k, LANES)
    acc = t.new_zeros((n, LANES))
    for j in range(k):
        acc = acc + v[:, j]
    return acc


def full_value(name: str, x):
    """The full sweep's value of states ``x`` (chains, dim), in its order;
    only Schwefel, the objective the ladder cells run, is needed here."""
    if name != "schwefel":
        raise ValueError("full_value covers schwefel only")
    s0, _, _ = terms(name, x, None)
    return -tree_total(lane_partials(s0)) / float(x.shape[1])


def value64(name: str, x) -> np.ndarray:
    """Float64 value of states ``x`` (numpy (chains, dim)), the plain
    formula; a scale for relative gaps."""
    if name != "schwefel":
        raise ValueError(f"unknown objective {name!r}")
    x = np.asarray(x, np.float64)
    return -(x * np.sin(np.sqrt(np.abs(x)))).sum(-1) / x.shape[-1]
