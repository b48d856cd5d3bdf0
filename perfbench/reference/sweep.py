"""One temperature level of the Metropolis walk, for every chain at once:
the full sweep of Schwefel (the ladder cells), then the V2 champion.

Step ``s`` of chain ``c`` draws ``threefry.step_draws(seed, c, step0 +
s)``: coordinate ``d = bits % dim``, the proposal ``lo + u_value *
width`` rounded once, and the accept uniform ``u``.  A proposal with
value change ``df`` is taken when ``u <= exp(clip(-df / T, -80, 80))``.
"""
from __future__ import annotations

import torch

from perfbench.reference import objectives as ob
from perfbench.reference.threefry import step_draws


def proposal(lo: float, width: float, uval, dtype):
    """``lo + uval * width`` rounded once: exact in float64 for these
    boxes (a 24-bit uniform times a float32 width, plus lo)."""
    return (lo + uval.to(torch.float64) * width).to(dtype)


def accepts(uacc, df, T):
    return uacc.to(df.dtype) <= torch.exp(torch.clamp(-df / T, -80.0, 80.0))


def level_draws(seed: int, step0: int, n_steps: int, cidx):
    """Every step's draws of a level at once, each (chains, n_steps): the
    same counters as step by step, in far fewer tensor operations."""
    steps = (step0 + torch.arange(n_steps, device=cidx.device))[None, :]
    return step_draws(seed, cidx[:, None], steps)


def champion(f):
    """(first index of the least value, that value) of ``f`` (chains,)."""
    m = torch.min(f)
    i = int(torch.nonzero(f == m)[0, 0])
    return i, m


def full_level(x, T: float, seed: int, step0: int, n_steps: int, cidx,
               dtype=torch.float32):
    """The full sweep of Schwefel states ``x`` (chains, dim) at ``T``:
    each step's value is the whole sum in the full order
    (``objectives.full_value``), the changed lane refolded and the tree
    above it summed again.  Returns (x_out, f_out)."""
    name = "schwefel"
    lo, width = ob.box32(name)
    x = x.to(dtype).clone()
    n, dim = x.shape
    t = ob.terms(name, x, None)[0]
    lanes = ob.lane_partials(t)
    f = -ob.tree_total(lanes) / float(dim)
    k_max = -(-dim // ob.LANES)
    kk = torch.arange(k_max, device=x.device)
    Tt = torch.tensor(T, dtype=dtype, device=x.device)
    rows = torch.arange(n, device=x.device)
    bits_all, uval_all, uacc_all = level_draws(seed, step0, n_steps, cidx)
    for s in range(n_steps):
        bits, uval, uacc = bits_all[:, s], uval_all[:, s], uacc_all[:, s]
        d = bits % dim
        newval = proposal(lo, width, uval, dtype)
        tn = ob.terms(name, newval, None)[0]
        o, k = d % ob.LANES, d // ob.LANES
        coords = o[:, None] + ob.LANES * kk[None, :]
        valid = coords < dim
        lane = torch.where(valid, t.gather(1, coords.clamp(max=dim - 1)), 0.0)
        lane = torch.where(kk[None, :] == k[:, None], tn[:, None], lane)
        a = torch.zeros_like(tn)
        for j in range(k_max):
            a = torch.where(valid[:, j], a + lane[:, j], a)
        cand = lanes.clone()
        cand[rows, o] = a
        f1 = -ob.tree_total(cand) / float(dim)
        acc = accepts(uacc, f1 - f, Tt)
        take = rows[acc]
        dt = d[acc]
        t[take, dt] = tn[acc]
        x[take, dt] = newval[acc]
        lanes[take, o[acc]] = a[acc]
        f = torch.where(acc, f1, f)
    return x, f
