"""Box-constrained Nelder–Mead simplex minimizer in PyTorch, the
counterpart of ``repro.core.neldermead``.

Standard coefficients (reflection 1, expansion 2, contraction 0.5, shrink
0.5) with candidate points clipped to the box, and the reference's
branchless update: every iteration evaluates reflection, expansion,
contraction and the shrunk simplex, then selects.  The loop runs on the
device; an iteration after convergence leaves the simplex as it is, so the
host checks the stopping rule only every ``CHECK_EVERY`` iterations and the
result is the reference's loop exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device

# Iterations run on the device between two host checks of the stopping rule.
CHECK_EVERY = 32


@dataclasses.dataclass
class NMResult:
    x_best: np.ndarray
    f_best: float
    n_iters: int
    converged: bool


def _order(simplex, fvals):
    idx = torch.argsort(fvals, stable=True)
    return simplex[idx], fvals[idx]


def _spreads(simplex, fvals):
    return fvals[-1] - fvals[0], torch.max(torch.abs(simplex[1:] - simplex[0]))


def nelder_mead(objective, x0, max_iters: int = 4000, fatol: float = 1e-10,
                xatol: float = 1e-10, *, device=None) -> NMResult:
    """Minimize ``objective`` (an ``Objective``) starting from ``x0``."""
    dev = resolve_device(device)
    fn = objective.fn
    x0 = torch.as_tensor(np.asarray(x0), device=dev)
    lo, hi = objective.bounds(dev, x0.dtype)
    step = 0.05 * (hi - lo)
    simplex = torch.cat(
        [x0[None, :], torch.clamp(x0[None, :] + torch.diag(step), lo, hi)])
    fvals = fn(simplex)
    simplex, fvals = _order(simplex, fvals)
    it = torch.zeros((), dtype=torch.int32, device=dev)

    def active():
        fs, xs = _spreads(simplex, fvals)
        return (it < max_iters) & ((fs > fatol) | (xs > xatol))

    n_done = 0
    while n_done < max_iters and bool(active()):
        for _ in range(min(CHECK_EVERY, max_iters - n_done)):
            go = active()
            c = simplex[:-1].mean(0)  # centroid of the best n
            worst = simplex[-1]
            f_best, f_second, f_worst = fvals[0], fvals[-2], fvals[-1]

            xr = torch.clamp(c + (c - worst), lo, hi)  # reflection
            xe = torch.clamp(c + 2.0 * (c - worst), lo, hi)  # expansion
            xc = torch.clamp(c + 0.5 * (worst - c), lo, hi)  # contraction
            fr, fe, fc = fn(torch.stack([xr, xe, xc]))

            do_expand = fr < f_best
            take_e = do_expand & (fe < fr)
            new_pt_er = torch.where(take_e, xe, xr)
            new_f_er = torch.where(take_e, fe, fr)
            use_reflect_like = fr < f_second
            do_contract = (~use_reflect_like) & (fc < f_worst)
            accept_point = use_reflect_like | do_contract
            new_pt = torch.where(use_reflect_like, new_pt_er, xc)
            new_f = torch.where(use_reflect_like, new_f_er, fc)

            simplex_acc = torch.cat([simplex[:-1], new_pt[None]])
            fvals_acc = torch.cat([fvals[:-1], new_f[None]])
            # Shrink toward the best vertex when nothing was accepted.
            shrunk = torch.clamp(simplex[0][None, :] + 0.5 * (simplex - simplex[0]),
                                 lo, hi)
            fshrunk = fn(shrunk)
            s_new = torch.where(accept_point, simplex_acc, shrunk)
            f_new = torch.where(accept_point, fvals_acc, fshrunk)
            s_new, f_new = _order(s_new, f_new)
            simplex = torch.where(go, s_new, simplex)
            fvals = torch.where(go, f_new, fvals)
            it = it + go.to(it.dtype)
        n_done += CHECK_EVERY
    fs, xs = _spreads(simplex, fvals)
    converged = bool((fs <= fatol) & (xs <= xatol))
    return NMResult(x_best=simplex[0].cpu().numpy(), f_best=float(fvals[0]),
                    n_iters=int(it), converged=converged)
