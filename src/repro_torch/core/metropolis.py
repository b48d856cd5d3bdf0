"""Plain PyTorch Metropolis sweeps for any objective, the counterpart of
``repro.core.metropolis``.

A sweep runs ``n_steps`` Metropolis iterations at a fixed temperature for
a batch of chains ``x`` (chains, dim), one tensor op per stage of a step
over every chain.  It serves what kernel B1 does not: objectives without
a ``kernel_id`` and float64 chains (the reference's float64 never reaches
a Pallas kernel either).  It needs no kernel of its own: it is the
reference's jnp code, which runs outside any Pallas kernel.

* :func:`sweep_full`: every proposal evaluates ``objective(x)``, O(dim)
  per step (paper-faithful).
* :func:`sweep_delta`: O(1) per step through ``objective.decomposable``,
  with the accumulators refreshed at sweep entry.

Draws are B1's counter-based ones: step ``step0 + i`` of chain ``cidx``
under ``seed`` (``rng.draws3``, or ``rng.draws3_f64`` with 53-bit uniforms
for float64).  In float32 the proposal and accept test are those of
``kernels/ref.py``, so on a registry objective whose ``fn`` rounds as
``objective_math.full_eval`` does, :func:`sweep_full` equals B1's plain
``full`` sweep bit for bit.  ``T`` is a scalar or one temperature per
chain.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import rng

#: The chains' dtypes, by ``SAConfig.dtype`` name.
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _step_draws(objective, x, seed, step0, n_steps: int, cidx):
    """Every step's draws at once, (chains, n_steps) each: coordinate,
    proposed value and accept uniform, in x's dtype."""
    if x.dtype not in DTYPES.values():
        raise TypeError(f"sweeps take float32 or float64 chains, not {x.dtype}")
    chains, dim = x.shape
    dev = x.device
    if cidx is None:
        cidx = torch.arange(chains, device=dev)
    col = [rng.as_u32(v, dev).reshape(-1, 1) for v in (seed, cidx, step0)]
    steps = (col[2] + torch.arange(n_steps, device=dev)[None, :]) & rng.MASK32
    draws = rng.draws3_f64 if x.dtype == torch.float64 else rng.draws3
    rbits, uval, uacc = draws(col[0], col[1], steps)
    d = rbits % dim
    lo, hi = objective.bounds(dev, x.dtype)
    width = hi - lo
    if x.dtype == torch.float32:
        newval = ref.proposal(lo[d], width[d], uval)
    else:
        newval = lo[d] + uval * width[d]
    return d, newval, uacc


def _temperature(T, x):
    """A scalar stays a Python number; per-chain T becomes a (chains,)
    tensor of x's dtype."""
    if isinstance(T, torch.Tensor) or hasattr(T, "__len__"):
        t = torch.as_tensor(T, device=x.device).to(x.dtype).reshape(-1)
        return t if t.numel() > 1 else float(t[0])
    return float(T)


def sweep_full(x, fx, T, seed, step0, *, objective, n_steps: int, cidx=None):
    """Paper-faithful Metropolis sweep with full objective evaluation.

    ``x`` (chains, dim) float32 or float64, ``fx`` its carried values
    (chains,).  Returns (x, fx) after ``n_steps`` steps."""
    d_all, newval_all, uacc_all = _step_draws(objective, x, seed, step0,
                                              n_steps, cidx)
    T = _temperature(T, x)
    for i in range(n_steps):
        x1 = x.scatter(1, d_all[:, i:i + 1], newval_all[:, i:i + 1])
        f1 = objective(x1)
        acc = ref.accept(uacc_all[:, i], fx, f1, T)
        x = torch.where(acc[:, None], x1, x)
        fx = torch.where(acc, f1, fx)
    return x, fx


def sweep_delta(x, T, seed, step0, *, objective, n_steps: int, cidx=None):
    """O(1)-per-step sweep for decomposable objectives.  The accumulators,
    and from them f, are recomputed exactly at entry, so incremental drift
    is bounded by one temperature level.  Returns (x, fx)."""
    spec = objective.decomposable
    assert spec is not None, f"{objective.name} has no decomposable structure"
    d_all, newval_all, uacc_all = _step_draws(objective, x, seed, step0,
                                              n_steps, cidx)
    T = _temperature(T, x)
    dim = x.shape[1]
    x = x.clone()
    S, (logP, sgnP) = spec.init_acc(x)
    fx = spec.value(S, (logP, sgnP), dim)
    for i in range(n_steps):
        d = d_all[:, i]
        newval = newval_all[:, i]
        xi_old = x.gather(1, d[:, None])[:, 0]
        s_old, p_old = spec.terms(xi_old, d)
        s_new, p_new = spec.terms(newval, d)
        S1 = S - s_old + s_new
        la_old = torch.log(torch.clamp(torch.abs(p_old), min=1e-30))
        la_new = torch.log(torch.clamp(torch.abs(p_new), min=1e-30))
        logP1 = logP - la_old + la_new
        sg = (torch.where(p_old < 0, -1.0, 1.0)
              * torch.where(p_new < 0, -1.0, 1.0))
        sgnP1 = sgnP * sg.to(sgnP.dtype)
        f1 = spec.value(S1, (logP1, sgnP1), dim)
        acc = ref.accept(uacc_all[:, i], fx, f1, T)
        x.scatter_(1, d[:, None], torch.where(acc, newval, xi_old)[:, None])
        fx = torch.where(acc, f1, fx)
        accc = acc[:, None]
        S = torch.where(accc, S1, S)
        logP = torch.where(accc, logP1, logP)
        sgnP = torch.where(accc, sgnP1, sgnP)
    return x, fx
