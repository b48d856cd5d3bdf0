"""Plain PyTorch version of kernel B1, the Metropolis sweep.

Counterpart of ``repro.kernels.ref.metropolis_sweep_ref``: the same
recurrence as ``csrc/metropolis_sweep.cu`` (same counter-based draws from
``rng.draws3``, same accumulator math from ``objective_math``), vectorised
over all chains with no blocking.  The CPU tests run it against the JAX
package, and ``chip_smoke.py`` runs it on the card against the kernel.

Control inputs are scalars or per-chain ``(chains,)`` tensors: ``kid``,
``T``, ``seed``, ``step0``, the chain indices ``cidx`` and the ``live``
mask.  A Python-int ``kid`` computes one objective branch; a tensor ``kid``
computes every branch and selects per chain (bit-identical to the static
branch it selects).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import objective_math as om
from repro_torch.kernels import rng


def validate_kid(kid) -> None:
    """Reject out-of-range objective ids: runtime dispatch would otherwise
    fall through to kid 0 and silently anneal Schwefel."""
    t = torch.as_tensor(kid).reshape(-1)
    if t.numel() and bool(((t < 0) | (t >= om.N_KIDS)).any()):
        raise ValueError(
            f"objective id(s) {t.tolist()} outside the kernel registry "
            f"[0, {om.N_KIDS})")


def _col(v, chains: int, dtype, device):
    """Scalar or (chains,) input -> (chains, 1) column."""
    if dtype is torch.int64:  # uint32 counters
        a = rng.as_u32(v, device).reshape(-1)
    else:
        a = torch.as_tensor(v, device=device).to(dtype).reshape(-1)
    if a.shape[0] == 1:
        a = a.expand(chains)
    return a[:, None]


def proposal(lo, width, uval):
    """``lo + uval * width`` rounded once, as a fused multiply-add.

    XLA contracts the reference's ``lo + u * (hi - lo)`` into an FMA
    (measured on the CPU backend), and the kernel calls ``__fmaf_rn``.  In
    float64 the product is exact (24 by 24 significant bits), and for the
    registry boxes, where |lo| <= hi - lo, the sum needs at most 49 bits
    and is exact too; the one rounding to float32 is then the FMA's."""
    lo64 = torch.as_tensor(lo, dtype=torch.float64, device=uval.device)
    w64 = torch.as_tensor(width, dtype=torch.float64, device=uval.device)
    return (lo64 + uval.to(torch.float64) * w64).to(torch.float32)


def accept(uacc, f0, f1, T):
    """Metropolis test ``u <= exp(clip(-(f1 - f0) / T, -80, 80))``."""
    return uacc <= torch.exp(torch.clamp(-(f1 - f0) / T, -80.0, 80.0))


def metropolis_sweep_ref(x, T, seed, step0, *, kid, n_steps: int,
                         variant: str = "delta", cidx=None, live=None):
    """Run ``n_steps`` Metropolis steps for every chain of ``x``
    ``(chains, dim)`` float32.  Returns (x_out (chains, dim), f_out
    (chains,)); ``f_out`` is the carried value of the final state."""
    validate_kid(kid)
    if variant not in ("delta", "full"):
        raise ValueError(f"variant must be 'delta' or 'full', not {variant!r}")
    chains, dim = x.shape
    dev = x.device
    if isinstance(kid, int) or (not isinstance(kid, torch.Tensor)
                                and torch.as_tensor(kid).ndim == 0):
        k = int(kid)
        lo, hi, width = om.box_f32(k)
        fns = (om.init_acc, om.combine, om.term, om.full_eval)
    else:
        k = _col(kid, chains, torch.int32, dev)
        lo, hi, width = om.box_rt(k, dtype=x.dtype)
        fns = (om.init_acc_rt, om.combine_rt, om.term_rt, om.full_eval_rt)
    init_acc, combine, term, full_eval = fns

    if cidx is None:
        cidx = torch.arange(chains, device=dev)[:, None]
    else:
        cidx = _col(cidx, chains, torch.int64, dev)
    seed = _col(seed, chains, torch.int64, dev)
    step0 = _col(step0, chains, torch.int64, dev)
    T = _col(T, chains, x.dtype, dev)
    # A dead chain's accepts are all masked off: its state passes through.
    live = None if live is None else _col(live, chains, torch.bool, dev)

    # Every step's draws at once, (chains, n_steps): the same counters as
    # step-by-step draws, in far fewer tensor ops.
    steps = torch.arange(n_steps, device=dev)[None, :]
    rbits, uval, uacc_all = rng.draws3(seed, cidx, (step0 + steps) & rng.MASK32)
    d_all = rbits % dim
    newval_all = proposal(lo, width, uval)

    def draws(i):
        return d_all[:, i:i + 1], newval_all[:, i:i + 1], uacc_all[:, i:i + 1]

    def masked(acc):
        return acc if live is None else acc & live

    x = x.clone()
    if variant == "delta":
        S, logP, sgnP = init_acc(k, x)
        fx = combine(k, S, logP, sgnP, dim)
        for i in range(n_steps):
            d, newval, uacc = draws(i)
            xi_old = x.gather(1, d)
            df = d.to(x.dtype)
            s_old, p_old = term(k, xi_old, df)
            s_new, p_new = term(k, newval, df)
            S1 = S - s_old + s_new
            logP1 = (logP
                     - torch.log(torch.clamp(torch.abs(p_old), min=om.TINY))
                     + torch.log(torch.clamp(torch.abs(p_new), min=om.TINY)))
            sg = torch.where(p_old < 0, -1.0, 1.0) * torch.where(p_new < 0, -1.0, 1.0)
            sgnP1 = sgnP * sg.to(sgnP.dtype)
            f1 = combine(k, S1, logP1, sgnP1, dim)
            acc = masked(accept(uacc, fx, f1, T))
            x.scatter_(1, d, torch.where(acc, newval, xi_old))
            fx = torch.where(acc, f1, fx)
            S = torch.where(acc, S1, S)
            logP = torch.where(acc, logP1, logP)
            sgnP = torch.where(acc, sgnP1, sgnP)
    else:  # full: paper-faithful O(dim) evaluation per step
        fx = full_eval(k, x, dim)
        for i in range(n_steps):
            d, newval, uacc = draws(i)
            x1 = x.scatter(1, d, newval)
            f1 = full_eval(k, x1, dim)
            acc = masked(accept(uacc, fx, f1, T))
            x = torch.where(acc, x1, x)
            fx = torch.where(acc, f1, fx)
    return x, fx[:, 0]
