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


# ------------------------------------------------------------------- QAP
def _per_chain_mat(M, chains: int, n: int, device):
    """(n, n) or (chains, n, n) float32 matrix -> a (chains, n, n) view."""
    M = torch.as_tensor(M, dtype=torch.float32, device=device)
    return M.expand(chains, n, n) if M.ndim == 2 else M


def qap_full_cost(p, F, D):
    """QAP cost ``sum_{u,v} F[u,v] * D[p[u],p[v]]`` of each chain.

    ``p`` is (chains, n) int; ``F``/``D`` are (n, n) or per-chain
    (chains, n, n) float32 with integer entries.  Returns (chains,)
    float32.  Every term and partial sum is an integer below 2^24, so the
    sum is exact in any order: it equals the kernel's, the JAX package's
    one-hot form and the host's int64 ``QAPInstance.cost`` bit for bit.
    """
    chains, n = p.shape
    p = p.long()
    F = _per_chain_mat(F, chains, n, p.device)
    D = _per_chain_mat(D, chains, n, p.device)
    rows = D.gather(1, p[:, :, None].expand(chains, n, n))    # D[p[u], v]
    DP = rows.gather(2, p[:, None, :].expand(chains, n, n))   # D[p[u], p[v]]
    return (F * DP).sum(dim=(1, 2))


def qap_sweep_ref(p, F, D, T, seed, step0, *, n_steps: int, cidx=None,
                  live=None):
    """Plain version of kernel B3: ``n_steps`` pairwise-exchange Metropolis
    moves on every chain's permutation, counterpart of
    ``repro.kernels.ref.qap_sweep_ref``.

    Per step, from one ``rng.draws3`` triple: facility ``i`` from the raw
    bits (mod n), facility ``j = min(floor(u_value * n), n - 1)``, and the
    accept uniform.  Swapping the locations ``a = p[i]``, ``b = p[j]``
    changes the cost by the O(n) asymmetric delta

      sum_{k != i,j} (F[i,k]-F[j,k]) (D[b,p[k]]-D[a,p[k]])
                   + (F[k,i]-F[k,j]) (D[p[k],b]-D[p[k],a])
      + (F[i,i]-F[j,j]) (D[b,b]-D[a,a]) + (F[i,j]-F[j,i]) (D[b,a]-D[a,b])

    ``i == j`` proposes the identity (delta 0, always accepted).  Entries
    are gathered by index, not by one-hot products; both sum the same
    integer-valued float32 terms, so the result is the same.

    ``F``/``D`` are (n, n) or per-chain (chains, n, n); ``T``, ``seed``,
    ``step0``, ``cidx`` and ``live`` are scalars or (chains,).  A dead
    chain's moves are all rejected.  Returns (p_out (chains, n) int32,
    f_out (chains,) float32).
    """
    chains, n = p.shape
    dev = p.device
    F = _per_chain_mat(F, chains, n, dev)
    D = _per_chain_mat(D, chains, n, dev)
    FT, DT = F.transpose(1, 2), D.transpose(1, 2)
    fx = qap_full_cost(p, F, D)[:, None]
    if cidx is None:
        cidx = torch.arange(chains, device=dev)[:, None]
    else:
        cidx = _col(cidx, chains, torch.int64, dev)
    seed = _col(seed, chains, torch.int64, dev)
    step0 = _col(step0, chains, torch.int64, dev)
    T = _col(T, chains, torch.float32, dev)
    live = None if live is None else _col(live, chains, torch.bool, dev)

    steps = torch.arange(n_steps, device=dev)[None, :]
    rbits, uval, uacc_all = rng.draws3(seed, cidx, (step0 + steps) & rng.MASK32)
    i_all = rbits % n
    j_all = torch.clamp((uval * n).to(torch.int64), max=n - 1)
    locs = torch.arange(n, device=dev)[None, :]

    def row(M, r):  # M[c, r[c], :] for each chain c -> (chains, n)
        return M.gather(1, r[:, :, None].expand(chains, 1, n))[:, 0]

    def at(R, k):   # R[c, k[c]] -> (chains, 1)
        return R.gather(1, k)

    p = p.to(torch.int64)
    for s in range(n_steps):
        i, j = i_all[:, s:s + 1], j_all[:, s:s + 1]
        a, b = at(p, i), at(p, j)
        Fi, Fj, FiT, FjT = row(F, i), row(F, j), row(FT, i), row(FT, j)
        Da, Db, DaT, DbT = row(D, a), row(D, b), row(DT, a), row(DT, b)
        kmask = (locs != i) & (locs != j)
        t1 = torch.where(kmask, (Fi - Fj) * (Db.gather(1, p) - Da.gather(1, p)), 0.0)
        t2 = torch.where(kmask, (FiT - FjT) * (DbT.gather(1, p) - DaT.gather(1, p)), 0.0)
        diag = (at(Fi, i) - at(Fj, j)) * (at(Db, b) - at(Da, a))
        cross = (at(Fi, j) - at(Fj, i)) * (at(Db, a) - at(Da, b))
        delta = t1.sum(1, keepdim=True) + t2.sum(1, keepdim=True) + diag + cross
        acc = accept(uacc_all[:, s:s + 1], 0.0, delta, T)
        if live is not None:
            acc = acc & live
        swapped = torch.where(locs == i, b, torch.where(locs == j, a, p))
        p = torch.where(acc, swapped, p)
        fx = torch.where(acc, fx + delta, fx)
    return p.to(torch.int32), fx[:, 0]
