"""Per-objective math of the sweep kernel, plain PyTorch.

The counterpart of ``repro.kernels.objective_math`` and of
``csrc/objective_math.cuh``: the same six registry objectives (``kid``),
the same box, and the same accumulator layout:

  S    : (..., 2)  sum accumulators
  logP : (..., 1)  log-magnitude of the product accumulator
  sgnP : (..., 1)  sign (+-1) of the product accumulator

Static forms (``full_eval``, ``term``, ``init_acc``, ``combine``) take a
Python-int ``kid``.  Runtime forms (``*_rt``, ``box_rt``) take a per-chain
int tensor: every branch is computed and one is selected with
``torch.where``, which returns the branch value verbatim, so a runtime
form is bit-identical to the static form of the selected kid.
"""
from __future__ import annotations

import numpy as np
import torch

KID_SCHWEFEL = 0
KID_RASTRIGIN = 1
KID_ACKLEY = 2
KID_GRIEWANK = 3
KID_EXPONENTIAL = 4
KID_SALOMON = 5

KID_BY_NAME = {
    "schwefel": KID_SCHWEFEL,
    "rastrigin": KID_RASTRIGIN,
    "ackley": KID_ACKLEY,
    "griewank": KID_GRIEWANK,
    "exponential": KID_EXPONENTIAL,
    "salomon": KID_SALOMON,
}
# Uniform box per registry objective.
BOX = {
    KID_SCHWEFEL: (-512.0, 512.0),
    KID_RASTRIGIN: (-5.12, 5.12),
    KID_ACKLEY: (-30.0, 30.0),
    KID_GRIEWANK: (-600.0, 600.0),
    KID_EXPONENTIAL: (-1.0, 1.0),
    KID_SALOMON: (-100.0, 100.0),
}
N_KIDS = len(KID_BY_NAME)

# float32 constants, as the reference's np.float32 ones.
_TWO_PI = float(np.float32(2) * np.float32(np.pi))
_E = float(np.float32(np.e))
TINY = float(np.float32(1e-30))


def box_f32(kid: int) -> tuple[float, float, float]:
    """(lo, hi, hi - lo) of a kid's box, each rounded to float32."""
    lo, hi = np.float32(BOX[kid][0]), np.float32(BOX[kid][1])
    return float(lo), float(hi), float(hi - lo)


def _coord_index(x):
    return torch.arange(x.shape[-1], device=x.device).to(x.dtype)


def full_eval(kid: int, x, dim: int):
    """Full objective evaluation; x: (..., dim) -> (..., 1)."""
    if kid == KID_SCHWEFEL:
        return -(x * torch.sin(torch.sqrt(torch.abs(x)))).sum(-1, keepdim=True) / dim
    if kid == KID_RASTRIGIN:
        return 10.0 * dim + (x * x - 10.0 * torch.cos(_TWO_PI * x)).sum(-1, keepdim=True)
    if kid == KID_ACKLEY:
        s1 = (x * x).sum(-1, keepdim=True)
        s2 = torch.cos(_TWO_PI * x).sum(-1, keepdim=True)
        return (-20.0 * torch.exp(-0.2 * torch.sqrt(s1 / dim))
                - torch.exp(s2 / dim) + 20.0 + _E)
    if kid == KID_GRIEWANK:
        i = _coord_index(x)
        s = (x * x).sum(-1, keepdim=True) / 4000.0
        p = torch.cos(x / torch.sqrt(i + 1.0)).prod(-1, keepdim=True)
        return 1.0 + s - p
    if kid == KID_EXPONENTIAL:
        return -torch.exp(-0.5 * (x * x).sum(-1, keepdim=True))
    if kid == KID_SALOMON:
        r = torch.sqrt((x * x).sum(-1, keepdim=True))
        return 1.0 - torch.cos(_TWO_PI * r) + 0.1 * r
    raise ValueError(f"unknown kernel objective id {kid}")


def term(kid: int, xi, d):
    """Per-coordinate contributions. xi, d: (..., 1) float.
    Returns (s (..., 2), p (..., 1))."""
    z = torch.zeros_like(xi)
    one = torch.ones_like(xi)
    if kid == KID_SCHWEFEL:
        return torch.cat([xi * torch.sin(torch.sqrt(torch.abs(xi))), z], -1), one
    if kid == KID_RASTRIGIN:
        return torch.cat([xi * xi - 10.0 * torch.cos(_TWO_PI * xi), z], -1), one
    if kid == KID_ACKLEY:
        return torch.cat([xi * xi, torch.cos(_TWO_PI * xi)], -1), one
    if kid == KID_GRIEWANK:
        s = torch.cat([xi * xi / 4000.0, z], -1)
        return s, torch.cos(xi / torch.sqrt(d.to(xi.dtype) + 1.0))
    if kid in (KID_EXPONENTIAL, KID_SALOMON):
        # Both reduce to the radial sum S0 = sum x_i^2; combine() does the rest.
        return torch.cat([xi * xi, z], -1), one
    raise ValueError(f"unknown kernel objective id {kid}")


def init_acc(kid: int, x):
    """Exact O(dim) accumulator init from the states x: (..., dim)."""
    d = _coord_index(x).expand(x.shape)
    s, p = term(kid, x[..., None], d[..., None])  # (..., dim, 2), (..., dim, 1)
    S = s.sum(-2)
    logP = torch.log(torch.clamp(torch.abs(p), min=TINY)).sum(-2)
    sgnP = torch.where(p < 0, -1.0, 1.0).to(x.dtype).prod(-2)
    return S, logP, sgnP


def combine(kid: int, S, logP, sgnP, dim: int):
    """Accumulators -> objective value (..., 1)."""
    if kid == KID_SCHWEFEL:
        return -S[..., 0:1] / dim
    if kid == KID_RASTRIGIN:
        return 10.0 * dim + S[..., 0:1]
    if kid == KID_ACKLEY:
        return (-20.0 * torch.exp(-0.2 * torch.sqrt(S[..., 0:1] / dim))
                - torch.exp(S[..., 1:2] / dim) + 20.0 + _E)
    if kid == KID_GRIEWANK:
        return 1.0 + S[..., 0:1] - sgnP * torch.exp(logP)
    if kid == KID_EXPONENTIAL:
        return -torch.exp(-0.5 * S[..., 0:1])
    if kid == KID_SALOMON:
        r = torch.sqrt(S[..., 0:1])
        return 1.0 - torch.cos(_TWO_PI * r) + 0.1 * r
    raise ValueError(f"unknown kernel objective id {kid}")


# Runtime dispatch: kid is an int tensor broadcastable to (..., 1).
def box_rt(kid, dtype=torch.float32):
    """Per-kid box bounds (lo, hi, hi - lo), broadcast to kid's shape."""
    out = [torch.full(kid.shape, v, dtype=dtype, device=kid.device)
           for v in box_f32(0)]
    for k in range(1, N_KIDS):
        out = [torch.where(kid == k, v, o) for v, o in zip(box_f32(k), out)]
    return tuple(out)


def full_eval_rt(kid, x, dim: int):
    f = full_eval(0, x, dim)
    for k in range(1, N_KIDS):
        f = torch.where(kid == k, full_eval(k, x, dim), f)
    return f


def term_rt(kid, xi, d):
    s, p = term(0, xi, d)
    for k in range(1, N_KIDS):
        sk, pk = term(k, xi, d)
        s = torch.where(kid == k, sk, s)
        p = torch.where(kid == k, pk, p)
    return s, p


def init_acc_rt(kid, x):
    S, logP, sgnP = init_acc(0, x)
    for k in range(1, N_KIDS):
        Sk, logPk, sgnPk = init_acc(k, x)
        S = torch.where(kid == k, Sk, S)
        logP = torch.where(kid == k, logPk, logP)
        sgnP = torch.where(kid == k, sgnPk, sgnP)
    return S, logP, sgnP


def combine_rt(kid, S, logP, sgnP, dim: int):
    f = combine(0, S, logP, sgnP, dim)
    for k in range(1, N_KIDS):
        f = torch.where(kid == k, combine(k, S, logP, sgnP, dim), f)
    return f

