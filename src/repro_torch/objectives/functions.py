"""The paper's benchmark suite in PyTorch: 19 function families, 41
problem instances, the counterpart of ``repro.objectives.functions``.

Each factory returns an :class:`Objective` whose ``fn`` computes the same
expression as the reference, in the tensor's dtype on its device.  Where
the reference attaches a :class:`DecomposableSpec` (the nine decomposable
objectives) the port attaches the same one, for the O(1) delta sweep.
Data tables (ICEO, Shekel) are copied from the reference.

Notes (as in the reference)
---------------------------
* Cosine mixture: the standard form ``-0.1 Σcos(5πx) + Σx²``.
* Modified Langerman / Shekel Foxholes use the 1st-ICEO dataset.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import DecomposableSpec, Objective, box

_E = float(np.e)
_PI = float(np.pi)


def _const(a, x):
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def _index1(n, x):
    """1..n as x's dtype on x's device."""
    return torch.arange(1, n + 1, device=x.device).to(x.dtype)


def _no_terms(x):
    """An empty sum or product term vector (..., 0)."""
    return x.new_zeros(x.shape + (0,))


# ---------------------------------------------------------------- F0 Schwefel
def schwefel(n: int) -> Objective:
    """Normalized Schwefel: f(x) = -(1/n) Σ x_i sin(√|x_i|), x ∈ [-512,512]^n."""

    def fn(x):
        return -torch.mean(x * torch.sin(torch.sqrt(torch.abs(x))), dim=-1)

    spec = DecomposableSpec(
        n_sum=1,
        n_prod=0,
        terms=lambda x, i: (
            (x * torch.sin(torch.sqrt(torch.abs(x))))[..., None],
            _no_terms(x),
        ),
        combine=lambda S, P, n: -S[..., 0] / n,
    )
    lo, hi = box(-512.0, 512.0, n)
    return Objective(
        name=f"schwefel_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=-418.982887, x_opt=np.full((n,), 420.968746),
        decomposable=spec, kernel_id=0,
    )


# ----------------------------------------------------------------- F1 Ackley
def ackley(n: int) -> Objective:
    def fn(x):
        s1 = torch.mean(x * x, dim=-1)
        s2 = torch.mean(torch.cos(2 * _PI * x), dim=-1)
        return -20.0 * torch.exp(-0.2 * torch.sqrt(s1)) - torch.exp(s2) + 20.0 + _E

    spec = DecomposableSpec(
        n_sum=2,
        n_prod=0,
        terms=lambda x, i: (
            torch.stack([x * x, torch.cos(2 * _PI * x)], dim=-1),
            _no_terms(x),
        ),
        combine=lambda S, P, n: (
            -20.0 * torch.exp(-0.2 * torch.sqrt(S[..., 0] / n))
            - torch.exp(S[..., 1] / n) + 20.0 + _E
        ),
    )
    lo, hi = box(-30.0, 30.0, n)
    return Objective(
        name=f"ackley_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=0.0, x_opt=np.zeros((n,)), decomposable=spec, kernel_id=2,
    )


# ----------------------------------------------------------------- F2 Branin
def branin() -> Objective:
    def fn(x):
        x1, x2 = x[..., 0], x[..., 1]
        a = x2 - 5.1 / (4 * _PI ** 2) * x1 ** 2 + 5.0 / _PI * x1 - 6.0
        return a ** 2 + 10.0 * (1.0 - 1.0 / (8 * _PI)) * torch.cos(x1) + 10.0

    lo, hi = box(-20.0, 20.0, 2)
    return Objective(
        name="branin", dim=2, lower=lo, upper=hi, fn=fn,
        f_opt=0.397887, x_opt=np.array([_PI, 2.275]),
    )


# --------------------------------------------------------- F3 Cosine mixture
def cosine_mixture(n: int) -> Objective:
    def fn(x):
        return (-0.1 * torch.sum(torch.cos(5 * _PI * x), dim=-1)
                + torch.sum(x * x, dim=-1))

    spec = DecomposableSpec(
        n_sum=2,
        n_prod=0,
        terms=lambda x, i: (
            torch.stack([torch.cos(5 * _PI * x), x * x], dim=-1),
            _no_terms(x),
        ),
        combine=lambda S, P, n: -0.1 * S[..., 0] + S[..., 1],
    )
    lo, hi = box(-1.0, 1.0, n)
    return Objective(
        name=f"cosine_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=-0.1 * n, x_opt=np.zeros((n,)), decomposable=spec,
    )


# ------------------------------------------------------ F4 Dekkers and Aarts
def dekkers_aarts() -> Objective:
    def fn(x):
        x1, x2 = x[..., 0], x[..., 1]
        r2 = x1 ** 2 + x2 ** 2
        return 1e5 * x1 ** 2 + x2 ** 2 - r2 ** 2 + 1e-5 * r2 ** 4

    lo, hi = box(-20.0, 20.0, 2)
    return Objective(
        name="dekkers_aarts", dim=2, lower=lo, upper=hi, fn=fn,
        f_opt=-24776.518, x_opt=np.array([0.0, 14.945]),
    )


# ------------------------------------------------------------------ F5 Easom
def easom() -> Objective:
    def fn(x):
        x1, x2 = x[..., 0], x[..., 1]
        return (-torch.cos(x1) * torch.cos(x2)
                * torch.exp(-((x1 - _PI) ** 2) - (x2 - _PI) ** 2))

    lo, hi = box(-10.0, 10.0, 2)
    return Objective(
        name="easom", dim=2, lower=lo, upper=hi, fn=fn,
        f_opt=-1.0, x_opt=np.array([_PI, _PI]),
    )


# ------------------------------------------------------------ F6 Exponential
def exponential(n: int = 4) -> Objective:
    def fn(x):
        return -torch.exp(-0.5 * torch.sum(x * x, dim=-1))

    spec = DecomposableSpec(
        n_sum=1,
        n_prod=0,
        terms=lambda x, i: ((x * x)[..., None], _no_terms(x)),
        combine=lambda S, P, n: -torch.exp(-0.5 * S[..., 0]),
    )
    lo, hi = box(-1.0, 1.0, n)
    return Objective(
        name=f"exponential_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=-1.0, x_opt=np.zeros((n,)), decomposable=spec, kernel_id=4,
    )


# ---------------------------------------------------- F7 Goldstein and Price
def goldstein_price() -> Objective:
    def fn(x):
        x1, x2 = x[..., 0], x[..., 1]
        a = 1 + (x1 + x2 + 1) ** 2 * (
            19 - 14 * x1 + 3 * x1 ** 2 - 14 * x2 + 6 * x1 * x2 + 3 * x2 ** 2
        )
        b = 30 + (2 * x1 - 3 * x2) ** 2 * (
            18 - 32 * x1 + 12 * x1 ** 2 + 48 * x2 - 36 * x1 * x2 + 27 * x2 ** 2
        )
        return a * b

    lo, hi = box(-2.0, 2.0, 2)
    return Objective(
        name="goldstein_price", dim=2, lower=lo, upper=hi, fn=fn,
        f_opt=3.0, x_opt=np.array([0.0, -1.0]),
    )


# --------------------------------------------------------------- F8 Griewank
def griewank(n: int) -> Objective:
    def fn(x):
        s = torch.sum(x * x / 4000.0, dim=-1)
        p = torch.prod(torch.cos(x / torch.sqrt(_index1(n, x))), dim=-1)
        return 1.0 + s - p

    spec = DecomposableSpec(
        n_sum=1,
        n_prod=1,
        terms=lambda x, i: (
            (x * x / 4000.0)[..., None],
            torch.cos(x / torch.sqrt(i.to(x.dtype) + 1.0))[..., None],
        ),
        combine=lambda S, P, n: 1.0 + S[..., 0] - P[..., 0],
    )
    lo, hi = box(-600.0, 600.0, n)
    return Objective(
        name=f"griewank_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=0.0, x_opt=np.zeros((n,)), decomposable=spec, kernel_id=3,
    )


# ------------------------------------------------------------- F9 Himmelblau
def himmelblau() -> Objective:
    def fn(x):
        x1, x2 = x[..., 0], x[..., 1]
        return (x1 ** 2 + x2 - 11.0) ** 2 + (x1 + x2 ** 2 - 7.0) ** 2

    lo, hi = box(-6.0, 6.0, 2)
    return Objective(
        name="himmelblau", dim=2, lower=lo, upper=hi, fn=fn,
        f_opt=0.0, x_opt=np.array([3.0, 2.0]),
    )


# ----------------------------------------------------- F10 Levy and Montalvo
def levy_montalvo(n: int) -> Objective:
    def fn(x):
        y = 1.0 + 0.25 * (x + 1.0)
        t1 = 10.0 * torch.sin(_PI * y[..., 0]) ** 2
        mid = torch.sum(
            (y[..., :-1] - 1.0) ** 2 * (1.0 + 10.0 * torch.sin(_PI * y[..., 1:]) ** 2),
            dim=-1,
        )
        tn = (y[..., -1] - 1.0) ** 2
        return _PI / n * (t1 + mid + tn)

    lo, hi = box(-10.0, 10.0, n)
    return Objective(
        name=f"levy_montalvo_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=0.0, x_opt=np.full((n,), -1.0),
    )


# ----------------------------------------------------------- ICEO data table
_ICEO_A = np.array([
    [9.681, 0.667, 4.783, 9.095, 3.517, 9.325, 6.544, 0.211, 5.122, 2.020],
    [9.400, 2.041, 3.788, 7.931, 2.882, 2.672, 3.568, 1.284, 7.033, 7.374],
    [8.025, 9.152, 5.114, 7.621, 4.564, 4.711, 2.996, 6.126, 0.734, 4.982],
    [2.196, 0.415, 5.649, 6.979, 9.510, 9.166, 6.304, 6.054, 9.377, 1.426],
    [8.074, 8.777, 3.467, 1.863, 6.708, 6.349, 4.534, 0.276, 7.633, 1.567],
    [7.650, 5.658, 0.720, 2.764, 3.278, 5.283, 7.474, 6.274, 1.409, 8.208],
    [1.256, 3.605, 8.623, 6.905, 0.584, 8.133, 6.071, 6.888, 4.187, 5.448],
    [8.314, 2.261, 4.224, 1.781, 4.124, 0.932, 8.129, 8.658, 1.208, 5.762],
    [0.226, 8.858, 1.420, 0.945, 1.622, 4.698, 6.228, 9.096, 0.972, 7.637],
    [7.305, 2.228, 1.242, 5.928, 9.133, 1.826, 4.060, 5.204, 8.713, 8.247],
    [0.652, 7.027, 0.508, 4.876, 8.807, 4.632, 5.808, 6.937, 3.291, 7.016],
    [2.699, 3.516, 5.874, 4.119, 4.461, 7.496, 8.817, 0.690, 6.593, 9.789],
    [8.327, 3.897, 2.017, 9.570, 9.825, 1.150, 1.395, 3.885, 6.354, 0.109],
    [2.132, 7.006, 7.136, 2.641, 1.882, 5.943, 7.273, 7.691, 2.880, 0.564],
    [4.707, 5.579, 4.080, 0.581, 9.698, 8.542, 8.077, 8.515, 9.231, 4.670],
    [8.304, 7.559, 8.567, 0.322, 7.128, 8.392, 1.472, 8.524, 2.277, 7.826],
    [8.632, 4.409, 4.832, 5.768, 7.050, 6.715, 1.711, 4.323, 4.405, 4.591],
    [4.887, 9.112, 0.170, 8.967, 9.693, 9.867, 7.508, 7.770, 8.382, 6.740],
    [2.440, 6.686, 4.299, 1.007, 7.008, 1.427, 9.398, 8.480, 9.950, 1.675],
    [6.306, 8.583, 6.084, 1.138, 4.350, 3.134, 7.853, 6.061, 7.457, 2.258],
    [0.652, 2.343, 1.370, 0.821, 1.310, 1.063, 0.689, 8.819, 8.833, 9.070],
    [5.558, 1.272, 5.756, 9.857, 2.279, 2.764, 1.284, 1.677, 1.244, 1.234],
    [3.352, 7.549, 9.817, 9.437, 8.687, 4.167, 2.570, 6.540, 0.228, 0.027],
    [8.798, 0.880, 2.370, 0.168, 1.701, 3.680, 1.231, 2.390, 2.499, 0.064],
    [1.460, 8.057, 1.336, 7.217, 7.914, 3.615, 9.981, 9.198, 5.292, 1.224],
    [0.432, 8.645, 8.774, 0.249, 8.081, 7.461, 4.416, 0.652, 4.002, 4.644],
    [0.679, 2.800, 5.523, 3.049, 2.968, 7.225, 6.730, 4.199, 9.614, 9.229],
    [4.263, 1.074, 7.286, 5.599, 8.291, 5.200, 9.214, 8.272, 4.398, 4.506],
    [9.496, 4.830, 3.150, 8.270, 5.079, 1.231, 5.731, 9.494, 1.883, 9.732],
    [4.138, 2.562, 2.532, 9.661, 5.611, 5.500, 6.886, 2.341, 9.699, 6.500],
])
_ICEO_C = np.array([
    0.806, 0.517, 0.100, 0.908, 0.965, 0.669, 0.524, 0.902, 0.531, 0.876,
    0.462, 0.491, 0.463, 0.714, 0.352, 0.869, 0.813, 0.811, 0.828, 0.964,
    0.789, 0.360, 0.369, 0.992, 0.332, 0.817, 0.632, 0.883, 0.608, 0.326,
])


# ---------------------------------------------------- F11 Modified Langerman
def langerman(n: int) -> Objective:
    A_np, c_np = _ICEO_A[:5, :n], _ICEO_C[:5]

    def fn(x):
        A, c = _const(A_np, x), _const(c_np, x)
        d2 = torch.sum((x[..., None, :] - A) ** 2, dim=-1)  # (..., 5)
        return -torch.sum(c * torch.exp(-d2 / _PI) * torch.cos(_PI * d2), dim=-1)

    lo, hi = box(0.0, 10.0, n)
    x_opt = {2: np.array([9.6810707, 0.6666515]), 5: _ICEO_A[4, :5]}.get(n)
    f_opt = {2: -1.080938, 5: -0.964999}.get(n)
    return Objective(
        name=f"langerman_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=f_opt, x_opt=x_opt,
    )


# -------------------------------------------------------- F12 Michalewicz
def michalewicz(n: int, m: int = 10) -> Objective:
    def fn(x):
        i = _index1(n, x)
        return -torch.sum(torch.sin(x) * torch.sin(i * x * x / _PI) ** (2 * m), dim=-1)

    spec = DecomposableSpec(
        n_sum=1,
        n_prod=0,
        terms=lambda x, i: (
            (torch.sin(x) * torch.sin((i.to(x.dtype) + 1.0) * x * x / _PI)
             ** (2 * m))[..., None],
            _no_terms(x),
        ),
        combine=lambda S, P, n: -S[..., 0],
    )
    lo, hi = box(0.0, _PI, n)
    f_opt = {2: -1.8013, 5: -4.6877, 10: -9.6602}.get(n)
    return Objective(
        name=f"michalewicz_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=f_opt, x_opt=None, decomposable=spec,
    )


# -------------------------------------------------------------- F13 Rastrigin
def rastrigin(n: int) -> Objective:
    def fn(x):
        return 10.0 * n + torch.sum(x * x - 10.0 * torch.cos(2 * _PI * x), dim=-1)

    spec = DecomposableSpec(
        n_sum=1,
        n_prod=0,
        terms=lambda x, i: (
            (x * x - 10.0 * torch.cos(2 * _PI * x))[..., None],
            _no_terms(x),
        ),
        combine=lambda S, P, n: 10.0 * n + S[..., 0],
    )
    lo, hi = box(-5.12, 5.12, n)
    return Objective(
        name=f"rastrigin_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=0.0, x_opt=np.zeros((n,)), decomposable=spec, kernel_id=1,
    )


# ------------------------------------------------------------- F14 Rosenbrock
def rosenbrock(n: int = 4) -> Objective:
    def fn(x):
        return torch.sum(
            100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2,
            dim=-1,
        )

    lo, hi = box(-2.048, 2.048, n)
    return Objective(
        name=f"rosenbrock_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=0.0, x_opt=np.ones((n,)),
    )


# ---------------------------------------------------------------- F15 Salomon
def salomon(n: int = 10) -> Objective:
    def fn(x):
        r = torch.sqrt(torch.sum(x * x, dim=-1))
        return 1.0 - torch.cos(2 * _PI * r) + 0.1 * r

    spec = DecomposableSpec(
        n_sum=1,
        n_prod=0,
        terms=lambda x, i: ((x * x)[..., None], _no_terms(x)),
        combine=lambda S, P, n: (
            1.0 - torch.cos(2 * _PI * torch.sqrt(S[..., 0]))
            + 0.1 * torch.sqrt(S[..., 0])
        ),
    )
    lo, hi = box(-100.0, 100.0, n)
    return Objective(
        name=f"salomon_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=0.0, x_opt=np.zeros((n,)), decomposable=spec, kernel_id=5,
    )


# ------------------------------------------------- F16 Six-Hump Camel Back
def six_hump_camel() -> Objective:
    def fn(x):
        x1, x2 = x[..., 0], x[..., 1]
        return (
            (4.0 - 2.1 * x1 ** 2 + x1 ** 4 / 3.0) * x1 ** 2
            + x1 * x2
            + (-4.0 + 4.0 * x2 ** 2) * x2 ** 2
        )

    lo = np.array([-3.0, -2.0])
    hi = np.array([3.0, 2.0])
    return Objective(
        name="six_hump_camel", dim=2, lower=lo, upper=hi, fn=fn,
        f_opt=-1.0316, x_opt=np.array([-0.0898, 0.7126]),
    )


# ---------------------------------------------------------------- F17 Shubert
def shubert(n: int = 2) -> Objective:
    def inner(xi):
        j = torch.arange(1, 6, device=xi.device).to(xi.dtype)
        return torch.sum(j * torch.cos((j + 1.0) * xi[..., None] + j), dim=-1)

    def fn(x):
        return torch.prod(inner(x), dim=-1)

    spec = DecomposableSpec(
        n_sum=0,
        n_prod=1,
        terms=lambda x, i: (_no_terms(x), inner(x)[..., None]),
        combine=lambda S, P, n: P[..., 0],
    )
    lo, hi = box(-10.0, 10.0, n)
    return Objective(
        name=f"shubert_{n}", dim=n, lower=lo, upper=hi, fn=fn,
        f_opt=-186.7309 if n == 2 else None,
        x_opt=np.array([-7.0835, 4.8580]) if n == 2 else None,
        decomposable=spec,
    )


# ----------------------------------------------------------------- F18 Shekel
_SHEKEL_A = np.array([
    [4.0, 4.0, 4.0, 4.0], [1.0, 1.0, 1.0, 1.0], [8.0, 8.0, 8.0, 8.0],
    [6.0, 6.0, 6.0, 6.0], [3.0, 7.0, 3.0, 7.0], [2.0, 9.0, 2.0, 9.0],
    [5.0, 5.0, 3.0, 3.0], [8.0, 1.0, 8.0, 1.0], [6.0, 2.0, 6.0, 2.0],
    [7.0, 3.6, 7.0, 3.6],
])
# The standard Shekel c (the paper's printed vector drops one 0.4 entry).
_SHEKEL_C = np.array([0.1, 0.2, 0.2, 0.4, 0.4, 0.6, 0.3, 0.7, 0.5, 0.5])


def _shekel_like(A_np, c_np):
    def fn(x):
        A, c = _const(A_np, x), _const(c_np, x)
        d2 = torch.sum((x[..., None, :] - A) ** 2, dim=-1)
        return -torch.sum(1.0 / (d2 + c), dim=-1)
    return fn


def shekel(m: int) -> Objective:
    lo, hi = box(0.0, 10.0, 4)
    f_opt = {5: -10.1532, 7: -10.4029, 10: -10.5364}[m]
    return Objective(
        name=f"shekel_{m}", dim=4, lower=lo, upper=hi,
        fn=_shekel_like(_SHEKEL_A[:m], _SHEKEL_C[:m]),
        f_opt=f_opt, x_opt=np.array([4.0, 4.0, 4.0, 4.0]),
    )


# ------------------------------------------- F19 Modified Shekel Foxholes
def shekel_foxholes(n: int) -> Objective:
    lo, hi = box(-5.0, 15.0, n)
    x_opt = {2: np.array([8.024, 9.146]), 5: _ICEO_A[2, :5]}.get(n)
    f_opt = {2: -12.1190, 5: -10.4056}.get(n)
    return Objective(
        name=f"foxholes_{n}", dim=n, lower=lo, upper=hi,
        fn=_shekel_like(_ICEO_A[:, :n], _ICEO_C),
        f_opt=f_opt, x_opt=x_opt,
    )
