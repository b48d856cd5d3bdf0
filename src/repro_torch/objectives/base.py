"""Objective-function abstraction, the counterpart of
``repro.objectives.base``.

An objective is a box-constrained ``f: R^n -> R`` evaluated batch-wise:
``f(x)`` takes a float tensor ``(..., n)`` and returns ``(...)``.  The
registry objectives carry ``kernel_id``, the ``kid`` kernel B1 evaluates
them by.  Objectives that admit the sum/product decomposition

    f(x) = combine(S, P, n),   S_k = sum_i s_terms_k(x_i, i),
                               P_k = prod_i p_terms_k(x_i, i)

carry a :class:`DecomposableSpec`, which the plain sweep
(``core/metropolis.py::sweep_delta``) uses to evaluate a one-coordinate
move in O(1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DecomposableSpec:
    """Delta-evaluation structure: vector sum/product accumulators."""

    n_sum: int
    n_prod: int
    # terms(x_i, i) -> (s_vec (..., n_sum), p_vec (..., n_prod))
    terms: Callable[[torch.Tensor, torch.Tensor],
                    tuple[torch.Tensor, torch.Tensor]]
    # combine(S (..., n_sum), P (..., n_prod), n) -> (...)
    combine: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

    def init_acc(self, x: torch.Tensor):
        """Full O(n) accumulators of ``x`` (..., n): (S, (logP, sgnP)),
        the product kept as log-magnitude and sign (|P| can underflow
        float32 for n = 512 products of cosines)."""
        n = x.shape[-1]
        idx = torch.arange(n, device=x.device)
        s, p = self.terms(x, idx)   # (..., n, n_sum), (..., n, n_prod)
        S = s.sum(-2) if self.n_sum else x.new_zeros(x.shape[:-1] + (0,))
        if self.n_prod:
            logP = torch.log(torch.clamp(torch.abs(p), min=1e-30)).sum(-2)
            sgnP = torch.prod(torch.sign(p), dim=-2)
        else:
            logP = x.new_zeros(x.shape[:-1] + (0,))
            sgnP = x.new_ones(x.shape[:-1] + (0,))
        return S, (logP, sgnP)

    def value(self, S, logsgnP, n: int):
        logP, sgnP = logsgnP
        return self.combine(S, sgnP * torch.exp(logP), n)


@dataclasses.dataclass(frozen=True, eq=False)
class Objective:
    """A box-constrained minimization problem instance."""

    name: str
    dim: int
    lower: np.ndarray  # (dim,)
    upper: np.ndarray  # (dim,)
    fn: Callable[[torch.Tensor], torch.Tensor]  # (..., dim) -> (...)
    f_opt: Optional[float] = None  # known global minimum value
    x_opt: Optional[np.ndarray] = None  # one known minimizer (dim,)
    decomposable: Optional[DecomposableSpec] = None
    kernel_id: Optional[int] = None  # id in the sweep kernel's registry

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def bounds(self, device=None, dtype=torch.float32):
        """(lo, hi) as tensors of ``dtype`` on ``device``."""
        return (torch.as_tensor(self.lower, dtype=dtype, device=device),
                torch.as_tensor(self.upper, dtype=dtype, device=device))

    def sample_uniform(self, generator: torch.Generator,
                       shape: Sequence[int],
                       dtype=torch.float32) -> torch.Tensor:
        """Uniform points of ``dtype`` over the box, drawn from
        ``generator`` on its device."""
        lo, hi = self.bounds(generator.device, dtype)
        u = torch.rand(tuple(shape) + (self.dim,), generator=generator,
                       device=generator.device, dtype=dtype)
        return lo + u * (hi - lo)

    def error_to_opt(self, x, fx):
        """|f_a - f_r| and the relative L2 location error (the paper's two
        metrics), as float64 numpy; NaN where the optimum is unknown."""
        x = np.asarray(x, np.float64)
        fx = np.asarray(fx, np.float64)
        df = np.abs(fx - self.f_opt) if self.f_opt is not None else np.nan
        if self.x_opt is not None:
            xo = np.asarray(self.x_opt, np.float64)
            denom = max(float(np.linalg.norm(xo)), 1e-12)
            dx = np.linalg.norm(x - xo, axis=-1) / denom
        else:
            dx = np.nan
        return df, dx


def box(lo: float, hi: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    return np.full((n,), lo, np.float64), np.full((n,), hi, np.float64)
