"""Objective-function abstraction, the counterpart of
``repro.objectives.base``.

An objective is a box-constrained ``f: R^n -> R`` evaluated batch-wise:
``f(x)`` takes a float tensor ``(..., n)`` and returns ``(...)``.  The
registry objectives carry ``kernel_id``, the ``kid`` the sweep kernel
evaluates them by.  The reference's ``DecomposableSpec`` has no
counterpart: its only user is the ``jax.random`` sweep, and the port's
sweeps evaluate registry objectives inside kernel B1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


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
    kernel_id: Optional[int] = None  # id in the sweep kernel's registry

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def bounds(self, device=None, dtype=torch.float32):
        """(lo, hi) as tensors on ``device``."""
        return (torch.as_tensor(self.lower, dtype=dtype, device=device),
                torch.as_tensor(self.upper, dtype=dtype, device=device))

    def sample_uniform(self, generator: torch.Generator,
                       shape: Sequence[int]) -> torch.Tensor:
        """Uniform points over the box, drawn from ``generator`` on its
        device."""
        lo, hi = self.bounds(generator.device)
        u = torch.rand(tuple(shape) + (self.dim,), generator=generator,
                       device=generator.device)
        return lo + u * (hi - lo)


def box(lo: float, hi: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    return np.full((n,), lo, np.float64), np.full((n,), hi, np.float64)
