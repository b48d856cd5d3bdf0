"""State carried across between the JAX package and the port.

The "weights" of this system are its configurations and chain states.
These helpers take them from the plain Python/numpy forms both packages
share, so the same inputs reach both without this package importing JAX
or ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.annealing import SAConfig
from repro_torch.objectives import functions as F
from repro_torch.objectives.base import Objective

_BY_NAME = {
    "schwefel": F.schwefel, "rastrigin": F.rastrigin, "ackley": F.ackley,
    "griewank": F.griewank, "exponential": F.exponential, "salomon": F.salomon,
}


def sa_config_from_dict(d: dict) -> SAConfig:
    """An ``SAConfig`` from ``dataclasses.asdict`` of a reference config;
    unknown keys raise."""
    names = {f.name for f in dataclasses.fields(SAConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown SAConfig fields {sorted(extra)}")
    return SAConfig(**d)


def objective_from_ref(name: str, dim: int) -> Objective:
    """The port's registry objective ``name`` (``"schwefel"``, ...) at
    ``dim``: same kernel_id, box, f_opt and x_opt as the reference's."""
    try:
        return _BY_NAME[name](dim)
    except KeyError:
        raise ValueError(f"{name!r} is not a registry objective; "
                         f"expected one of {sorted(_BY_NAME)}") from None


def chains_from_numpy(x, fx, device=None):
    """(chains, dim) states and (chains,) values -> float32 tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(x, np.float32), device=dev),
            torch.as_tensor(np.asarray(fx, np.float32), device=dev))


def chains_to_numpy(x, fx):
    """The inverse of :func:`chains_from_numpy`."""
    return x.detach().cpu().numpy(), fx.detach().cpu().numpy()
