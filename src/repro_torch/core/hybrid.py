"""Hybrid SA → Nelder–Mead strategy (paper §4.2, Table 10), the
counterpart of ``repro.core.hybrid``.

The annealing run is stopped early (a hotter ``T_min`` than a pure-SA run
would need) and its champion seeds a local simplex minimization.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.annealing import SAConfig, SAResult, sa_minimize
from repro_torch.core.neldermead import NMResult, nelder_mead
from repro_torch.objectives.base import Objective


@dataclasses.dataclass
class HybridResult:
    sa: SAResult
    nm: NMResult

    # NM polishes the SA champion but can end on a worse simplex (iteration
    # cap, degenerate geometry); report the coherent (x, f) pair of the
    # stage that won, never a mix of the two.
    @property
    def _winner(self):
        return self.nm if self.nm.f_best <= self.sa.f_best else self.sa

    @property
    def x_best(self):
        return self._winner.x_best

    @property
    def f_best(self) -> float:
        return self._winner.f_best


def hybrid_minimize(objective: Objective, sa_config: SAConfig,
                    nm_max_iters: int = 4000, nm_fatol: float = 1e-12,
                    nm_xatol: float = 1e-12, *, device=None, mesh=None,
                    mesh_axes=None) -> HybridResult:
    sa_res = sa_minimize(objective, sa_config, device=device, mesh=mesh,
                         mesh_axes=mesh_axes)
    if device is None and mesh is not None:   # as sa_minimize: the mesh's device
        device = mesh.device_type
    nm_res = nelder_mead(objective, sa_res.x_best, max_iters=nm_max_iters,
                         fatol=nm_fatol, xatol=nm_xatol, device=device)
    return HybridResult(sa=sa_res, nm=nm_res)
