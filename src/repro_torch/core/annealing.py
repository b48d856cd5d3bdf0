"""Simulated annealing driver (paper §2): V0 sequential, V1 asynchronous,
V2 synchronous, the counterpart of ``repro.core.annealing``.

Where the reference compiles the whole ladder into one XLA program, the
port runs the paper's CUDA design: a Python loop over temperature levels,
each level one N-step Metropolis sweep of every chain, then the exchange
and the best-so-far update.  Nothing in the loop synchronises with the
host; the history stays on the device and is copied once at the end.

The route of a level is fixed by the objective and ``cfg.dtype``
(:func:`sweeps_in_kernel`): a float32 objective with a ``kernel_id`` is
swept by kernel B1 (``full`` or ``delta``) and its champions come from
kernel B2; any other objective, and every float64 run, is swept by the
plain ``core/metropolis.py`` (the reference's float64 never reaches a
Pallas kernel either), float32 champions still through B2 and float64 ones
through ``torch.argmin``.  No route stands in for another when a kernel
fails.

The sweep is counter-based (``kernels/rng.py``): level ``lvl`` draws steps
``lvl*N .. lvl*N + N-1`` of chain ``c``'s stream under ``cfg.seed``.  The
reference's ``sa_minimize`` draws from ``jax.random`` instead, so the two
agree in distribution, and level by level with a composition of
``repro.kernels.ops.metropolis_sweep`` and ``repro.core.exchange``.

With a mesh (:func:`build_sharded_ladder`) every rank runs its contiguous
slice of the chains and the exchange gathers one champion per shard
(``core/exchange.py``).  Each chain keeps its global index in every draw,
so a sharded run follows the unsharded one chain for chain: the same
``f_best`` at any world size.  Best-so-far stays local to a shard, as in
the reference, and the final reduce folds it in; the history is the first
shard's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import exchange as exch
from repro_torch.core import metropolis
from repro_torch.core.metropolis import DTYPES
from repro_torch.kernels import ops
from repro_torch.launch.mesh import check_mesh, shard_count, shard_index
from repro_torch.objectives.base import Objective
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """Annealing schedule + parallelization configuration (paper notation).

    Fields and defaults are the reference's, so a reference config round
    trips.  ``unroll`` (the reference's cost-measurement mode) has no
    effect here: the port's ladder is a host loop."""

    T0: float = 1000.0          # initial temperature
    T_min: float = 0.01         # target (stop) temperature
    rho: float = 0.99           # geometric cooling factor
    N: int = 100                # Markov chain length per level
    n_chains: int = 16384       # w: number of parallel chains (b*g in paper)
    exchange: str = "sync"      # 'async' (V1) | 'sync' (V2) | 'sos'
    exchange_period: int = 1    # levels between exchanges (1 = every level)
    seed: int = 0
    dtype: str = "float32"      # 'float32' | 'float64' (paper Table 7)
    use_delta_eval: bool = False  # beyond-paper O(1) delta evaluation
    record_history: bool = True   # per-level champion trace
    unroll: bool = False          # kept for round trips; no effect

    @property
    def n_levels(self) -> int:
        """Number of executed temperature levels (paper's do/while loop)."""
        return max(1, int(math.ceil(math.log(self.T_min / self.T0)
                                    / math.log(self.rho))))

    @property
    def n_evals(self) -> int:
        """Total objective evaluations (paper's 'function evaluations')."""
        return self.n_levels * self.N * self.n_chains

    def ladder(self) -> np.ndarray:
        k = np.arange(self.n_levels)
        return (self.T0 * self.rho ** k).astype(self.dtype)


@dataclasses.dataclass
class SAResult:
    x_best: np.ndarray        # (dim,)
    f_best: float
    history_f: Optional[np.ndarray]  # per-level best-so-far objective value
    n_evals: int
    config: SAConfig
    objective_name: str = ""


@dataclasses.dataclass
class LadderState:
    """Chains and best-so-far between levels, all on one device."""

    x: torch.Tensor          # (chains, dim)
    fx: torch.Tensor         # (chains,)
    best_x: torch.Tensor     # (dim,)
    best_f: torch.Tensor     # 0-d
    hist: Optional[torch.Tensor]  # (n_levels,) or None


def _check_config(cfg: SAConfig) -> None:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}; "
                         f"expected one of {sorted(DTYPES)}")
    if cfg.exchange not in exch.EXCHANGES:
        raise ValueError(f"unknown exchange {cfg.exchange!r}; "
                         f"expected one of {sorted(exch.EXCHANGES)}")


def sweeps_in_kernel(objective: Objective, cfg: SAConfig) -> bool:
    """Whether kernel B1 sweeps the levels: a registry objective
    (``kernel_id``) in float32.  Otherwise ``core/metropolis.py`` does."""
    return objective.kernel_id is not None and cfg.dtype == "float32"


def _sweep(state: "LadderState", lvl: int, T: float, objective: Objective,
           cfg: SAConfig, chain_base: int):
    step0 = lvl * cfg.N
    if sweeps_in_kernel(objective, cfg):
        return ops.metropolis_sweep(
            state.x, T, cfg.seed, step0, kid=objective.kernel_id,
            n_steps=cfg.N, variant="delta" if cfg.use_delta_eval else "full",
            chain_base=chain_base, device=state.x.device)
    cidx = (chain_base + torch.arange(state.x.shape[0], device=state.x.device)
            if chain_base else None)
    if cfg.use_delta_eval:
        return metropolis.sweep_delta(state.x, T, cfg.seed, step0,
                                      objective=objective, n_steps=cfg.N,
                                      cidx=cidx)
    return metropolis.sweep_full(state.x, state.fx, T, cfg.seed, step0,
                                 objective=objective, n_steps=cfg.N, cidx=cidx)


def init_state(x0c: torch.Tensor, *, objective: Objective,
               cfg: SAConfig) -> LadderState:
    fx = objective(x0c)
    best_x, best_f = exch.local_champion(x0c, fx)
    hist = (torch.empty(cfg.n_levels, dtype=fx.dtype, device=fx.device)
            if cfg.record_history else None)
    return LadderState(x0c, fx, best_x, best_f, hist)


def level_step(state: LadderState, lvl: int, T: float, *,
               objective: Objective, cfg: SAConfig,
               shard: Optional[exch.Shard] = None) -> LadderState:
    """One temperature level: sweep of length N, exchange, best-so-far.
    With ``shard`` the chains are this rank's slice and the exchange runs
    over the shard's mesh dims.  The level is the span ``sa.level``
    while a profiler records (``repro_torch/spans.py``)."""
    with span("sa.level"):
        x, fx = _sweep(state, lvl, T, objective, cfg,
                       shard.chain_base if shard else 0)
        if cfg.exchange != "async" and lvl % cfg.exchange_period == 0:
            x, fx = exch.EXCHANGES[cfg.exchange](x, fx, T, seed=cfg.seed,
                                                 lvl=lvl, shard=shard)
        xb, fb = exch.local_champion(x, fx)
        better = fb < state.best_f
        best_x = torch.where(better, xb, state.best_x)
        best_f = torch.where(better, fb, state.best_f)
        if state.hist is not None:
            state.hist[lvl] = best_f
    return LadderState(x, fx, best_x, best_f, state.hist)


def run_ladder(x0c: torch.Tensor, *, objective: Objective, cfg: SAConfig,
               shard: Optional[exch.Shard] = None):
    """Run the whole ladder from per-chain states ``x0c`` (chains, dim):
    all the chains, or with ``shard`` this rank's slice of them.

    Returns (best_x (dim,), best_f 0-d, hist (n_levels,) or None), all on
    x0c's device; sharded, the same on every rank, with the first shard's
    history.  ``cfg`` is taken as :func:`sa_minimize` has checked it."""
    state = init_state(x0c, objective=objective, cfg=cfg)
    for lvl, T in enumerate(cfg.ladder().tolist()):
        state = level_step(state, lvl, T, objective=objective, cfg=cfg,
                           shard=shard)
    # Final champion reduce over the chains and the carried best (the paper
    # V1's reduceMin; a refinement no-op for V2).
    n = state.fx.shape[0]
    fa = torch.cat([state.fx, state.best_f.reshape(1)])
    fb, j = exch.champion_index(fa)
    xa = state.x.index_select(0, torch.clamp(j, max=n - 1).reshape(1).long())[0]
    best_x = torch.where(j == n, state.best_x, xa)
    hist = state.hist
    if shard is not None:
        best_x, fb = exch.gather_champion(best_x, fb, shard)
        if hist is not None:
            hist = exch.gather_shards(hist, shard)[0]
    return best_x, fb, hist


def build_sharded_ladder(objective: Objective, cfg: SAConfig, mesh,
                         mesh_axes=None):
    """The sharded annealing program: chains cut along the dims
    ``mesh_axes`` (default: all) of ``mesh``, a ``DeviceMesh``.

    Every rank calls the returned function with the global ``x0c``
    (n_chains, dim) and runs its slice ``[r*n/R, (r+1)*n/R)``, ``r`` its
    coordinate over ``mesh_axes`` and ``R`` the product of their sizes;
    ranks off those dims are replicas.  The function returns (best_x,
    best_f, hist) as :func:`run_ladder` does, the same on every rank.  V1
    (``async``) stays free of communication until the final reduce, so
    its history is off, as in the reference."""
    axes = check_mesh(mesh, mesh_axes)
    n_shards = shard_count(mesh, axes)
    if cfg.n_chains % n_shards:
        raise ValueError(
            f"n_chains={cfg.n_chains} not divisible by mesh size {n_shards}")
    if cfg.exchange == "async" and cfg.record_history:
        cfg = dataclasses.replace(cfg, record_history=False)
    per = cfg.n_chains // n_shards
    shard = exch.Shard.over(mesh, axes, shard_index(mesh, axes) * per)

    def sharded(x0c):
        return run_ladder(x0c[shard.chain_base:shard.chain_base + per],
                          objective=objective, cfg=cfg, shard=shard)
    return sharded


def sa_minimize(objective: Objective, cfg: SAConfig, x0=None, *,
                device=None, mesh=None, mesh_axes=None) -> SAResult:
    """Minimize ``objective`` with parallel SA on ``device`` (default: the
    card, or the mesh's device type), in ``cfg.dtype``.

    Without ``x0`` the chains start uniform over the box, drawn from a
    ``torch.Generator`` on the device seeded with ``cfg.seed``; a given
    ``x0`` (dim,) is broadcast to every chain.  With ``mesh`` (a
    ``DeviceMesh``, ``launch.mesh.make_mesh``) every rank of its process
    group calls this, samples the same global chains and runs its slice
    of them (:func:`build_sharded_ladder`); every rank returns the same
    result."""
    _check_config(cfg)
    if mesh is not None or mesh_axes is not None:
        check_mesh(mesh, mesh_axes)
        if device is None:
            device = mesh.device_type
        elif resolve_device(device).type != mesh.device_type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type}")
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    if x0 is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        x0c = objective.sample_uniform(gen, (cfg.n_chains,), dtype)
    else:
        x0c = torch.as_tensor(x0, dtype=dtype, device=dev).reshape(
            1, objective.dim).expand(cfg.n_chains, objective.dim).contiguous()
    if mesh is None:
        best_x, best_f, hist = run_ladder(x0c, objective=objective, cfg=cfg)
    else:
        run = build_sharded_ladder(objective, cfg, mesh, mesh_axes)
        best_x, best_f, hist = run(x0c)
    return SAResult(
        x_best=best_x.cpu().numpy(),
        f_best=float(best_f),
        history_f=None if hist is None else hist.cpu().numpy(),
        n_evals=cfg.n_evals,
        config=cfg,
        objective_name=objective.name,
    )
