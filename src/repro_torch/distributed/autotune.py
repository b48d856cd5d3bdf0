"""SA-driven sharding autotuner, the counterpart of
``repro.distributed.autotune``: the paper's optimizer pointed at the
distribution problem of a training job.

Search space (discrete, encoded into the SA box [0,1)^5: coordinate-wise
uniform proposals quantize to choice indices, so the paper's Metropolis
sweep applies unchanged):

  d0: dp_split   — how many of the ``chips`` go to DP (rest = TP); choices
                   are divisors of ``chips`` that also divide global batch.
  d1: remat      — none | dots | full  (activation-memory vs recompute)
  d2: ep         — MoE expert-parallel on/off (all_to_all vs replicated)
  d3: microbatch — 1|2|4|8 gradient-accumulation chunks
  d4: compress   — fp32 | bf16 | int8 gradient all-reduce payload

The objective is the reference's analytic three-term roofline step-time
estimate (compute, memory, collectives) with its memory-capacity penalty,
evaluated in the chains' dtype.  Its constants describe one card of the
job, the NVIDIA H100 SXM5 80GB; a test sets them to the reference's to
hold the two objectives and decisions against each other.

The objective has no ``kernel_id``, so ``sa_minimize`` sweeps it with the
plain ``core/metropolis.py`` and takes its float32 champions from kernel
B2.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.model import ModelConfig
from repro_torch.objectives.base import Objective

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet:
PEAK_FLOPS = 989e12       # dense BF16 tensor-core peak, FLOP/s
HBM_BW = 3.35e12          # HBM3 bandwidth, bytes/s
LINK_BW = 450e9           # NVLink, bytes/s each way (900 GB/s both ways)
HBM_CAP = 80e9            # memory capacity, bytes (80 GB)

REMAT_CHOICES = ("none", "dots", "full")
# extra fwd-flops multiplier: none=0, dots≈.3 (recompute non-dot), full=1
_REMAT_RECOMP = {"none": 0.0, "dots": 0.3, "full": 1.0}
# activation bytes kept per token per layer (fraction of no-remat)
_REMAT_ACT = {"none": 1.0, "dots": 0.35, "full": 0.08}
MB_CHOICES = (1, 2, 4, 8)
COMPRESS_CHOICES = ("fp32", "bf16", "int8")
_COMPRESS_BYTES = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0}


@dataclasses.dataclass(frozen=True)
class TuneProblem:
    cfg: ModelConfig
    seq: int
    batch: int
    chips: int
    kind: str = "train"        # 'train' | 'prefill' | 'decode'

    def dp_choices(self) -> tuple[int, ...]:
        return tuple(dp for dp in range(1, self.chips + 1)
                     if self.chips % dp == 0 and self.batch % dp == 0)

    def space(self) -> tuple[tuple[str, int], ...]:
        return (("dp", len(self.dp_choices())),
                ("remat", len(REMAT_CHOICES)),
                ("ep", 2),
                ("mb", len(MB_CHOICES)),
                ("compress", len(COMPRESS_CHOICES)))


def decode_point(prob: TuneProblem, x: np.ndarray) -> dict:
    """Map a box point in [0,1)^5 to a concrete decision dict."""
    dps = prob.dp_choices()
    idx = [min(int(xi * n), n - 1) for xi, (_, n) in zip(x, prob.space())]
    return {
        "dp": dps[idx[0]], "tp": prob.chips // dps[idx[0]],
        "remat": REMAT_CHOICES[idx[1]],
        "ep": bool(idx[2]) and prob.cfg.n_experts > 0,
        "microbatch": MB_CHOICES[idx[3]],
        "compress": COMPRESS_CHOICES[idx[4]],
    }


def _cost_terms(prob: TuneProblem, dp, remat_recomp, remat_act, ep, mb,
                comp_bytes):
    """Analytic roofline terms, elementwise over tensors of one dtype:
    (compute s, memory s, collective s, penalty)."""
    cfg = prob.cfg
    total, active = cfg.param_count()
    D = float(cfg.d_model)
    Ls = float(cfg.n_layers)
    tokens = float(prob.batch * prob.seq)
    tp = prob.chips / dp
    bytes_p = 2.0  # bf16 params/activations
    zero = torch.zeros_like(dp)

    mult = 6.0 if prob.kind == "train" else 2.0
    model_flops = mult * float(active) * tokens
    # recompute applies to the forward third of 6ND
    flops = model_flops * (1.0 + remat_recomp * (2.0 / mult))
    compute_s = flops / (prob.chips * PEAK_FLOPS)

    # memory: params traversed (fwd+bwd+opt ~ 3x for train), activations
    # streamed in/out once, scaled by remat retention.
    p_traverse = 3.0 if prob.kind == "train" else 1.0
    act_bytes = tokens * D * Ls * 8.0 * bytes_p * remat_act
    mem_bytes = p_traverse * float(total) * bytes_p + act_bytes
    if prob.kind == "train":
        mem_bytes = mem_bytes + 3.0 * float(total) * 4.0  # fp32 opt state r/w
    memory_s = mem_bytes / (prob.chips * HBM_BW)

    # collectives
    #   TP: 2 all-reduces per layer of (tokens/dp, D) activations
    tp_bytes = torch.where(tp > 1, 2.0 * Ls * (tokens / dp) * D * bytes_p * 2.0
                           * (tp - 1.0) / tp, zero)
    #   DP grad sync: ring reduce-scatter+all-gather of param bytes / tp
    dp_bytes = torch.where(dp > 1, 2.0 * (float(total) / tp) * comp_bytes
                           * (dp - 1.0) / dp, zero)
    #   EP dispatch: top_k-routed activations all_to_all, 2x (fwd+bwd-ish)
    if cfg.n_experts:
        ep_bytes = torch.where(ep, zero + 4.0 * (tokens / prob.chips) * D
                               * bytes_p * float(cfg.top_k), zero)
        # without EP the routed FFN weights are replicated: pay a one-time
        # broadcast amortized as an extra DP-style sync on expert params
        moe_params = float(total - active)
        ep_bytes = ep_bytes + torch.where(
            ep, zero, 2.0 * moe_params * comp_bytes * (dp - 1.0)
            / torch.clamp(dp, min=1.0))
    else:
        ep_bytes = zero
    coll_bytes = tp_bytes + dp_bytes / mb + ep_bytes  # grad sync 1/mb-able
    collective_s = coll_bytes / (prob.chips * LINK_BW)

    # memory-capacity penalty: activations + params + opt must fit a card.
    state_bytes = (float(total) * (bytes_p + 12.0) / prob.chips  # p+opt fp32
                   + act_bytes / (prob.chips * mb))
    over = torch.clamp(state_bytes / HBM_CAP - 1.0, min=0.0)
    penalty = over * 100.0  # strongly discourage OOM points

    # int8 compression numeric tax: tiny fixed penalty so it's only chosen
    # when the wire win is real.
    penalty = penalty + torch.where(comp_bytes < 2.0, zero + 1e-4, zero)
    return compute_s, memory_s, collective_s, penalty


def make_objective(prob: TuneProblem) -> Objective:
    """Step-time estimate as an SA Objective over the [0,1)^5 box."""
    dps = np.asarray(prob.dp_choices(), np.float64)
    n_dp = len(dps)
    recomp = np.asarray([_REMAT_RECOMP[r] for r in REMAT_CHOICES])
    act = np.asarray([_REMAT_ACT[r] for r in REMAT_CHOICES])
    mbs = np.asarray(MB_CHOICES, np.float64)
    cbytes = np.asarray([_COMPRESS_BYTES[c] for c in COMPRESS_CHOICES])

    def fn(x):
        def pick(table, i):
            return torch.as_tensor(table, dtype=x.dtype, device=x.device)[i]

        def index(k, n):
            return torch.clamp((x[..., k] * n).to(torch.int32), 0, n - 1).long()

        i_rm = index(1, 3)
        c, m, coll, pen = _cost_terms(
            prob, pick(dps, index(0, n_dp)), pick(recomp, i_rm), pick(act, i_rm),
            index(2, 2).bool(), pick(mbs, index(3, 4)), pick(cbytes, index(4, 3)))
        # overlappable: compute hides the larger of (memory, collective)
        # partially; model 70% overlap of the non-dominant pair.
        hi = torch.maximum(torch.maximum(c, m), coll)
        rest = c + m + coll - hi
        return hi + 0.3 * rest + pen

    return Objective(name=f"autotune-{prob.cfg.name}", dim=5,
                     lower=np.zeros(5), upper=np.ones(5) - 1e-9, fn=fn)


def exhaustive_best(prob: TuneProblem, device=None) -> tuple[dict, float]:
    """Brute-force reference over the grid of choice midpoints, evaluated
    in one float32 call on ``device`` (default: the card); ties go to the
    first point in ``itertools.product`` order, as the reference's loop
    keeps them."""
    space = prob.space()
    grid = np.array([[(c + 0.5) / n for c, (_, n) in zip(combo, space)]
                     for combo in itertools.product(*[range(n) for _, n in space])])
    f = make_objective(prob)(torch.as_tensor(grid, dtype=torch.float32,
                                             device=resolve_device(device)))
    j = int(torch.argmin(f))
    return decode_point(prob, grid[j]), float(f[j])


def autotune(prob: TuneProblem, n_chains: int = 256, seed: int = 0,
             mesh=None, device=None) -> tuple[dict, float]:
    """Run synchronous parallel SA over the decision space, on ``device``
    (default: the card) or over ``mesh`` (``sa_minimize(mesh=...)``)."""
    from repro_torch.core import SAConfig, sa_minimize

    obj = make_objective(prob)
    cfg = SAConfig(T0=1.0, T_min=1e-3, rho=0.85, N=20, n_chains=n_chains,
                   exchange="sync", seed=seed, record_history=False)
    res = sa_minimize(obj, cfg, device=device, mesh=mesh)
    return decode_point(prob, np.asarray(res.x_best)), float(res.f_best)
