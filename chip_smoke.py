"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --against DIR    # phase 0, then B1 full and B3
                                           # against the kernels of the tree
                                           # DIR (bits, then times in turns),
                                           # then phase 8's load through
                                           # both trees' engines in turns

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a)
and runs, in order, failing on the first phase that fails:

0. device: the card's name and power limit, torch/CUDA versions, build time,
   ptxas's registers, shared memory and spills of B1, B2 and B3, and the
   SASS instructions of one Schwefel term (B1 full's bound);
1. kernel B1 (Metropolis sweep) vs its plain version at 16384 chains, dim 32
   and 512, full and delta, in the 64-slot layout of the serving engine,
   and both variants at dim 3 over 100 steps with step0 wrapping past 2^32,
   with and without t_chain; full at dim 30000, whose term caches do not
   fit in shared memory; one slot swept alone and packed at blk 256 and
   64, bit for bit, in both variants;
2. kernel B2 (block argmin) vs its plain version, fp32 and bf16, with ties,
   n = 1 and 5 up to 2^20 + 3, an all-equal vector, NaNs, and slices that
   start off 16-byte alignment;
3. the beyond-paper delta variant: hybrid SA -> Nelder-Mead on Schwefel-512
   at 16384 chains (the F0_g row of the paper's Table 10 with
   use_delta_eval=True), with the kernels' launch counts over that run,
   and the device time per level of its first 100 levels under a
   torch.profiler trace;
4. the main path as the paper and the reference's Table 10 bench run it:
   sa_minimize on Schwefel-512, 16384 chains, the default (full) variant,
   all 688 levels, with B1 full's launches and B2's (two per level), the
   device time per level of the first 100 levels, and the quality gate of
   phase 3;
5. V0 and V1 (async) and SOS on Schwefel-32, and a small run held against
   the plain CPU path;
6. kernel times at the main path's shapes: CUDA events around the C entry
   alone and around the wrapper call (medians), torch.min and torch.argmin
   beside B2, and device times from a torch.profiler trace (both B1
   variants also at N = 0, 1 and 16); then B2's two routes timed at
   lengths around its one-CTA threshold;
7. kernel B3 (pairwise-exchange QAP sweep) vs its plain version at 128
   slots x 512 chains, N = 40, for n = 2, 5, 10, 12, 20, 31 and the
   kernel's largest n, at n = 12 with F or D one (n, n) for every block,
   at n = 12 and 31 with blocks of 96 chains, and the PTX of its accept
   test;
8. the serving main path: 256 QAP requests (grid12 and syn10, 128 seeds
   each) through the engine at 128 slots x 512 chains, macro-K 4, with B3's
   launches and kernel time (CUDA events around each kernel launch), the
   QAP quality gate, and 8 requests held bit for bit against their
   standalone runs; the same load at K = 1;
9. continuous and QAP requests co-batched at 64 slots x 512 chains, K = 1
   and 4, every champion bit-exact against its standalone run;
10. the elastic open-loop path: 192 mixed requests with completion
    deadlines arriving in bursts (rate 3 per tick, bursts of 8) on two
    shards of 64 slots x 512 chains at K = 4, with preemption, proactive
    degrade, watermark rebalancing, a scripted preempt, migrate and
    degrade, drain(1) at tick 24 and resize(2) from tick 48 once shard 1
    has retired; accounting,
    every event kind, every completed request bit-exact against its
    standalone replay of its width and ladder schedules, the QAP quality
    gate, latency percentiles, checkpoint cost and card memory around the
    retired shard; then the reference's K-boundary scenario at K = 1 and 4;
11. the paper's Table 9: all 41 suite problems, V1 and V2, 16384 chains,
    N = 100, on the quick bench's 39-level ladder: |f - f*|, wall and
    route of each (B1 full + B2 for the 18 registry objectives, the torch
    sweep + B2 for the 23 others, checked by launch counts);
12. the paper's Table 7: Schwefel-16 at T0 = 1000, T_min = 0.01,
    rho = 0.99, N = 100, 16384 chains (1146 levels) in float32 (B1 full +
    B2) and float64 (the torch sweep), a warm run first; wall, |f - f*|
    and relative x error, and the device time per level of the torch
    sweep in both precisions beside B1 full's;
13. parallel tempering and population annealing served: 96 requests of
    make_mix(method="mixed", family="mixed") on 64 slots x 512 chains at
    K = 1 and 4, each bit-exact against its standalone run with its PA
    self-shrinks re-derived; the reference's preempt / resize / drain
    scenario at 512 chains per slot; a pure-PA load on 128 slots x 512
    chains whose weights sum past 2^31 - 1, each tenant bit-exact;
14. telemetry and the autoscaler: (a) phase 10's load with telemetry off,
    then on twice with the Perfetto trace and the event log: champions,
    launch counts and replays equal, no kernel build, equal event logs, a
    valid trace; wall and CPU seconds per tick phase, device_wait per
    shard (one CUDA event per group launch), on against off, and a fourth
    run with the host seconds of dispatch's parts (packing, upload, the K
    levels of launches); (b) the
    reference's autoscaler bench (64 diurnal requests with completion
    deadlines, 4 slots x 512 chains per shard) through static fleets of
    1-4 shards and the autoscaler, with its autoscale_committed gates and
    every champion against its standalone replay;
15. the sharded ladder and the sharding autotuner, over a world-size-1
    NCCL process group (one card holds one NCCL rank): (a) phase 4's cell
    through sa_minimize(mesh=...) on a (1,) mesh and on a (1, 1) mesh cut
    along "data", in turns with the unsharded run, f_best, x_best and
    history_f bit-equal to it with the same B1 and B2 launches and one
    all-gather per level, and the device time per level (NCCL's kernels
    apart) under a torch.profiler trace; phase 5's V1 and SOS cells and
    phase 3's hybrid over the (1,) mesh, each bit-equal to its unsharded
    run; (b) the autotuner on all ten architectures at train 4096 x 256 on
    256 chips, 256 chains: SA within 2% of the exhaustive optimum, the
    route (plain sweep + B2) checked by launch counts, and one
    architecture again over the mesh;
16. the dense LLM scaffold at full width and depth, random weights, TF32
    off: (a) stablelm-1.6b in bf16 served by launch/serve.py's loop (16
    requests, prompt 256, 64 new tokens, 8 slots, s_max 512): prefill ms
    per request and decode ms per tick (medians, CUDA events), tokens/s,
    ticks, weight, cache and peak card memory, the decode tick's byte
    bound and its share of it, and a profiler trace of 10 ticks (device
    busy share, top device ops); every request 64 tokens, all logits
    finite; (b) in float32 at its width: teacher-forced decode of
    positions 64-95 against train-mode logits, the card's forward against
    the CPU's at depth 2, eight requests at batch 8 against batch 1 (every
    difference a near-tie); (c) gemma3-4b in bf16 (4 requests, prompt 1536
    past the 1024 window, 32 new tokens, 4 slots, s_max 2048) with 16a's
    timings, and in float32 teacher-forced decode after the 1536-token
    prefill against train mode.  It launches none of B1-B3 (counters);
17. MLA and the local MoE at full width, random weights, TF32 off: (a)
    deepseek-v2-lite-16b in bf16 at full depth (27 layers, 64 routed
    experts top-6 + 2 shared) served by launch/serve.py's loop (8
    requests, prompt 256, 32 new tokens, 8 slots, s_max 512) with 16a's
    metrics, and the dropped picks per prefill and per decode tick; (b)
    in float32 at its width, depth cut: teacher-forced decode of positions
    64-95 against train mode at 4 layers and capacity factor E/k (no
    drops), eight requests at batch 8 against batch 1 at 1.25 (every
    request without a dropped decode pick equal, or parting at a
    near-tie), the card's forward and MoE dispatch against the CPU's at
    depth 2 with drops in the prefill; (c) kimi-k2-1t-a32b in bf16 at full
    width, depth cut to 2 (1 dense + 1 MoE of 384 experts top-8, GQA
    64/8), served (8 requests, prompt 128, 16 new tokens, 8 slots, s_max
    256) with 16a's metrics.  It launches none of B1-B3 (counters);
18. Mamba and the encoder-decoder at full width, random weights, TF32
    off: (a) falcon-mamba-7b in bf16 at full depth (64 Mamba layers,
    d_inner 8192, N 16) served by launch/serve.py's loop (16 requests,
    prompt 256 through the chunked scan, 64 new tokens, 8 slots, s_max
    512) with 16a's metrics, then one prefill of 256 and one of 200 (the
    per-step scan) timed apart; (b) in float32 at its width, depth cut:
    teacher-forced decode of 32 positions after prompts of 256 and 200
    against train mode at 4 layers, eight requests at batch 8 against
    batch 1, the card's forward against the CPU's at 2 layers; (c)
    jamba-v0.1-52b in bf16 at full width, depth cut to two of its four
    periods (14 Mamba + 2 attention layers, 8 MoE of 16 experts top-2),
    served (16 requests, prompt 256, 32 new tokens, 8 slots, s_max 512)
    with 17a's metrics, and in float32 the card's forward and MoE
    dispatch against the CPU's at layers 4-5 of its period (attention,
    then Mamba with the MoE) at capacity factor E/k; (d) whisper-base in bf16 at full width and depth
    (6 + 6 layers, learned positions), 1500 audio-stub frames per request
    (16 requests, prompt 32, 64 new tokens, 8 slots, s_max 448) with
    16a's metrics and the ck/cv cache bytes, and in float32 at full depth
    teacher-forced decode against train mode and the card against the
    CPU.  It launches none of B1-B3 (counters);
19. training, TF32 off: (a) stablelm-1.6b at full width and depth in
    float32 with AdamW through launch/train.py's main, 12 steps of 4 x
    512 tokens: finite, falling losses, step ms (median after 2 warm-up
    steps, CUDA events), tokens/s, the optimizer's share, peak memory,
    the step's bound and share, and a profiler trace of one step (busy
    share, top aten ops); (b) the 100m preset for 12 steps with a
    checkpoint every 5, resumed from step 10 under deterministic
    algorithms: the same losses bit for bit, and one save and one restore
    of its state timed; (c) jamba-v0.1-52b's layers 4-5 (attention, then
    Mamba with the MoE) in float32 at capacity factor E/k, batch 1 at 256
    and 72 tokens (both scan paths): the loss and every parameter's
    gradient, card against CPU.  It launches none of B1-B3 (counters);
20. the dry run held against the card, TF32 off: (a) the op census of
    19a's cell (stablelm-1.6b float32, AdamW, 4 x 512, a world of one)
    run on fake tensors, its FLOPs against a torch.profiler trace's
    (with_flops) of one real step within 1% and its peak against
    max_memory_allocated within 10%; (b) remat at the reference's
    sequence of 4096: for "full" and "dots" the largest batch whose
    census peak stays under 75 GB, two steps at it (predicted against
    measured peak, step ms against the step's bound), and at 4 x 512 the
    gradients with each mode bit-equal to those without under
    deterministic algorithms; (c) the dry run's records of stablelm-1.6b
    train_4k and the SA cell on the single-pod mesh, computed on the
    host over a fake world of 256.  It launches none of B1-B3;
21. the training state as each rank's blocks (distributed/sharded.py),
    TF32 off: (a) 19a's cell through launch/train.py's main under a
    world-of-one NCCL group, so by the sharded path on a (1, 1) mesh: 4
    steps under deterministic algorithms bit-equal to the unsharded
    path's, then 12 timed steps beside 19a's, the rank's state bytes
    beside bytes_under_specs, peak memory; (b) a checkpoint of the 100m
    preset saved by the sharded path and restored by the unsharded one,
    and the other way round, bit for bit; (c) the dry run's train_4k
    records of stablelm-1.6b, deepseek-v2-lite-16b and kimi-k2 on the
    host, the compute cut over 'model': the state per rank against
    state_under_specs, the peak against 80 GiB and beside the replicated
    compute's.  It launches none of B1-B3;
22. the compute cut over 'model' (distributed/tensor_parallel.py), TF32
    off: (a) stablelm-1.6b in bf16 at full width and depth through the
    sharded prefill and decode steps (a mesh and specs over a
    world-of-one NCCL group: every group of one) against the unsharded
    steps, 2 requests x 16 tokens: the same tokens, tick ms beside tick
    ms; (b) the dry run's prefill_32k and decode_32k records of
    stablelm-1.6b and deepseek-v2-lite-16b on the host: the parameters
    per rank against bytes_under_specs, the tensor-parallel all-reduces;
    (c) granite-20b, internlm2-20b and internvl2-2b in bf16 at full width
    and depth served by launch/serve.py's loop (one request, prompt 32, 8
    ticks) with 16a's metrics.  It launches none of B1-B3;
23. the caches cut on their sequence (distributed/sequence.py), TF32 off:
    (a) gemma3-4b in bf16 at full width and depth, batch 1 at the
    long_500k cell's cache of 524288 positions, through the sharded
    prefill and decode steps over a world-of-one NCCL group (every
    sequence group of one, no collective) against the unsharded steps: a
    prompt of 64 and 8 ticks, the same tokens bit for bit, the tick
    beside its byte bound, the busy share, the cache bytes, the peak and
    the float32 casts of the cache timed apart; (b) the merge of 16 slot
    blocks' partial softmaxes, no collective, against the whole
    softmax·v of one gemma3-4b global layer's decode and of one
    deepseek-v2-lite-16b MLA layer's (kv_lora 512) at 524288 slots;
    (c) the dry run's long_500k records of gemma3-4b, jamba-v0.1-52b and
    falcon-mamba-7b and the decode_32k records of gemma3-4b, granite-20b,
    internlm2-20b and deepseek-v2-lite-16b with seq_shard_kv on the
    host: each peak beside PR 25's, the cache bytes per rank against
    cache_under_specs.  It launches none of B1-B3.

The card's name and power limit, then a JSON object with one entry per
kernel, are the two lines before the last; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
sys.path.insert(0, str(ROOT / "src"))

# The H100's peak rates and the kernels' cost models (bounds.py)
from repro_torch.kernels.bounds import (BF16_OPS_PER_S, FP32_OPS_PER_S,  # noqa: E402
                                        HBM_BYTES_PER_S, b1_bounds, b2_bound, b3_bound)

# The F0_g row of the paper's Table 10 as the reference's bench builds it
# (benchmarks/table10_hybrid.py:29-30, 49): the default, paper-faithful
# full variant.  Phase 3 runs the beyond-paper delta variant of the row.
MAIN_CFG = dict(T0=1000.0, T_min=1.0, rho=0.99, N=33, n_chains=16384,
                exchange="sync", seed=0)
DELTA_CFG = dict(MAIN_CFG, use_delta_eval=True)
MAIN_DIM = 512
SCHWEFEL_F_OPT = -418.982887
# Phase sizes: the serving layout of phase 1, the argmin lengths of phase
# 2 and the chain count of phase 5.
SWEEP_DIMS = (32, 512)
WIDE_DIM = 30000          # B1 full's term caches no longer fit in shared memory
N_SLOTS, SLOT_BLK = 64, 256
ARGMIN_SIZES = (1, 5, 16384, 16385, 2**20, 2**20 + 3)
ARGMIN_EDGE_N = 16385              # the all-equal, NaN and unaligned cases
B2_ROUTE_SIZES = (16385, 24576, 32768, 49152, 65536, 2**20)  # one CTA vs grid
V1_CHAINS = 16384
# Slice 2: B3's layout (phase 7), the serving main path (phase 8, the
# cooling schedule of benchmarks/serve_qap_bench.py) and the mixed load.
QAP_SLOTS, QAP_BLK, QAP_STEPS = 128, 512, 40
QAP_SIZES = (2, 5, 10, 12, 20, 31)     # and the kernel's largest n
QAP_BLK_ODD = 96                       # a block that fills no whole CTA
SERVE_CFG = dict(n_slots=128, chains_per_slot=512, macro_k=4)
SERVE_SEEDS = 128                      # requests per QAP instance
QAP_SCHEDULE = dict(T0=50.0, T_min=0.5, rho=0.90, N=40)
QAP_MAX_GAP_PCT = 2.0                  # scripts/bench_gates.toml, qap_committed
QAP_EXACT_PER_INSTANCE = 4
MIXED_CFG = dict(n_slots=64, chains_per_slot=512)
MIXED_REQUESTS = 32
# Slice 5: the elastic open-loop path (phase 10) at phase 8's pool width.
ELASTIC_CFG = dict(n_devices=2, n_slots=64, chains_per_slot=512, macro_k=4,
                   migration_budget=2)
ELASTIC_SCHED = dict(overload="preempt", preemption_budget=2,
                     proactive_degrade=True, high_watermark=0.9,
                     low_watermark=0.5)
ELASTIC_REQUESTS = 192
ELASTIC_MIX = dict(family="mixed", max_slots_per_req=2,
                   finish_deadline_factor=1.5, min_levels_frac=0.5, seed=0)
ELASTIC_ARRIVALS = dict(rate=3.0, burst=8, seed=0)
DRAIN_AT, RESIZE_AT = 24, 48
# Ticks of the scripted preempt, migrate and degrade (each retried four
# levels later until a request it can act on is active; the resize, until
# shard 1 has retired).
OPS_AT = dict(preempt=12, migrate=16, degrade=20)
# Slice 6.  Phase 11, the paper's Table 9: every suite problem at the width
# and N of the reference bench's full mode (benchmarks/table9_suite.py:21),
# the depth cut to its quick ladder (T0 = 50, T_min = 0.1, rho = 0.85).
SUITE_CFG = dict(T0=50.0, T_min=0.1, rho=0.85, N=100, n_chains=16384, seed=0,
                 record_history=False)
SUITE_LEVELS = 39
SUITE_WIN = 1.05                       # V2 <= 1.05 V1, as the bench counts it
# Phase 12, the paper's Table 7 at the bench's full configuration
# (benchmarks/table7_precision.py:30-31); the device time per level of the
# torch sweep is profiled over its first levels.
TABLE7_CFG = dict(T0=1000.0, T_min=0.01, rho=0.99, N=100, n_chains=16384,
                  record_history=False)
TABLE7_DIM = 16
TABLE7_PROFILE_LEVELS = 3
TABLE7_WARM_LEVELS = 20     # the warm run: the ladder's first levels
# Phase 13, PT and PA serving: the mixed load on phase 9's pool, and a
# pure-PA load on phase 8's pool for the first levels of a ladder (where
# every weight is near the full scale).
TEMPER_REQUESTS = 96
TEMPER_CFG = MIXED_CFG
PA_LOAD = dict(objective="schwefel", dim=16, T0=1000.0, T_min=500.0, rho=0.9, N=25)
# Slice 7.  Phase 14a serves phase 10's load with telemetry off, then on
# twice.  Phase 14b is the reference's autoscaler bench
# (benchmarks/serve_autoscale_bench.py:117-160) at 512 chains per slot in
# place of its 8: the tick-clock dynamics depend on slots, not chains.
AUTOSCALE_REQUESTS = 64
AUTOSCALE_MIX = dict(max_slots_per_req=2, finish_deadline_factor=1.9, min_levels_frac=0.5,
                     seed=0)
AUTOSCALE_ARRIVALS = dict(rate=0.13, period=160.0, amplitude=1.0, seed=7)
AUTOSCALE_CFG = dict(n_slots=4, chains_per_slot=512)
AUTOSCALE_CTL = dict(min_shards=1, max_shards=4, sample_every=4, headroom=1.25, low_util=0.5,
                     window=2, cooldown=8)
AUTOSCALE_MIN_SAVING_PCT = 20.0        # scripts/bench_gates.toml, autoscale_committed
# Slice 8.  Phase 15a runs phase 4's cell (and phase 5's and phase 3's)
# through the sharded ladder over a world-size-1 NCCL group: one card
# cannot hold two NCCL ranks.  Phase 15b is the reference's autotuner
# bench problem (benchmarks/autotune_bench.py:15, 27-28), widened from
# five architectures to all ten, with the example's gate
# (examples/sharding_autotuner.py:54).
AUTOTUNE_PROBLEM = dict(seq=4096, batch=256, chips=256)
AUTOTUNE_CHAINS = 256
AUTOTUNE_MAX_GAP = 0.02
AUTOTUNE_MESH_ARCH = "deepseek-v2-lite-16b"  # the example's default
# Slice 9.  Phase 16 serves the dense LLM scaffold at full width and depth
# in the reference's serving dtypes (bf16 parameters and compute,
# src/repro/launch/steps.py:311-314), random weights from a seed.  16a:
# stablelm-1.6b (global attention, MHA); 16c: gemma3-4b, whose prompt is
# longer than its 1024-token window, so prefill takes the cache's roll.
# Prompt plus max_new stays within s_max: a global layer's buffer would
# wrap past it.
LLM_SERVE = dict(arch="stablelm-1.6b", requests=16, prompt=256, max_new=64, batch=8, s_max=512)
LLM_WINDOW = dict(arch="gemma3-4b", requests=4, prompt=1536, max_new=32, batch=4, s_max=2048)
# 16b, float32 at stablelm's width: teacher-forced decode of positions
# 64-95 after a 64-token prefill (tests/test_archs_smoke.py:83-111 at full
# width), the card's forward against the CPU's at depth 2, and eight
# requests at batch 8 against batch 1.  Logits at the reference's own
# tolerance (tests/test_archs_smoke.py:97-98).
LLM_TF = dict(prompt=64, decode=32, s_max=128)
LLM_CPU = dict(layers=2, prompt=32)
LLM_BATCH = dict(requests=8, prompt=64, max_new=16, s_max=128)
LLM_RTOL = LLM_ATOL = 2e-4
# Slice 10.  Phase 17 serves MLA and the local MoE in bf16, random
# weights from a seed.  17a: deepseek-v2-lite-16b at full width and depth
# (27 layers: 1 dense + 26 MoE, 64 routed experts top-6 + 2 shared).
# Prompt plus max_new stays within s_max: the MLA cache wraps past it.
LLM_MOE = dict(arch="deepseek-v2-lite-16b", requests=8, prompt=256, max_new=32, batch=8,
               s_max=512)
# 17b, float32 at deepseek's width, depth cut: (1) 4 layers (1 dense + 3
# MoE) at capacity factor E/k, so C >= T and no pick drops, teacher-forced
# decode against train mode; (2) 2 layers (1 dense + 1 MoE) at the
# config's own 1.25, card against CPU with drops in the prefill; (3) the
# 4 layers at 1.25, eight requests at batch 8 against batch 1.
LLM_MOE_TF = dict(layers=4, prompt=64, decode=32, s_max=128)
LLM_MOE_CPU = dict(layers=2, prompt=32)
LLM_MOE_BATCH = dict(requests=8, prompt=64, max_new=16, s_max=128)
# Router probabilities a few float32 roundings of the router product can
# cross: a token whose picks differ between card and CPU must be this near.
ROUTER_NEAR_TIE = 1e-6
# 17c: kimi-k2-1t-a32b at full width, its 61 layers (2.05 TB in bf16) cut
# to 2: 1 dense + 1 MoE of 384 experts top-8 behind GQA 64/8 attention.
LLM_KIMI = dict(arch="kimi-k2-1t-a32b", layers=2, requests=8, prompt=128, max_new=16,
                batch=8, s_max=256)
# Slice 11.  Phase 18 serves Mamba and the encoder-decoder in bf16, random
# weights from a seed.  18a: falcon-mamba-7b at full width and depth (64
# Mamba layers, d_inner 8192, N 16, dt_rank 256); a prompt of 256 takes
# the chunked scan (chunk 256), and one extra prefill of LLM_STEP_PROMPT
# the per-step scan.
LLM_MAMBA = dict(arch="falcon-mamba-7b", requests=16, prompt=256, max_new=64, batch=8,
                 s_max=512)
LLM_STEP_PROMPT = 200
# 18b, float32 at falcon-mamba's width, depth cut: 4 layers, teacher-forced
# decode of 32 positions after a prompt of 256 (chunked prefill against
# the per-step train mode over 288) and of 200; 2 layers, card against
# CPU; 4 layers, eight requests at batch 8 against batch 1.
LLM_MAMBA_TF = dict(layers=4, prompts=(256, LLM_STEP_PROMPT), decode=32)
LLM_MAMBA_CPU = dict(layers=2, prompt=32)
LLM_MAMBA_BATCH = dict(layers=4, requests=8, prompt=64, max_new=16, s_max=128)
# 18c: jamba-v0.1-52b at full width, its 32 layers (102.6 GB in bf16) cut
# to 16, two of the four periods of 8: 14 Mamba + 2 attention layers, 8
# of the 16 with an MoE of 16 experts top-2 (51.6 GB).
LLM_JAMBA = dict(arch="jamba-v0.1-52b", periods=2, requests=16, prompt=256, max_new=32,
                 batch=8, s_max=512)
# 18c.2: float32 at jamba's width, card against CPU, depth cut to layers
# 4-5 of its period (attention with a dense MLP, then Mamba with the MoE):
# the one stack of the three mixers, 3.7 B parameters (14.8 GB), at
# capacity factor E/k (no drops).
LLM_JAMBA_CPU = dict(layers=(4, 6), prompt=64)
# 18d: whisper-base at full width and depth (6 encoder + 6 decoder layers,
# learned positions), 1500 audio-stub frames per request, s_max 448 (its
# natural decoder context); float32 checks at full depth.
LLM_WHISPER = dict(arch="whisper-base", requests=16, prompt=32, max_new=64, batch=8, s_max=448)
LLM_WHISPER_TF = dict(prompt=32, decode=32, s_max=96)
# Slice 12.  Phase 19 trains, TF32 off.  19a: stablelm-1.6b at full width
# and depth through launch/train.py's main in the registry's float32 with
# AdamW, its 256 x 4096 tokens per step cut to 4 x 512: the sequence
# because float32 S x S scores at 4096 do not fit one card without remat,
# the batch to keep the phase short; two warm-up steps before the medians.
# Then the same driver at `wide_batch` sequences per step, the largest
# multiple of 4 whose predicted peak leaves a margin of the card's 80 GB
# (the headroom the batch cut leaves), for `wide_steps` steps.
TRAIN_MAIN = dict(arch="stablelm-1.6b", seq=512, batch=4, steps=12, warmup=2,
                  wide_batch=12, wide_steps=6)
# 19b: the 100m preset (8 x 512) for 12 steps, a checkpoint every 5, then
# --resume from step 10: its losses must equal the first run's.
TRAIN_RESUME = dict(preset="100m", steps=12, every=5)
# 19c: gradients, card against CPU, float32 at jamba's width: layers 4-5 of
# its period (18c.2's cut) at capacity factor E/k, batch 1 at 256 tokens
# (the chunked scan) and 72 (the per-step scan); the loss at rtol 2e-4,
# each gradient within 1e-4 of its largest |value|.
TRAIN_GRAD = dict(arch="jamba-v0.1-52b", layers=(4, 6), seqs=(256, 72))
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 2e-4, 1e-4

# Slice 13 (phase 20): the dry run (launch.dryrun, launch.opcensus) held
# against the card.  20a: phase 19a's cell (stablelm-1.6b float32, AdamW,
# 4 x 512, a world of one); the census's FLOPs against the profiler's
# within 1%, its peak against max_memory_allocated within 10%.  20b: the
# same model at the reference's sequence of 4096 with remat "full" and
# "dots", each at the largest batch whose predicted peak stays under
# `peak_limit`, `steps` steps; gradients with each remat mode against
# none at 4 x 512, bit for bit under deterministic algorithms.  20c: the
# dry run's records of stablelm-1.6b train_4k and the SA cell on the
# single-pod mesh, on this host.
DRYRUN_CELL = dict(arch="stablelm-1.6b", seq=512, batch=4)
DRYRUN_REMAT = dict(arch="stablelm-1.6b", seq=4096, peak_limit=75e9, steps=2)
DRYRUN_FLOPS_RTOL, DRYRUN_PEAK_RTOL = 0.01, 0.10
DRYRUN_HOST = dict(arch="stablelm-1.6b", shape="train_4k")

# Slice 14 (phase 21): the training state as each rank's blocks by the
# reference's specs (distributed/sharded.py).  21a: phase 19a's cell
# through launch/train.py's main under a world-of-one NCCL group, so by
# the sharded path on a (1, 1) mesh: `det_steps` steps under
# deterministic algorithms against the unsharded path from the same
# seed, bit for bit, then 19a's 12 timed steps.  21b: a checkpoint of the
# `ckpt_preset` state after one step, saved by the sharded path (async)
# and restored by the unsharded one, and saved by the unsharded path and
# restored by the sharded one, bit for bit.  21c: the dry run's train
# records of `host_archs` on the single-pod mesh, on this host, kimi-k2's
# depth cut 61 -> `host_depth` (1 dense + 3 MoE layers: every leaf kind;
# the whole depth took 76 s of the host's time).
SHARDED = dict(det_steps=4, ckpt_preset="100m",
               host_archs=("stablelm-1.6b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"),
               host_shape="train_4k", host_depth={"kimi-k2-1t-a32b": 4},
               # 21c's peaks per rank in MiB with the compute replicated over
               # 'model' (PERF.md section 6), printed beside this run's
               replicated_peak_mib={"stablelm-1.6b": 202945.3, "deepseek-v2-lite-16b": 198239.4})

# Slice 15 (phase 22): the compute cut over 'model' as the specs cut the
# leaves (distributed/tensor_parallel.py).  22a: `arch` in bf16 at full
# width and depth through make_prefill_step and make_serve_step with a
# mesh and specs over a world-of-one NCCL group (a (1, 1) mesh: every
# group of one, so every collective and slice skipped), `requests`
# prompts of `prompt` tokens and `max_new` tokens each, against the same
# steps unsharded, `pairs` pairs of runs in turns.  22b: the dry run's
# `serve_shapes` records of `serve_archs` on the single-pod mesh, on this
# host: each rank's parameters equal to bytes_under_specs.  22c: the three dense
# architectures no earlier phase serves, at full width and depth through
# launch/serve.py's loop: one request, a short prompt, 8 decode ticks.
TP_SERVE = dict(arch="stablelm-1.6b", requests=2, prompt=64, max_new=16, s_max=128, pairs=3,
                serve_archs=("stablelm-1.6b", "deepseek-v2-lite-16b"),
                serve_shapes=("prefill_32k", "decode_32k"))
LLM_DENSE_REST = dict(archs=("granite-20b", "internlm2-20b", "internvl2-2b"), requests=1,
                      prompt=32, max_new=9, batch=1, s_max=64)
# The four-card record (four_cards, not run by main, which needs one
# card): launch/train.py under torchrun over four cards, `arch` float32
# with AdamW, `batch` sequences of `seq` tokens, `steps` steps, for each
# --model-parallel; every run's losses against the --model-parallel 1
# run's (the compute not cut over 'model') at ORDER_TOL.
FOUR_CARDS = dict(arch="stablelm-1.6b", seq=512, batch=8, steps=12, timed_from=2,
                  model_parallel=(1, 2, 4))
# Slice 16 (phase 23): the caches cut on their sequence
# (distributed/sequence.py).  23a: `arch` in bf16 at full width and depth,
# batch 1, a cache of `s_max` positions (the long_500k cell's), through
# the sharded steps over a world-of-one NCCL group (every sequence group
# of one) against the unsharded ones: a prompt of `prompt`, `ticks`
# ticks.  23b: one global layer's decode of `arch` and one MLA layer's
# of `mla_arch` at `s_max` slots, random bf16 inputs whose scores have a
# standard deviation of about `score_std`, cut into `blocks` slot blocks
# whose partials are merged with no collective, against the whole
# softmax·v; the last `masked` slots unwritten (int32 max), so the last
# block is partly masked.  MERGE_TOL: the largest |merged - whole| over
# the largest |value| of the values: float32's eps is 6.0e-8; each form
# sums 524288 products of weights that add to one through blocked
# reductions (at most log2(524288) = 19 roundings of a partial sum no
# larger than the largest |value|), and the merge rescales each block's
# sums once (2 roundings), so about 21 eps = 1.3e-6 of it; 1e-5 leaves
# 8x, where a block merged without its rescale, or missing, moves the
# output by that block's weight.  23c: the dry run's records on the
# host: `long` (long_500k) and `knob` (decode_32k with seq_shard_kv),
# each peak beside PR 25's in GiB (PERF.md section 4, my CPU dry run,
# PR 25: the default decode_32k records for the knob's); jamba's
# long_500k peak under `jamba_limit_gib` (its expert stacks kept cut over
# 'model' at batch 1, where moe_ep is off: 8.27 GiB when they were
# gathered whole, PR 26).
SEQ_CUT = dict(arch="gemma3-4b", prompt=64, ticks=8, s_max=524288, blocks=16, masked=1000,
               mla_arch="deepseek-v2-lite-16b", score_std=4.0, jamba_limit_gib=4.0,
               long=("gemma3-4b", "jamba-v0.1-52b", "falcon-mamba-7b"),
               knob=("gemma3-4b", "granite-20b", "internlm2-20b", "deepseek-v2-lite-16b"),
               pr25_peak_gib={("gemma3-4b", "long_500k"): 12.4,
                              ("jamba-v0.1-52b", "long_500k"): 15.8,
                              ("falcon-mamba-7b", "long_500k"): 0.4,
                              ("gemma3-4b", "decode_32k"): 8.1, ("granite-20b", "decode_32k"): 7.0,
                              ("internlm2-20b", "decode_32k"): 48.5,
                              ("deepseek-v2-lite-16b", "decode_32k"): 8.3})
MERGE_TOL = 1e-5
# The four-card record's sequence-cut decodes (four_cards): shrink(gemma3-4b)
# float32, batch 1, a prompt of `prompt` and `ticks` ticks in caches of
# `s_max`, over (4, 1) (the cache cut over 'data') and over (1, 4) with
# seq_shard_kv and `kv_heads` KV heads (4 would divide 'model' and leave
# the cache whole), each rank's tokens against its unsharded steps'.
FOUR_CARDS_SEQ = dict(arch="gemma3-4b", prompt=12, ticks=9, s_max=24, kv_heads=2,
                      runs=(((4, 1), False), ((1, 4), True)),
                      repair=("jamba-v0.1-52b", (1, 4)))
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
# Slice 17 (phase 24): seq_parallel (Megatron-SP: the stream between
# layers each rank's block of the sequence over 'model') and the routed
# experts kept cut over 'model' without expert parallelism.  A 'model'
# group of more than one rank needs more than one card (NCCL refuses two
# ranks on one GPU), so the phase is the dry run's knob records on the
# card's host: train_4k of `train` and prefill_32k of `prefill` with
# seq_parallel, each beside its default record (phases 21c and 22b of
# this run, HOST_RECORDS, or made here when the phase runs alone): the
# peak per rank, each train_4k peak at least `min_drop_gib` lower, and
# the wire bytes over 'model' by collective kind; every record's state or
# parameters equal to the specs' bytes.  The four-card record
# (four_cards) trains FOUR_CARDS' cell with seq_parallel over (2, 2) and
# (1, 4) against the --model-parallel 1 run's losses, and decodes
# FOUR_CARDS_SEQ's `repair` at batch 1 (moe_ep off) over (1, 4).
SEQ_PAR = dict(train=("stablelm-1.6b", "deepseek-v2-lite-16b"), prefill=("stablelm-1.6b",),
               min_drop_gib=4.0, four_cards_mp=(2, 4))
HOST_RECORDS = {}   # (arch, shape) -> the default dry-run record phases 21c and 22b wrote


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- helpers
def slot_layout(dim, gen, *, seed=0, step0_base=2**31 - 8, n_slots=None):
    """The serving engine's layout: ``n_slots`` slots of ``blk`` chains,
    mixed kids, seeds, step0 in [step0_base, step0_base + 16) (wrapping
    past 2^32 when it is near), shuffled chain bases, half the slots
    dead."""
    from repro_torch.kernels import objective_math as om
    n_slots, blk = n_slots or N_SLOTS, SLOT_BLK
    rs = np.random.default_rng(seed)
    kids = (np.arange(n_slots) % om.N_KIDS).astype(np.int32)
    lo = np.array([om.BOX[k][0] for k in kids], np.float32)
    hi = np.array([om.BOX[k][1] for k in kids], np.float32)
    u = torch.rand(n_slots * blk, dim, generator=gen, device=DEV)
    lo_c = torch.from_numpy(np.repeat(lo, blk)).to(DEV)[:, None]
    hi_c = torch.from_numpy(np.repeat(hi, blk)).to(DEV)[:, None]
    return dict(
        x=(lo_c + u * (hi_c - lo_c)).contiguous(),
        kid=torch.from_numpy(kids).to(DEV),
        T=torch.from_numpy((10.0 ** rs.uniform(-1, 2, n_slots)).astype(np.float32)).to(DEV),
        seed=rs.integers(0, 2**32, n_slots, dtype=np.uint64),
        step0=((step0_base + rs.integers(0, 16, n_slots)) % 2**32).astype(np.uint64),
        chain_base=(rs.permutation(n_slots) * blk).astype(np.uint64),
        live=torch.from_numpy((np.arange(n_slots) % 2).astype(np.int32)).to(DEV),
        blk=blk)


def _per_row(v, blk, n):
    a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).reshape(-1)
    return np.repeat(a, blk) if a.size > 1 else np.full(n, a[0])


def flip_margin_ok(x_prev, kid, T, seed, cidx, step, variant):
    """The accept decision that parts two trajectories must sit within
    float32 rounding of its threshold: recompute it in float64."""
    from repro_torch.kernels import objective_math as om
    from repro_torch.kernels import ref, rng
    dim = x_prev.shape[0]
    rbits, uval, uacc = rng.draws3(seed, torch.tensor([cidx]), step)
    d = int(rbits[0]) % dim
    lo, _, width = om.box_f32(kid)
    x0 = torch.as_tensor(x_prev, dtype=torch.float64)[None]
    x1 = x0.clone()
    x1[0, d] = float(ref.proposal(lo, width, uval))
    f0 = float(om.full_eval(kid, x0, dim))
    f1 = float(om.full_eval(kid, x1, dim))
    arg = -(f1 - f0) / T
    scale = dim * (abs(f0) + abs(f1) + 1.0) * (2 if variant == "delta" else 1)
    tol = 8 * scale * 2.0 ** -24 / T + 2.0 ** -20
    u = float(uacc[0])
    return u > 0.0 and -80 < arg < 80 and abs(math.log(u) - arg) <= tol


def trace_flips(rows, x_in, run, ctl, n_steps, variant):
    """Replay the sweep for 1..n_steps steps through kernel and plain
    version on the whole input (a reduction in the plain version may round
    differently at another row count) and check, for each differing row,
    that the first step where the two part is a near-threshold decision."""
    pending = {int(r): x_in[r].cpu().numpy() for r in rows}
    for k in range(1, n_steps + 1):
        (xk, _), (xp, _) = run(k)
        same = (xk == xp).all(1).cpu().numpy()
        for r in [r for r in pending if not same[r]]:
            ok = flip_margin_ok(pending.pop(r), int(ctl["kid"][r]), float(ctl["T"][r]),
                                int(ctl["seed"][r]), int(ctl["cidx"][r]),
                                (int(ctl["step0"][r]) + k - 1) & 0xFFFFFFFF, variant)
            check(ok, f"row {r} parted at step {k - 1} far from its threshold")
        x_now = xk.cpu().numpy()
        for r in pending:
            pending[r] = x_now[r]
    check(not pending, f"rows {sorted(pending)} differ at the end but replay identically")


def compare_sweep(name, x_in, run, ctl, n_steps, variant, dead_rows=None):
    """The parity contract between kernel and plain version on the card.
    ``run(k)`` returns the kernel's and the plain version's (x, f) after k
    steps from ``x_in``."""
    (xk, fk), (xp, fp) = run(n_steps)
    check(bool(torch.isfinite(fk).all()) and bool(torch.isfinite(xk).all()),
          f"{name}: non-finite kernel output")
    same = (xk == xp).all(1)
    share = float(same.float().mean())
    # Rows within rtol 2e-4 agree; a row beyond it took another accept
    # decision somewhere, and must trace to a near-threshold one.
    close = torch.isclose(xk, xp, rtol=2e-4, atol=2e-4).all(1)
    rows = np.flatnonzero(~close.cpu().numpy())
    err = float((fk[close] - fp[close]).abs().max()) if bool(close.any()) else 0.0
    tol_ok = bool(torch.allclose(fk[close], fp[close], rtol=2e-3, atol=2e-3))
    log(f"  {name}: rows bit-equal {share:.6f}, {len(rows)} rows beyond rtol 2e-4, "
        f"max |f_kernel - f_plain| on the others {err:.3e}")
    check(share >= 0.95, f"{name}: only {share:.4f} of rows bit-equal")
    check(tol_ok, f"{name}: carried f outside rtol 2e-3")
    if len(rows):
        trace_flips(rows, x_in, run, ctl, n_steps, variant)
        log(f"  {name}: every differing row parts at a near-threshold decision")
    if dead_rows is not None:
        check(bool(torch.equal(xk[dead_rows], x_in[dead_rows])),
              f"{name}: dead slots changed")
    return err


def cuda_ms(fn, n=25, warmup=3):
    """Median time of fn() over n calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# The CUDA calls (`cuda*` and the lower-level `cu*`) that put work on the
# card, as a torch.profiler trace names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def trace_gap(n_launched, n_done, busy_ms, wall_ms, bound_ms=None):
    """Why a profiler trace's device time cannot be taken, or None: it
    holds device work for fewer of its ``n_launched`` launches than all
    (``n_done``), its device time (``busy_ms``) exceeds the CUDA-event
    wall of the same calls (``wall_ms``; one stream runs one kernel at a
    time), or it lies under ``bound_ms``, the least time the work can
    take."""
    if n_done == 0:
        return "no device activity in the trace"
    if n_done < n_launched:
        return f"the trace holds device work for {n_done} of {n_launched} launches"
    if busy_ms > 1.05 * wall_ms + 0.002:
        return f"device {busy_ms:.4f} ms exceeds the wall {wall_ms:.4f} ms"
    if bound_ms is not None and busy_ms < bound_ms:
        return f"device {busy_ms:.4f} ms under the bound {bound_ms:.4f} ms"
    return None


def profile_calls(fn, n, bound_ms=None, attempts=3, warm_s=0.01):
    """A torch.profiler (CUPTI) trace of n calls of fn with CUDA events
    around them, taken again, up to ``attempts`` times, while
    ``trace_gap`` finds it incomplete.  A trace that starts cold can lose
    the kernels of its first launches (seen after phase 11), so calls run
    for ``warm_s`` (one at least) before the span ``measured``, and only
    the device work of launches inside it counts, matched to them by
    correlation id.  Returns
    ([(name, ms) of each device op], device ms per call, complete or
    not)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_warm = time.perf_counter()
            while True:
                fn()
                torch.cuda.synchronize()
                if time.perf_counter() - t_warm >= warm_s:
                    break
            with record_function("measured"):
                a.record()
                for _ in range(n):
                    fn()
                b.record()
                torch.cuda.synchronize()
        raw = list(prof.profiler.kineto_results.events())
        span = next(e for e in raw if e.name() == "measured")
        lo, hi = span.start_ns(), span.start_ns() + span.duration_ns()
        launched = {e.correlation_id() for e in raw
                    if e.device_type() == DeviceType.CPU and e.name() in LAUNCH_CALLS
                    and lo <= e.start_ns() <= hi}
        dev = [(e.name(), e.duration_ns() / 1e6) for e in raw
               if e.device_type() == DeviceType.CUDA and e.correlation_id() in launched]
        done = len({e.correlation_id() for e in raw
                    if e.device_type() == DeviceType.CUDA} & launched)
        busy = sum(ms for _, ms in dev) / n
        gap = trace_gap(len(launched), done, busy, a.elapsed_time(b) / n, bound_ms)
        if gap is None:
            return dev, busy, True
        log(f"  trace {attempt} of {attempts} not taken: {gap}")
    return dev, busy, False


def device_ms(fn, n=50, bound_ms=None):
    """Device time per fn() call from a complete profiler trace of n calls
    (``profile_calls``): the kernels and memory operations it holds,
    summed.  Returns (ms, or None when no trace was complete, device ops
    per call, their names)."""
    dev, busy, ok = profile_calls(fn, n, bound_ms)
    return (busy if ok else None), len(dev) / n, sorted({name[:60] for name, _ in dev})


# ---------------------------------------------------------------- phases
def phase0_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    from repro_torch.kernels import _build
    # ptxas's report (registers, shared memory, spills) of B1 and B2, one
    # nvcc each, started beside the library's build.
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    ptxas = {name: subprocess.Popen(
        [_build._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
         str(_build.BUILD_DIR / f"{name}.cubin"), str(_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("metropolis_sweep", "reduce_min", "qap_sweep")}
    probe = term_probe_start()
    _build.lib()
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, kernel build {_build.build_seconds:.2f} s")
    for name, proc in ptxas.items():
        out, _ = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"nvcc -Xptxas -v {name}.cu failed:\n{out}")
        for line in out.splitlines():
            if "Compiling entry function" in line or "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    global TERM_INSTR
    TERM_INSTR = term_probe_count(probe)
    log(f"  one Schwefel term (full_terms): {TERM_INSTR} SASS instructions on its "
        "fast path (probe kernel less a copy kernel)")
    return smi.stdout.strip().splitlines()[0]


TERM_INSTR = None  # SASS instructions of one Schwefel term, from phase 0
TERM_PROBE = """#include "objective_math.cuh"
extern "C" __global__ void probe_term(const float* x, float* y) {
    float ta, tb;
    sa::full_terms(sa::KID_SCHWEFEL, x[threadIdx.x], threadIdx.x, ta, tb);
    y[threadIdx.x] = ta;
}
extern "C" __global__ void probe_copy(const float* x, float* y) {
    y[threadIdx.x] = x[threadIdx.x];
}
"""


def term_probe_start():
    """Compile a kernel that evaluates one Schwefel term (the header B1
    uses) and one that copies, beside the library's build."""
    from repro_torch.kernels import _build
    src = _build.BUILD_DIR / "term_probe.cu"
    src.write_text(TERM_PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return subprocess.Popen(
        [_build._nvcc(), *flags, "-I", str(_build.CSRC), "-cubin", "-o",
         str(_build.BUILD_DIR / "term_probe.cubin"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def term_probe_count(proc):
    """SASS instructions of one term: the probe's instructions from its
    entry to its first EXIT (the path sinf takes for |arguments| below
    105615, its slow reduction lying after EXIT), less the copy kernel's."""
    import re
    from repro_torch.kernels import _build
    out, _ = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"nvcc term probe failed:\n{out}")
    cubin = _build.BUILD_DIR / "term_probe.cubin"
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cubin)], capture_output=True,
                          text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, False]
        elif fn and re.search(r"/\*[0-9a-f]{4}\*/\s+\S", line) and not counts[fn][1]:
            counts[fn][0] += 1
            counts[fn][1] = "EXIT" in line
    check({"probe_term", "probe_copy"} <= set(counts), f"probe SASS: {sorted(counts)}")
    return counts["probe_term"][0] - counts["probe_copy"][0]


def phase1_sweep(gen):
    from repro_torch.kernels.metropolis_sweep import (metropolis_sweep_kernel,
                                                      metropolis_sweep_plain)
    log(f"phase 1: kernel B1 vs plain version, {N_SLOTS} slots x {SLOT_BLK} "
        "chains")
    worst = {"delta": 0.0, "full": 0.0}
    # (dim, variant, t_chain, n_steps, step0 base): the serving widths, then
    # dim 3 (rows not 16-byte aligned, nearly every step revisits a
    # coordinate) over 100 steps with step0 wrapping past 2^32.
    cases = [(d, v, False, 16, 2**31 - 8) for d in SWEEP_DIMS for v in ("delta", "full")]
    cases.append((SWEEP_DIMS[0], "delta", True, 16, 2**31 - 8))
    cases += [(3, v, t, 100, 2**32 - 60) for v in ("delta", "full") for t in (False, True)]
    for dim, variant, with_t_chain, n_steps, step0_base in cases:
        lay = slot_layout(dim, gen, seed=dim + len(variant) + with_t_chain,
                          step0_base=step0_base)
        blk, n = lay["blk"], lay["x"].shape[0]
        t_chain = None
        if with_t_chain:
            t_chain = (10.0 ** (torch.rand(n, generator=gen, device=DEV) * 3 - 1)).contiguous()
        kw = dict(kid=lay["kid"], blk=blk, variant=variant,
                  chain_base=lay["chain_base"], live=lay["live"], t_chain=t_chain)
        def run(k, lay=lay, kw=kw):
            args = (lay["x"], lay["T"], lay["seed"], lay["step0"])
            out_k = metropolis_sweep_kernel(*args, **kw, n_steps=k)
            torch.cuda.synchronize()
            return out_k, metropolis_sweep_plain(*args, **kw, n_steps=k)
        lane = np.tile(np.arange(blk), n // blk)
        ctl = dict(kid=_per_row(lay["kid"], blk, n),
                   T=(t_chain.cpu().numpy() if with_t_chain else _per_row(lay["T"], blk, n)),
                   seed=_per_row(lay["seed"], blk, n),
                   step0=_per_row(lay["step0"], blk, n),
                   cidx=_per_row(lay["chain_base"], blk, n) + lane)
        dead = torch.from_numpy(_per_row(lay["live"], blk, n) == 0).to(DEV)
        name = f"dim {dim} {variant} n_steps {n_steps}" + (" t_chain" if with_t_chain else "")
        worst[variant] = max(worst[variant], compare_sweep(
            name, lay["x"], run, ctl, n_steps, variant, dead_rows=dead))
    worst["full"] = max(worst["full"], wide_rows_check(gen))
    for variant in ("delta", "full"):
        for dim in (3, MAIN_DIM):
            placement_check(gen, dim, variant)
    return worst


def wide_rows_check(gen, dim=WIDE_DIM, n_slots=4, n_steps=16):
    """B1 full at rows whose term caches do not fit in shared memory (the
    mixed kids of the slot layout need two caches): the kernel that
    re-evaluates every term, against the plain version."""
    from repro_torch.kernels.metropolis_sweep import (metropolis_sweep_kernel,
                                                      metropolis_sweep_plain)
    lay = slot_layout(dim, gen, seed=dim, n_slots=n_slots)
    blk, n = lay["blk"], lay["x"].shape[0]
    kw = dict(kid=lay["kid"], blk=blk, variant="full", chain_base=lay["chain_base"],
              live=lay["live"])

    def run(k):
        args = (lay["x"], lay["T"], lay["seed"], lay["step0"])
        out_k = metropolis_sweep_kernel(*args, **kw, n_steps=k)
        torch.cuda.synchronize()
        return out_k, metropolis_sweep_plain(*args, **kw, n_steps=k)

    lane = np.tile(np.arange(blk), n // blk)
    ctl = dict(kid=_per_row(lay["kid"], blk, n), T=_per_row(lay["T"], blk, n),
               seed=_per_row(lay["seed"], blk, n), step0=_per_row(lay["step0"], blk, n),
               cidx=_per_row(lay["chain_base"], blk, n) + lane)
    dead = torch.from_numpy(_per_row(lay["live"], blk, n) == 0).to(DEV)
    return compare_sweep(f"dim {dim} full n_steps {n_steps} (rows beyond shared memory)",
                         lay["x"], run, ctl, n_steps, "full", dead_rows=dead)


def placement_check(gen, dim, variant, n_steps=MAIN_CFG["N"]):
    """One live slot's chains swept alone, and packed among the other slots
    at blk 256 and at blk 64 (the slot split into four blocks with chain
    bases 64 apart): the rows and their f must be bit-equal."""
    from repro_torch.kernels.metropolis_sweep import metropolis_sweep_kernel
    lay = slot_layout(dim, gen, seed=100 + dim, step0_base=2**32 - 20)
    blk, b = lay["blk"], 5                       # odd slots are live
    rows = slice(b * blk, (b + 1) * blk)
    host = {k: np.asarray(lay[k].cpu() if isinstance(lay[k], torch.Tensor) else lay[k])
            for k in ("kid", "T", "seed", "step0", "chain_base", "live")}
    check(host["live"][b] == 1, "placement check needs a live slot")
    alone = metropolis_sweep_kernel(
        lay["x"][rows].clone(), float(host["T"][b]), int(host["seed"][b]),
        int(host["step0"][b]), kid=int(host["kid"][b]), n_steps=n_steps, blk=blk,
        chain_base=host["chain_base"][b:b + 1], variant=variant)
    packed256 = metropolis_sweep_kernel(
        lay["x"], lay["T"], lay["seed"], lay["step0"], kid=lay["kid"], n_steps=n_steps,
        blk=blk, chain_base=lay["chain_base"], live=lay["live"], variant=variant)
    q = blk // 64

    def split(v):                                 # one entry per 64-chain block
        return np.repeat(v, q)

    packed64 = metropolis_sweep_kernel(
        lay["x"], torch.from_numpy(split(host["T"])).to(DEV), split(host["seed"]),
        split(host["step0"]), kid=torch.from_numpy(split(host["kid"])).to(DEV),
        n_steps=n_steps, blk=64,
        chain_base=split(host["chain_base"].astype(np.int64))
        + np.tile(np.arange(q) * 64, len(host["T"])),
        live=torch.from_numpy(split(host["live"])).to(DEV), variant=variant)
    torch.cuda.synchronize()
    for name, (xo, fo) in (("blk 256", packed256), ("blk 64", packed64)):
        check(torch.equal(xo[rows], alone[0]) and torch.equal(fo[rows], alone[1]),
              f"{variant} dim {dim}: slot {b} packed at {name} differs from the slot alone")
    check(not torch.equal(alone[0], lay["x"][rows]), f"{variant} dim {dim}: the slot did not move")
    log(f"  placement, {variant} dim {dim}: slot {b} alone == packed at blk 256 == "
        f"packed at blk 64, bit for bit ({n_steps} steps)")


def phase2_argmin(gen):
    from repro_torch.kernels.reduce_min import argmin_reduce, argmin_reduce_plain
    log("phase 2: kernel B2 vs plain version")

    def same(a, b):
        return float(a) == float(b) or (math.isnan(float(a)) and math.isnan(float(b)))

    for dtype in (torch.float32, torch.bfloat16):
        cases = []
        for n in ARGMIN_SIZES:
            f = torch.randn(n, generator=gen, device=DEV).to(dtype)
            if n >= 4:                            # ties inside and across tiles
                f[[n // 3, n // 3 + 1, n - 1]] = f.min() - 1
            cases.append((f"n={n}", f, n // 3))  # n = 1: index 0
        n = ARGMIN_EDGE_N
        cases.append(("all equal", torch.full((n,), 0.5, device=DEV, dtype=dtype), 0))
        f = torch.randn(n, generator=gen, device=DEV).to(dtype)
        f[[10, n // 23, n // 2]] = torch.tensor([-math.inf, math.nan, math.nan],
                                                device=DEV, dtype=dtype)
        cases.append(("NaN", f, n // 23))         # the first NaN wins
        for off in (1, 3):                        # slices off 16-byte alignment
            big = torch.randn(n + 8, generator=gen, device=DEV).to(dtype)
            f = big[off:off + n]
            f[[n // 3, n - 1]] = f.min() - 1
            cases.append((f"offset {off}", f, n // 3))
        for name, f, want in cases:
            mp, ip = argmin_reduce_plain(f)
            # The wrapper's route, then each route forced.
            for route in (None, "one CTA", "grid"):
                m, i = argmin_route(f, route)
                check(int(i) == int(ip) == want and same(m, mp),
                      f"B2 {name} {dtype} ({route or 'default'} route): kernel "
                      f"({float(m)}, {int(i)}) vs plain ({float(mp)}, {int(ip)}), "
                      f"expected index {want}")
            log(f"  {name} (n={f.numel()}) {dtype}: ({float(m)}, {int(i)}) exact, "
                "each route")
    return 0.0


def argmin_route(f, route=None):
    """B2 through one CTA, through the grid, or (None) as the wrapper
    chooses by ``ONE_CTA_MAX``."""
    from repro_torch.kernels import reduce_min as rm
    saved = rm.ONE_CTA_MAX
    rm.ONE_CTA_MAX = {None: saved, "one CTA": 2**31 - 1, "grid": 0}[route]
    try:
        return rm.argmin_reduce(f)
    finally:
        rm.ONE_CTA_MAX = saved


def phase3_main_path():
    from repro_torch.core import SAConfig, annealing, hybrid, hybrid_minimize
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce_min as rm
    from repro_torch.objectives import functions as F
    cfg = SAConfig(**DELTA_CFG)
    obj = F.schwefel(MAIN_DIM)
    log(f"phase 3: delta variant hybrid_minimize(schwefel({MAIN_DIM}), {DELTA_CFG}), "
        f"{cfg.n_levels} levels")
    kept = []
    nm_time = []
    real_sweep, real_nm = ops.metropolis_sweep, hybrid.nelder_mead

    def spy_sweep(x, T, seed, step0, **kw):
        out = real_sweep(x, T, seed, step0, **kw)
        if (step0 // kw["n_steps"]) % 100 == 0:
            kept.append((x.contiguous().clone(), T, seed, step0, out))
        return out

    def timed_nm(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real_nm(*a, **kw)
        nm_time.append(time.perf_counter() - t)
        return r

    ops.metropolis_sweep, hybrid.nelder_mead = spy_sweep, timed_nm
    try:
        torch.cuda.synchronize()
        ms.counter.launches = 0
        rm.counter.launches = 0
        t0 = time.perf_counter()
        h = hybrid_minimize(obj, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"metropolis_sweep": ms.counter.launches,
                    "argmin_reduce": rm.counter.launches}
    finally:
        ops.metropolis_sweep, hybrid.nelder_mead = real_sweep, real_nm
    sa_wall = wall - nm_time[0]
    rate = cfg.n_evals / sa_wall
    err_sa = abs(h.sa.f_best - SCHWEFEL_F_OPT)
    err_h = abs(h.f_best - SCHWEFEL_F_OPT)
    log(f"  SA f_best {h.sa.f_best:.6f} (|f - f_opt| {err_sa:.3e}), NM f_best "
        f"{h.nm.f_best:.6f} ({h.nm.n_iters} iters), hybrid |f - f_opt| {err_h:.3e}")
    log(f"  wall {wall:.3f} s (SA {sa_wall:.3f} s, NM {nm_time[0]:.3f} s), "
        f"{cfg.n_evals} proposals, {rate:.4e} proposals/s")
    log(f"  launches on the main path: {launches}")
    check(launches["metropolis_sweep"] == cfg.n_levels,
          f"B1 launched {launches['metropolis_sweep']} times, expected {cfg.n_levels}")
    check(launches["argmin_reduce"] >= cfg.n_levels + 1,
          f"B2 ran {launches['argmin_reduce']} reductions, expected >= {cfg.n_levels + 1}")
    check(all(math.isfinite(v) for v in (h.sa.f_best, h.nm.f_best)), "non-finite f_best")
    check(h.x_best.shape == (MAIN_DIM,), "x_best shape")
    f_x = float(obj(torch.from_numpy(h.x_best).to(DEV)))
    check(abs(f_x - h.f_best) <= 1e-4 * abs(f_x), "hybrid (x, f) not coherent")
    # NM never ends worse than its seed, and SA did real work: a uniform
    # random point scores about 0, |f - f_opt| ~ 419.
    check(err_h <= err_sa < 0.5 * abs(SCHWEFEL_F_OPT),
          f"SA error {err_sa}, hybrid error {err_h}")
    sa_device_share(obj, DELTA_CFG, sa_wall / cfg.n_levels, "sweep_delta_kernel")
    log(f"  sweep vs plain version at levels {[k[3] // cfg.N for k in kept]}")
    from repro_torch.kernels.metropolis_sweep import (metropolis_sweep_kernel,
                                                      metropolis_sweep_plain)
    n = cfg.n_chains
    for x_in, T, seed, step0, out_main in kept:
        def run(k, x_in=x_in, T=T, seed=seed, step0=step0, out_main=out_main):
            kw = dict(kid=0, n_steps=k, blk=256, variant="delta")
            out_k = (out_main if k == cfg.N else
                     metropolis_sweep_kernel(x_in, T, seed, step0, **kw))
            return out_k, metropolis_sweep_plain(x_in, T, seed, step0, **kw)
        ctl = dict(kid=np.zeros(n, np.int64), T=np.full(n, T), seed=np.full(n, seed),
                   step0=np.full(n, step0), cidx=np.arange(n))
        compare_sweep(f"level {step0 // cfg.N}", x_in, run, ctl, cfg.N, "delta")
    return launches, dict(wall_s=wall, sa_s=sa_wall, nm_s=nm_time[0], rate=rate,
                          sa_f=h.sa.f_best, nm_f=h.nm.f_best, result=h)


def sa_device_share(obj, cfg_kw, wall_per_level, b1_kernel, levels=100, **run_kw):
    """The SA ladder of ``cfg_kw`` cut to its first ``levels`` levels under a
    torch.profiler trace: device time per level by kernel (B1 is every
    kernel whose name holds ``b1_kernel``; NCCL's kernels are the sharded ladder's
    all-gathers), against the wall time per level of the unprofiled run.
    ``run_kw`` goes to ``sa_minimize`` (``mesh=``).  Returns the busy
    share, or None when no trace was complete (``profile_calls``), and
    the device ms per level by op name."""
    from repro_torch.core import SAConfig, sa_minimize
    cfg = SAConfig(**{**cfg_kw, "T_min": cfg_kw["T0"] * cfg_kw["rho"] ** (levels - 0.5)})
    check(cfg.n_levels == levels, "profiled ladder cut")
    dev, busy, ok = profile_calls(lambda: sa_minimize(obj, cfg, **run_kw), 1)
    if not ok:
        log("  SA device time per level: not measured")
        return None, {}
    per = {"B1": 0.0, "B2": 0.0, "NCCL": 0.0, "other": 0.0}
    by_name = collections.Counter()
    for name, ms in dev:
        key = ("B1" if b1_kernel in name else
               "B2" if "argmin_kernel" in name else
               "NCCL" if "nccl" in name.lower() else "other")
        per[key] += ms / levels
        by_name[name[:60]] += ms / levels
    n_ops = len(dev)
    busy /= levels
    log(f"  SA device time per level (profiled, first {levels} levels): {busy:.4f} ms "
        f"(B1 {per['B1']:.4f}, B2 {per['B2']:.4f}, NCCL {per['NCCL']:.4f}, other "
        f"{per['other']:.4f} ms in {n_ops / levels:.1f} device ops), against "
        f"{wall_per_level * 1e3:.4f} ms of wall per level unprofiled: the device is busy "
        f"{100 * busy / (wall_per_level * 1e3):.1f}% of the SA wall")
    return busy / (wall_per_level * 1e3), by_name


def phase4_main_path():
    """The F0_g row as the reference's Table 10 bench runs it: sa_minimize
    with the default full variant, every level.  Each level after the
    first sweeps the champion broadcast over the chains, one shared row
    (``counter.shared_start``); three of those inputs, and the last one
    broadcast over 2^20 chains, are held to the plain version."""
    from repro_torch.core import SAConfig, sa_minimize
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import ops
    from repro_torch.objectives import functions as F
    cfg = SAConfig(**MAIN_CFG)
    obj = F.schwefel(MAIN_DIM)
    log(f"phase 4: main path sa_minimize(schwefel({MAIN_DIM}), {MAIN_CFG}), full "
        f"variant, {cfg.n_levels} levels")
    keep_levels = (1, cfg.n_levels // 2, cfg.n_levels - 1)
    kept = []
    real_sweep = ops.metropolis_sweep

    def spy_sweep(x, T, seed, step0, **kw):
        out = real_sweep(x, T, seed, step0, **kw)
        if step0 // kw["n_steps"] in keep_levels:
            check(x.stride(0) == 0, f"level {step0 // kw['n_steps']}: input not one row")
            kept.append((x[0].clone().expand(x.shape), T, seed, step0, out))
        return out

    ops.metropolis_sweep = spy_sweep
    try:
        torch.cuda.synchronize()
        read = counted_launches()
        ms.counter.shared_start = 0
        t0 = time.perf_counter()
        r = sa_minimize(obj, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        shared = ms.counter.shared_start
    finally:
        ops.metropolis_sweep = real_sweep
    log(f"  shared starts {shared} of {got['b1']} B1 launches")
    check(shared == cfg.n_levels - 1,
          f"phase 4: {shared} shared starts, expected {cfg.n_levels - 1}")
    launches = got["b1"]
    err = abs(r.f_best - SCHWEFEL_F_OPT)
    rate = cfg.n_evals / wall
    log(f"  SA f_best {r.f_best:.6f} (|f - f_opt| {err:.3e}), wall {wall:.3f} s, "
        f"{cfg.n_evals} proposals, {rate:.4e} proposals/s, B1 full launches {launches}, "
        f"B2 reductions {got['b2']}")
    check(launches == cfg.n_levels,
          f"B1 full launched {launches} times, expected {cfg.n_levels}")
    # Two champions per level (the exchange's and best-so-far's), the
    # initial one and the final reduce.
    check(got["b2"] == 2 * cfg.n_levels + 2,
          f"B2 ran {got['b2']} reductions, expected {2 * cfg.n_levels + 2}")
    check(math.isfinite(r.f_best) and r.x_best.shape == (MAIN_DIM,), "phase 4 output")
    f_x = float(obj(torch.from_numpy(r.x_best).to(DEV)))
    check(abs(f_x - r.f_best) <= 1e-4 * abs(f_x), "phase 4 (x, f) not coherent")
    check(err < 0.5 * abs(SCHWEFEL_F_OPT), f"phase 4: SA error {err}")
    busy, _ = sa_device_share(obj, MAIN_CFG, wall / cfg.n_levels, "sweep_full")
    from repro_torch.kernels.metropolis_sweep import (metropolis_sweep_kernel,
                                                      metropolis_sweep_plain)
    x_last = kept[-1][0][0]
    kept.append((x_last.expand(1 << 20, MAIN_DIM),) + kept[-1][1:4] + (None,))
    check([k[3] // cfg.N for k in kept] == list(keep_levels) + [keep_levels[-1]],
          f"phase 4: kept levels {[k[3] // cfg.N for k in kept]}")
    for x_in, T, seed, step0, out_main in kept:
        n = x_in.shape[0]
        log(f"  shared start vs plain version, level {step0 // cfg.N}, {n} chains")

        def run(k, x_in=x_in, T=T, seed=seed, step0=step0, out_main=out_main):
            kw = dict(kid=0, n_steps=k, blk=256, variant="full")
            launches = ms.counter.shared_start
            out_k = (out_main if k == cfg.N and out_main is not None else
                     metropolis_sweep_kernel(x_in, T, seed, step0, **kw))
            check(out_main is not None and k == cfg.N
                  or ms.counter.shared_start == launches + 1, "not a shared start")
            return out_k, metropolis_sweep_plain(x_in, T, seed, step0, **kw)
        ctl = dict(kid=np.zeros(n, np.int64), T=np.full(n, T), seed=np.full(n, seed),
                   step0=np.full(n, step0), cidx=np.arange(n))
        compare_sweep(f"level {step0 // cfg.N} shared, {n} chains", x_in, run, ctl,
                      cfg.N, "full")
    return got, dict(wall_s=wall, rate=rate, f_best=r.f_best, busy=busy)


def phase5_v0_v1():
    from repro_torch.core import SAConfig, sa_minimize
    from repro_torch.objectives import functions as F
    obj = F.schwefel(32)
    log("phase 5: V0, V1 and SOS on schwefel(32)")
    base = dict(T0=100.0, T_min=1.0, rho=0.9, N=100, use_delta_eval=True)
    for label, kw in (("V0 async 1 chain", dict(n_chains=1, exchange="async")),
                      (f"V1 async {V1_CHAINS} chains", dict(n_chains=V1_CHAINS, exchange="async")),
                      (f"SOS {V1_CHAINS} chains", dict(n_chains=V1_CHAINS, exchange="sos"))):
        cfg = SAConfig(**base, **kw)
        r = sa_minimize(obj, cfg)
        check(math.isfinite(r.f_best) and r.x_best.shape == (32,), f"{label} output")
        check(bool(np.all(np.diff(r.history_f) <= 0)), f"{label} history not monotone")
        f_x = float(obj(torch.from_numpy(r.x_best).to(DEV)))
        check(abs(f_x - r.f_best) <= 1e-4 * abs(f_x), f"{label} (x, f) not coherent")
        log(f"  {label}: f_best {r.f_best:.4f} over {cfg.n_levels} levels")
    # A small input against the plain CPU path on the same counters.
    small = SAConfig(T0=100.0, T_min=0.5, rho=0.8, N=30, n_chains=256, seed=4,
                     use_delta_eval=True)
    x0 = np.random.default_rng(4).uniform(-512, 512, (small.n_chains, 8)).astype(np.float32)
    from repro_torch.core import annealing
    card = annealing.run_ladder(torch.from_numpy(x0).to(DEV), objective=F.schwefel(8), cfg=small)
    cpu = annealing.run_ladder(torch.from_numpy(x0), objective=F.schwefel(8), cfg=small)
    fc, fp = float(card[1]), float(cpu[1])
    log(f"  schwefel(8) 256 chains: card f_best {fc:.6f}, plain CPU {fp:.6f}")
    check(abs(fc - fp) <= 0.05, "card and plain CPU runs disagree")


def phase6_times(gen):
    """Kernel times at the main path's shapes: the C entry alone (CUDA
    events around the ctypes call, ``kernel_ms``), beside the whole
    wrapper call (``cuda_ms``), the plain version and, for B2, the PyTorch
    calls that compute the same function; device times from a profiler
    trace where it has them."""
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import reduce_min as rm
    from repro_torch.kernels import ref
    n, dim, N = MAIN_CFG["n_chains"], MAIN_DIM, MAIN_CFG["N"]
    x = ((torch.rand(n, dim, generator=gen, device=DEV) - 0.5) * 1024).contiguous()
    T = 5.0
    sweep = dict(kid=0, n_steps=N, blk=256)
    times = {}
    for variant in ("delta", "full"):
        def call(variant=variant):
            return ms.metropolis_sweep_kernel(x, T, 0, 0, variant=variant, **sweep)
        k = kernel_ms(call, "sa_metropolis_sweep")
        w = cuda_ms(call)
        p = cuda_ms(lambda: ref.metropolis_sweep_ref(x, T, 0, 0, kid=0, n_steps=N,
                                                     variant=variant), n=20, warmup=2)
        times[variant] = (k, w, p)
    f = torch.randn(n + 1, generator=gen, device=DEV)
    b2 = kernel_ms(lambda: rm.argmin_reduce(f), "sa_argmin_reduce", n=50)
    b2w = cuda_ms(lambda: rm.argmin_reduce(f), n=50)
    b2p = cuda_ms(lambda: rm.argmin_reduce_plain(f), n=50)
    lib_min = cuda_ms(lambda: torch.min(f, 0), n=50)
    lib_argmin = cuda_ms(lambda: torch.argmin(f), n=50)
    proposals = n * N
    bounds = b1_bounds(n, dim, N, TERM_INSTR)
    b2_b = b2_bound(n + 1)[0]
    log(f"phase 6: at the main path's shapes ({n} x {dim}, N={N}; argmin over {n + 1}); "
        "kernel = CUDA events around the C entry, call = around the wrapper call")
    for v in ("delta", "full"):
        k, w, p = times[v]
        b, by = bounds[v]
        log(f"  B1 {v}: kernel {k:.4f} ms (call {w:.4f} ms), plain {p:.4f} ms, bound "
            f"{b:.4f} ms ({by}, {100 * b / k:.1f}% of it reached), "
            f"{proposals / (k * 1e-3):.4e} proposals/s")
    log(f"  B2: kernel {b2:.4f} ms (call {b2w:.4f} ms), plain {b2p:.4f} ms, "
        f"torch.min(f, 0) {lib_min:.4f} ms, torch.argmin {lib_argmin:.4f} ms, "
        f"bound {b2_b:.6f} ms (bytes)")
    for name, fn, bound in (("B1 delta", lambda: ms.metropolis_sweep_kernel(
                                x, T, 0, 0, variant="delta", **sweep), bounds["delta"][0]),
                            ("B1 full", lambda: ms.metropolis_sweep_kernel(
                                x, T, 0, 0, variant="full", **sweep), bounds["full"][0]),
                            ("B2", lambda: rm.argmin_reduce(f), b2_b),
                            ("torch.min(f, 0)", lambda: torch.min(f, 0), b2_b),
                            ("torch.argmin", lambda: torch.argmin(f), b2_b)):
        dev_ms, per_call, names = device_ms(fn, bound_ms=bound)
        shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"  {name}: device time per call {shown}, {per_call:g} device op(s) per "
            f"call ({', '.join(names)})")
    # Where B1's time goes: the copy and the initial evaluation alone
    # (N = 0), then more steps.
    for variant in ("delta", "full"):
        shown = []
        for steps in (0, 1, 16, N):
            dev_ms, _, _ = device_ms(lambda: ms.metropolis_sweep_kernel(
                x, T, 0, 0, variant=variant, kid=0, n_steps=steps, blk=256), n=20,
                bound_ms=b1_bounds(n, dim, steps, TERM_INSTR)[variant][0])
            shown.append(f"N={steps} {dev_ms:.4f} ms" if dev_ms is not None
                         else f"N={steps} not measured")
        log(f"  B1 {variant} device time by steps: " + ", ".join(shown))
    return dict(delta=(*times["delta"], *bounds["delta"]),
                full=(*times["full"], *bounds["full"]),
                b2=(b2, b2w, b2p, b2_b, lib_min))


def b2_route_times(gen):
    """B2's device time through one CTA and through the grid at lengths
    around ONE_CTA_MAX, the measurement behind that threshold."""
    from repro_torch.kernels import reduce_min as rm
    for n in B2_ROUTE_SIZES:
        g = torch.randn(n, generator=gen, device=DEV)
        shown = []
        for route in ("one CTA", "grid"):
            dev_ms, per_call, _ = device_ms(lambda: argmin_route(g, route),
                                            bound_ms=b2_bound(n)[0])
            shown.append(f"{route} {dev_ms:.4f} ms ({per_call:g} op/call)"
                         if dev_ms is not None else f"{route} not measured")
        log(f"  B2 routes at n={n} (ONE_CTA_MAX {rm.ONE_CTA_MAX}), device time: "
            + ", ".join(shown))


# ----------------------------------------------------------- slice 2
def qap_layout(n, *, n_slots=QAP_SLOTS, blk=QAP_BLK, seed=0, all_live=False,
               shared=None):
    """B3's input in the serving layout: ``n_slots`` blocks of ``blk``
    chains at permutation length n.  Blocks alternate between two
    instances of that length (syn10 or grid12 where n is theirs, seeded
    random integer ones otherwise), with per-block T, seed, step0 (wrapping
    past 2^32) and shuffled chain bases; a quarter of the blocks are dead
    unless ``all_live``.  ``shared`` ("F" or "D") passes that matrix as one
    (n, n) for every block, block 0's, and the other one packed."""
    from repro_torch.objectives import qap
    rs = np.random.default_rng(seed)
    mats = [(rs.integers(0, 10, (n, n)).astype(np.float32),
             rs.integers(0, 10, (n, n)).astype(np.float32)) for _ in range(2)]
    named = {inst.n: inst for inst in qap.INSTANCES.values()}
    if n in named:
        mats[0] = (named[n].F, named[n].D)
    F = np.concatenate([mats[b % 2][0] for b in range(n_slots)])
    D = np.concatenate([mats[b % 2][1] for b in range(n_slots)])
    p = np.argsort(rs.random((n_slots * blk, n)), axis=1).astype(np.int32)
    if shared:
        (F, D) = (np.tile(F[:n], (n_slots, 1)), D) if shared == "F" else \
            (F, np.tile(D[:n], (n_slots, 1)))
    live = np.ones(n_slots, np.int32) if all_live else \
        (np.arange(n_slots) % 4 != 3).astype(np.int32)
    host = dict(
        F=F, D=D, p=p, live=live,
        T=(10.0 ** rs.uniform(-1, 2, n_slots)).astype(np.float32),
        seed=rs.integers(0, 2**32, n_slots, dtype=np.uint64).astype(np.int64),
        step0=(2**32 - 20 + rs.integers(0, 40, n_slots)).astype(np.int64),
        base=(rs.permutation(n_slots) * blk).astype(np.int64))
    # uint32 controls go to the card as int32 bit patterns, as the engine
    # sends them, so a launch converts nothing.
    dev = {k: torch.from_numpy(v.astype(np.uint32).view(np.int32)
                               if v.dtype == np.int64 else v).to(DEV)
           for k, v in host.items()}
    if shared:
        dev[shared] = dev[shared][:n]
    args = (dev["p"], dev["F"], dev["D"], dev["T"], dev["seed"], dev["step0"])
    kw = dict(blk=blk, chain_base=dev["base"], live=dev["live"])
    return host, args, kw


def host_qap_cost(p, F, D, blk):
    """Exact int64 cost of every row of p against its block's F and D."""
    n = p.shape[1]
    Fb = F.reshape(-1, n, n).astype(np.int64)
    Db = D.reshape(-1, n, n).astype(np.int64)
    out = np.empty(p.shape[0], np.int64)
    for b in range(Fb.shape[0]):
        q = p[b * blk:(b + 1) * blk]
        out[b * blk:(b + 1) * blk] = (
            Fb[b][None] * Db[b][q[:, :, None], q[:, None, :]]).sum((1, 2))
    return out


def qap_flip_ok(p_prev, F, D, T, seed, cidx, step):
    """At the step where two B3 trajectories part, the accept uniform must
    lie within 2 float32 ulps of exp(-delta/T) computed in float64."""
    from repro_torch.kernels import rng
    n = p_prev.shape[0]
    rbits, uval, uacc = rng.draws3(seed, torch.tensor([cidx]), step)
    i = int(rbits[0]) % n
    j = min(int((uval * n).to(torch.int64)[0]), n - 1)
    q = p_prev.copy()
    q[i], q[j] = p_prev[j], p_prev[i]
    F64, D64 = F.astype(np.int64), D.astype(np.int64)
    delta = int((F64 * D64[np.ix_(q, q)]).sum() - (F64 * D64[np.ix_(p_prev, p_prev)]).sum())
    thr = math.exp(min(max(-delta / T, -80.0), 80.0))
    return abs(float(uacc[0]) - thr) <= 2 * float(np.spacing(np.float32(thr)))


def check_expf_ptx():
    """B3's accept test must use the accurate expf and IEEE division: in
    the PTX every ex2.approx follows the range reduction (an fma.rm that
    splits off the exponent), and no division is approximate."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptx = _build.BUILD_DIR / "qap_sweep.ptx"
    proc = subprocess.run(
        [_build._nvcc(), "-arch=compute_90a", "-std=c++17", "-O3", "-fmad=false",
         "-ptx", "-o", str(ptx), str(_build.CSRC / "qap_sweep.cu")],
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"nvcc -ptx failed: {proc.stderr}")
    lines = ptx.read_text().splitlines()
    ex2 = [k for k, line in enumerate(lines) if "ex2.approx" in line]
    check(len(ex2) > 0, "no exp in B3's PTX")
    for k in ex2:
        check(any("fma.rm.f32" in line for line in lines[max(0, k - 16):k]),
              f"ex2.approx at PTX line {k} without range reduction")
    check(not any("div.approx" in line or "div.full" in line for line in lines),
          "approximate division in B3's PTX")
    check(any("div.rn.f32" in line for line in lines), "no IEEE division in B3's PTX")
    log(f"  PTX: {len(ex2)} ex2.approx, each after its range reduction; "
        "division div.rn.f32")


def phase7_qap_sweep():
    from repro_torch.kernels import _build
    from repro_torch.kernels import qap_sweep as qs
    log(f"phase 7: kernel B3 vs plain version, {QAP_SLOTS} slots x {QAP_BLK} chains, "
        f"n_steps={QAP_STEPS}")
    check(_build.lib().sa_qap_max_n() == qs.MAX_N, "kernel and wrapper disagree on MAX_N")
    check_expf_ptx()
    worst = 0.0
    # Every n with both matrices packed per block, then n = 12 with one
    # matrix packed and the other (n, n), then blocks whose chains fill no
    # whole CTA.
    cases = [(n, None, QAP_BLK) for n in QAP_SIZES + (qs.MAX_N,)]
    cases += [(12, "F", QAP_BLK), (12, "D", QAP_BLK)]
    cases += [(n, None, QAP_BLK_ODD) for n in (12, 31)]
    for n, shared, blk in cases:
        host, args, kw = qap_layout(n, blk=blk, seed=n, shared=shared)
        name = f"n={n}" + (f", {shared} (n, n)" if shared else "") + \
            (f", blk {blk}" if blk != QAP_BLK else "")

        def run(k, args=args, kw=kw):
            out_k = qs.qap_sweep_kernel(*args, n_steps=k, **kw)
            torch.cuda.synchronize()
            return out_k, qs.qap_sweep_plain(*args, n_steps=k, **kw)

        (pk, fk), (pp, fp) = run(QAP_STEPS)
        same = ((pk == pp).all(1) & (fk == fp)).cpu().numpy()
        pk_h, fk_h = pk.cpu().numpy(), fk.cpu().numpy()
        worst = max(worst, float((fk - fp).abs().max()))
        check(bool((np.sort(pk_h, 1) == np.arange(n)).all()), f"{name}: not permutations")
        dead = np.repeat(host["live"] == 0, blk)
        check(np.array_equal(pk_h[dead], host["p"][dead]), f"{name}: dead blocks changed")
        check(np.array_equal(host_qap_cost(pk_h, host["F"], host["D"], blk)
                             .astype(np.float32), fk_h), f"{name}: f is not the exact cost")
        moved = float((pk_h != host["p"]).any(1)[~dead].mean())
        rows = np.flatnonzero(~same)
        log(f"  {name}: rows bit-equal {same.mean():.6f} ({len(rows)} differ), "
            f"live rows moved {moved:.3f}, permutations, dead blocks and exact costs hold")
        if len(rows):
            pending = {int(r): host["p"][r] for r in rows}
            lane = np.arange(blk)
            for k in range(1, QAP_STEPS + 1):
                (pk_k, _), (pp_k, _) = run(k)
                diff = ~(pk_k == pp_k).all(1).cpu().numpy()
                for r in [r for r in pending if diff[r]]:
                    b = r // blk
                    ok = qap_flip_ok(pending.pop(r), host["F"][b * n:(b + 1) * n],
                                     host["D"][b * n:(b + 1) * n], float(host["T"][b]),
                                     int(host["seed"][b]), int(host["base"][b] + lane[r % blk]),
                                     int(host["step0"][b] + k - 1) & 0xFFFFFFFF)
                    check(ok, f"{name}: row {r} parted at step {k - 1} far from its threshold")
                now = pk_k.cpu().numpy()
                for r in pending:
                    pending[r] = now[r]
            check(not pending, f"{name}: rows {sorted(pending)} differ but replay identically")
            log(f"  {name}: every differing row parts at a near-threshold accept")
    return worst


def qap_requests():
    """Phase 8's load: SERVE_SEEDS requests per QAP instance, one slot
    each, the instances alternating in submission order."""
    from repro_torch.objectives import qap
    from repro_torch.service import SARequest
    names = sorted(qap.INSTANCES)
    reqs = []
    for s in range(SERVE_SEEDS):
        for i, name in enumerate(names):
            reqs.append(SARequest(
                req_id=len(reqs), objective=name, dim=qap.get(name).n,
                n_chains=SERVE_CFG["chains_per_slot"], seed=100000 * i + s,
                family="permutation", **QAP_SCHEDULE))
    return reqs


HOST_STEPS = ("_admit", "_launch_group", "_launch_group_fused",
              "_collect_group", "_collect_group_fused", "_retire")


class TimedLib:
    """The kernel library with one C entry bracketed by CUDA events on the
    current stream (the launch's), so each span holds the kernel and none
    of its wrapper's host work."""

    def __init__(self, lib, entry):
        self._lib, self._entry = lib, entry
        self.events = []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != self._entry:
            return fn

        def timed(*args):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            rc = fn(*args)
            e1.record()
            self.events.append((e0, e1))
            return rc
        return timed


@contextlib.contextmanager
def timed_entry(entry):
    """Time every launch through the C entry ``entry`` while inside."""
    from repro_torch.kernels import _build
    real = _build.lib
    timed = TimedLib(real(), entry)
    _build.lib = lambda: timed
    try:
        yield timed
    finally:
        _build.lib = real


def kernel_ms(fn, entry, n=25, warmup=3):
    """Median time of the launch through ``entry`` in fn() over n calls,
    CUDA events around the launch alone."""
    for _ in range(warmup):
        fn()
    with timed_entry(entry) as t:
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in t.events)


def serve_timed(cfg, reqs):
    """Serve ``reqs`` with B3's launches counted from 0 and each kernel
    bracketed by CUDA events, and the host seconds of the engine's steps
    (admission, launch: packing, upload and enqueueing; collect: waiting
    for the card, then folding champions; retire).  Returns (results by
    id, wall s, launches, kernel s, engine, seconds by step)."""
    from repro_torch.kernels import qap_sweep as qs
    from repro_torch.service import SAServeEngine
    engine = SAServeEngine(cfg)
    for r in reqs:
        engine.submit(r)
    steps = time_host_steps(engine)
    with timed_entry("sa_qap_sweep") as timed:
        torch.cuda.synchronize()
        qs.counter.launches = 0
        t0 = time.perf_counter()
        results = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = qs.counter.launches
    kernel_s = sum(a.elapsed_time(b) for a, b in timed.events) / 1e3
    return {r.req_id: r for r in results}, wall, launches, kernel_s, engine, steps


def time_host_steps(engine, names=HOST_STEPS):
    """Accumulate the host seconds of each of ``engine``'s methods
    ``names`` into the returned dict, from now on."""
    steps = {}
    for name in names:
        def step(*a, _fn=getattr(engine, name), _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                steps[_name] = steps.get(_name, 0.0) + time.perf_counter() - t
        setattr(engine, name, step)
    return steps


def host_steps(steps, wall):
    return ", ".join(f"{k.lstrip('_')} {v:.3f} s" for k, v in steps.items()) + \
        f", other {wall - sum(steps.values()):.3f} s"


def assert_exact(a, b, what):
    check(a.f_best == b.f_best and np.array_equal(a.x_best, b.x_best)
          and a.x_best.dtype == b.x_best.dtype
          and a.champion_history == b.champion_history,
          f"{what}: req {a.req_id} packed {a.f_best} != standalone {b.f_best}")


def phase8_serving():
    from repro_torch.objectives import qap
    from repro_torch.service import EngineConfig, SAServeEngine, run_standalone
    reqs = qap_requests()
    cfg = EngineConfig(**SERVE_CFG)
    n_levels = reqs[0].n_levels
    log(f"phase 8: serving main path, {len(reqs)} QAP requests x {reqs[0].n_chains} chains, "
        f"EngineConfig({SERVE_CFG}), {n_levels} levels of N={QAP_SCHEDULE['N']}")
    warm = SAServeEngine(cfg)           # first calls of the torch ops
    warm.submit(reqs[0])
    warm.run()
    got, wall, launches, kernel_s, engine, steps = serve_timed(cfg, reqs)
    evals = sum(r.n_evals for r in got.values())
    check(len(got) == len(reqs) and all(r.finish_reason == "ladder" for r in got.values()),
          "not every request completed its ladder")
    check(launches > 0, "B3 was not launched on the main path")
    rows = {}
    for name in sorted(qap.INSTANCES):
        inst = qap.get(name)
        mine = [got[r.req_id] for r in reqs if r.objective == name]
        for res in mine:
            check(sorted(res.x_best.tolist()) == list(range(inst.n))
                  and inst.cost(res.x_best) == res.f_best,
                  f"req {res.req_id}: champion f is not the exact cost of its permutation")
        found = [res.f_best for res in mine]
        best = min(found)
        rows[name] = dict(
            best_found=best, gap_pct=100.0 * (best - inst.best_known) / inst.best_known,
            mean_gap_pct=100.0 * float(np.mean([(f - inst.best_known) / inst.best_known
                                                for f in found])),
            hit_rate=sum(f == inst.best_known for f in found) / len(found))
        r = rows[name]
        log(f"  {name}: best {best:.0f} (best_known {inst.best_known}), gap "
            f"{r['gap_pct']:.3f}%, mean gap {r['mean_gap_pct']:.3f}%, hit rate {r['hit_rate']:.3f}")
        check(best >= inst.best_known, f"{name}: best_found beats best_known")
        check(r["hit_rate"] > 0.0, f"{name}: no seed reached best_known")
        check(r["gap_pct"] <= QAP_MAX_GAP_PCT, f"{name}: gap above {QAP_MAX_GAP_PCT}%")
    log(f"  K=4: wall {wall:.3f} s, {len(got) / wall:.2f} requests/s, "
        f"{evals / wall:.4e} proposals/s, B3 launches {launches}, B3 kernel time "
        f"{kernel_s:.4f} s ({100 * kernel_s / wall:.1f}% of wall), host and other "
        f"device work {wall - kernel_s:.3f} s ({100 * (1 - kernel_s / wall):.1f}%), "
        f"ticks {engine.tick_count}, group launches {engine.group_launches}")
    log(f"  K=4 host steps: {host_steps(steps, wall)}")
    picked = [r for name in sorted(qap.INSTANCES)
              for r in [q for q in reqs if q.objective == name][:QAP_EXACT_PER_INSTANCE]]
    for req in picked:
        assert_exact(got[req.req_id], run_standalone(req, cfg), "phase 8")
    log(f"  {len(picked)} requests bit-exact against run_standalone at K=4")
    got1, wall1, launches1, kernel1, _, steps1 = serve_timed(
        EngineConfig(**{**SERVE_CFG, "macro_k": 1}), reqs)
    for req in reqs:
        assert_exact(got1[req.req_id], got[req.req_id], "phase 8 K=1 vs K=4")
    log(f"  K=1: wall {wall1:.3f} s, {len(got1) / wall1:.2f} requests/s, "
        f"{evals / wall1:.4e} proposals/s, B3 launches {launches1}, kernel time "
        f"{kernel1:.4f} s ({100 * kernel1 / wall1:.1f}% of wall); all "
        f"{len(reqs)} champions bit-equal to K=4")
    log(f"  K=1 host steps: {host_steps(steps1, wall1)}")
    return launches, dict(wall_s=wall, kernel_s=kernel_s, rows=rows)


def phase9_mixed():
    import dataclasses
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import qap_sweep as qs
    from repro_torch.service import EngineConfig, SAServeEngine, run_standalone
    from repro_torch.service.serve_sa import make_mix
    reqs = make_mix(MIXED_REQUESTS, MIXED_CFG["chains_per_slot"], seed=0, family="mixed")
    # Two continuous requests at the width of slice 1's main path.
    for i in (MIXED_REQUESTS - 4, MIXED_REQUESTS - 2):
        reqs[i] = dataclasses.replace(reqs[i], dim=512)
    log(f"phase 9: {len(reqs)} mixed requests (continuous dims "
        f"{sorted({r.dim for r in reqs if r.family == 'continuous'})}, QAP "
        f"{sorted({r.objective for r in reqs if r.family == 'permutation'})}), "
        f"EngineConfig({MIXED_CFG})")
    for k in (1, 4):
        cfg = EngineConfig(**MIXED_CFG, macro_k=k)
        engine = SAServeEngine(cfg)
        for r in reqs:
            engine.submit(r)
        ms.counter.launches = qs.counter.launches = 0
        t0 = time.perf_counter()
        got = {r.req_id: r for r in engine.run()}
        wall = time.perf_counter() - t0
        b1, b3 = ms.counter.launches, qs.counter.launches
        check(len(got) == len(reqs), f"K={k}: not every request completed")
        check(b1 > 0 and b3 > 0, f"K={k}: B1 {b1} / B3 {b3} launches")
        for req in reqs:
            res = got[req.req_id]
            check(np.isfinite(res.f_best) and res.x_best.shape == (req.dim,),
                  f"K={k}: req {req.req_id} output")
            check(res.x_best.dtype == (np.int32 if req.family == "permutation" else np.float32),
                  f"K={k}: req {req.req_id} champion dtype")
            assert_exact(res, run_standalone(req, cfg), f"phase 9 K={k}")
        log(f"  K={k}: wall {wall:.3f} s, B1 launches {b1}, B3 launches {b3}; every "
            f"champion (float32 and int32) bit-exact against run_standalone")


def card_mem():
    """Bytes the caching allocator holds for tensors on the card."""
    return torch.cuda.memory_allocated() if DEV == "cuda" else None


def fmt_mem(b):
    return "not measured" if b is None else f"{b / 2**20:.1f} MiB"


def elastic_requests():
    """Phase 10's load: the reference mix with completion deadlines; the
    priority-0 two-slot requests are degrade-class with a one-slot
    floor."""
    import dataclasses
    from repro_torch.service.serve_sa import make_mix
    cps = ELASTIC_CFG["chains_per_slot"]
    reqs = make_mix(ELASTIC_REQUESTS, cps, **ELASTIC_MIX)
    return [dataclasses.replace(r, on_overload="degrade", min_chains=cps)
            if r.priority == 0 and r.n_chains == 2 * cps else r for r in reqs]


def script_ops(engine, done):
    """Schedule the phase's operator calls: drain(1) at its tick and
    resize(2) from its tick on once shard 1 has retired; one preempt, one
    migrate and one degrade_active on requests active then, each retried
    four levels later until it acts."""
    cps = ELASTIC_CFG["chains_per_slot"]

    def active():
        return sorted(((job.req.req_id, shard, job) for shard, job in engine._iter_jobs()),
                      key=lambda t: t[0])

    def preempt():
        return any(engine.preempt(rid) for rid, _, _ in active()[:1])

    def migrate():
        for rid, shard, job in active():
            for dst in engine.live_shards:
                if dst is not shard and dst.pool.n_free >= len(job.slots):
                    return engine.migrate(rid, dst.index)
        return False

    def degrade():
        return any(engine.degrade_active(rid, cps)
                   for rid, _, job in active() if len(job.slots) > 1)

    def attempt(name, fn):
        if fn():
            done[name] = engine.tick_count
        else:
            engine.schedule_op(engine.tick_count + 4, lambda: attempt(name, fn))

    for name, fn in (("preempt", preempt), ("migrate", migrate), ("degrade", degrade)):
        engine.schedule_op(OPS_AT[name], lambda name=name, fn=fn: attempt(name, fn))

    def drain():
        done["mem_before_drain"] = card_mem()
        engine.drain(1)
        done["drain"] = engine.tick_count

    def resize():
        # A grow while shard 1 still drains would cancel the drain: wait
        # for it to retire, so the fleet really loses a shard and gains one.
        if any(s.draining for s in engine.shards):
            engine.schedule_op(engine.tick_count + 4, resize)
            return
        engine.resize(2)
        done["resize"] = engine.tick_count

    engine.schedule_op(DRAIN_AT, drain)
    engine.schedule_op(RESIZE_AT, resize)


@contextlib.contextmanager
def timed_checkpoints():
    """Host seconds and slots of every SlotPool.checkpoint while inside."""
    from repro_torch.service.slots import SlotPool
    real, acc = SlotPool.checkpoint, {"s": 0.0, "calls": 0, "slots": 0}

    def checkpoint(self, rid):
        t = time.perf_counter()
        blocks = real(self, rid)
        acc["s"] += time.perf_counter() - t
        acc["calls"] += 1
        acc["slots"] += len(blocks)
        return blocks

    SlotPool.checkpoint = checkpoint
    try:
        yield acc
    finally:
        SlotPool.checkpoint = real


def phase10_elastic():
    import dataclasses
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import qap_sweep as qs
    from repro_torch.objectives import qap
    from repro_torch.service import (ArrivalProcess, EngineConfig, SAServeEngine,
                                     SchedulerConfig, latency_summary)
    from repro_torch.service.serve_sa import replay_check
    reqs = elastic_requests()
    cfg = EngineConfig(**ELASTIC_CFG, device=DEV, scheduler=SchedulerConfig(**ELASTIC_SCHED))
    n_degrade = sum(r.on_overload == "degrade" for r in reqs)
    log(f"phase 10: elastic open loop, {len(reqs)} requests of make_mix({ELASTIC_MIX}) "
        f"({sum(r.family == 'permutation' for r in reqs)} QAP), {n_degrade} priority-0 two-slot "
        f"requests made on_overload='degrade', min_chains={cfg.chains_per_slot} "
        f"(dataclasses.replace); bursty arrivals {ELASTIC_ARRIVALS}; EngineConfig({ELASTIC_CFG}), "
        f"SchedulerConfig({ELASTIC_SCHED}); drain(1) at tick {DRAIN_AT}, resize(2) from tick "
        f"{RESIZE_AT} once shard 1 has retired, preempt/migrate/degrade_active from ticks "
        f"{OPS_AT}")
    warm = SAServeEngine(dataclasses.replace(cfg, n_devices=1))   # first calls of the ops
    warm.submit(reqs[0])
    warm.submit(reqs[1])
    warm.run()
    engine = SAServeEngine(cfg)
    done = {}
    script_ops(engine, done)
    real_retire = engine._retire_drained

    def retire_drained():
        before = len(engine.retired_shards)
        real_retire()
        if len(engine.retired_shards) > before and "mem_after_retire" not in done:
            done["mem_after_retire"] = card_mem()
    engine._retire_drained = retire_drained
    arrivals = ArrivalProcess.bursty(reqs, **ELASTIC_ARRIVALS)
    steps = time_host_steps(engine, ("_admit", "_plan_truncations", "_launch_group_fused",
                                     "_collect_group_fused", "_retire"))
    with timed_checkpoints() as ckpt, timed_entry("sa_metropolis_sweep") as tb1, \
            timed_entry("sa_qap_sweep") as tb3:
        if DEV == "cuda":
            torch.cuda.synchronize()
        ms.counter.launches = qs.counter.launches = 0
        t0 = time.perf_counter()
        results = engine.run_stream(arrivals)
        if DEV == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1, b3 = ms.counter.launches, qs.counter.launches
    b1_s, b3_s = (sum(a.elapsed_time(b) for a, b in t.events) / 1e3 for t in (tb1, tb3))
    st = engine.stats()
    lat = latency_summary(results, ticks=engine.tick_count, n_submitted=engine.n_submitted)
    got = {r.req_id: r for r in results}
    check(len(got) == len(results) == len(reqs), "a request was lost or finished twice")
    check(lat["completed"] + lat["rejected"] + lat["incomplete"] == engine.n_submitted
          == len(reqs), f"accounting: {lat}")
    check(b1 > 0 and b3 > 0, f"phase 10: B1 {b1} / B3 {b3} launches")
    events = {"preemptions": st["preemptions"], "migrations": st["migrations"],
              "shrinks": st["shrinks"], "truncations": st["truncations"],
              "shards_retired": st["shards_retired"], "rejected": st["rejected"]}
    check(all(events[k] > 0 for k in ("preemptions", "migrations", "shrinks", "truncations",
                                      "shards_retired")), f"an event kind never occurred: {events}")
    check(all(k in done for k in ("preempt", "migrate", "degrade", "drain", "resize")),
          f"a scripted operation never acted: {done}")
    evals = sum(r.n_evals for r in results)
    log(f"  wall {wall:.3f} s, {len(results) / wall:.2f} requests/s, {evals / wall:.4e} "
        f"proposals/s, {engine.tick_count} ticks, {st['group_launches']} group launches, "
        f"occupancy {st['occupancy']:.3f}; B1 launches {b1}, B3 launches {b3}")
    shown = (f"B1 {b1_s:.4f} s, B3 {b3_s:.4f} s, {100 * (b1_s + b3_s) / wall:.1f}% of wall"
             if DEV == "cuda" else "not measured")
    log(f"  kernel time (CUDA events around each launch): {shown}; host steps: "
        f"{host_steps(steps, wall)}")
    log(f"  completed {lat['completed']}, rejected {lat['rejected']}, incomplete "
        f"{lat['incomplete']} of {engine.n_submitted}; queue delay p50/p99 "
        f"{lat['queue_delay_p50']:.2f}/{lat['queue_delay_p99']:.2f} ticks, latency p50/p99 "
        f"{lat['latency_p50']:.2f}/{lat['latency_p99']:.2f} ticks")
    degraded = sum(r.degraded for r in results if r.completed)
    log(f"  events {events}, degraded admissions {degraded}, retired {engine.retired_shards}, "
        f"scripted ops at ticks {{preempt: {done['preempt']}, migrate: {done['migrate']}, "
        f"degrade: {done['degrade']}, drain: {done['drain']}, resize: {done['resize']}}}")
    per_slot = ckpt["s"] / max(ckpt["slots"], 1)
    log(f"  checkpoints: {ckpt['calls']} calls, {ckpt['slots']} slots, {ckpt['s']:.4f} s on "
        f"the host, {1e3 * per_slot:.4f} ms per slot")
    log(f"  card memory allocated before drain(1) {fmt_mem(done.get('mem_before_drain'))}, "
        f"after shard 1 retired {fmt_mem(done.get('mem_after_retire'))}")
    # Every completed request against its standalone replay, on the card.
    t0 = time.perf_counter()
    by_req = {r.req_id: r for r in reqs}
    done_reqs = [by_req[rid] for rid, r in got.items() if r.completed]
    for req in done_reqs:
        res = got[req.req_id]
        check(np.isfinite(res.f_best) and res.x_best.shape == (req.dim,)
              and res.x_best.dtype == (np.int32 if req.family == "permutation" else np.float32),
              f"phase 10: req {req.req_id} output")
        check(replay_check(req, res, cfg),
              f"phase 10: req {req.req_id} differs from its standalone replay "
              f"(shrinks {res.shrink_events}, cuts {res.truncate_events})")
    log(f"  all {len(done_reqs)} completed requests bit-exact against run_standalone with "
        f"their width and ladder schedules ({time.perf_counter() - t0:.1f} s)")
    # The QAP quality gate of phase 8 on the QAP requests no cut shortened.
    for name in sorted(qap.INSTANCES):
        inst = qap.get(name)
        mine = [got[r.req_id] for r in done_reqs
                if r.objective == name and not got[r.req_id].truncated]
        check(bool(mine), f"{name}: no untruncated request")
        for res in mine:
            check(sorted(res.x_best.tolist()) == list(range(inst.n))
                  and inst.cost(res.x_best) == res.f_best,
                  f"req {res.req_id}: champion f is not the exact cost of its permutation")
        found = [res.f_best for res in mine]
        best = min(found)
        gap = 100.0 * (best - inst.best_known) / inst.best_known
        hit = sum(f == inst.best_known for f in found) / len(found)
        log(f"  {name}: {len(mine)} untruncated, best {best:.0f} (best_known "
            f"{inst.best_known}), gap {gap:.3f}%, hit rate {hit:.3f}")
        check(best >= inst.best_known, f"{name}: best_found beats best_known")
        check(hit > 0.0, f"{name}: no seed reached best_known")
        check(gap <= QAP_MAX_GAP_PCT, f"{name}: gap above {QAP_MAX_GAP_PCT}%")
    boundary_case(cfg.device)
    return b1, b3


def boundary_case(device):
    """The reference's K-boundary scenario on the card: preempt request 0
    and grow to three shards at tick 8, drain shard 1 at tick 16, with a
    move budget that empties it within that tick; K = 4 gives K = 1's
    champions and lifecycle stamps, and each result replays standalone."""
    from repro_torch.service import EngineConfig, SAServeEngine, SARequest
    from repro_torch.service.serve_sa import replay_check
    cps = ELASTIC_CFG["chains_per_slot"]
    mix = [dict(objective="rastrigin"), dict(objective="ackley", dim=8),
           dict(objective="griewank", n_chains=2 * cps), dict(objective="schwefel")]
    reqs = [SARequest(req_id=i, seed=100 + i, **{**dict(dim=4, n_chains=cps, T0=50.0,
                                                       T_min=1.0, rho=0.8, N=10), **kw})
            for i, kw in enumerate(mix)]
    runs = {}
    for k in (1, 4):
        cfg = EngineConfig(n_slots=4, chains_per_slot=cps, n_devices=2, macro_k=k,
                           migration_budget=4, device=device)
        engine = SAServeEngine(cfg)
        for r in reqs:
            engine.submit(r)
        engine.schedule_op(8, lambda e=engine: e.preempt(0))
        engine.schedule_op(8, lambda e=engine: e.resize(3))
        engine.schedule_op(16, lambda e=engine: e.drain(1))
        runs[k] = {r.req_id: r for r in engine.run()}
        for req in reqs:
            check(replay_check(req, runs[k][req.req_id], cfg),
                  f"K-boundary K={k}: req {req.req_id} differs from its replay")
    stamps = ("champion_history", "f_best", "levels_run", "finish_tick", "first_tick",
              "preempted_ticks", "resumed_ticks", "migrated_ticks", "home_shard")
    for rid, a in runs[1].items():
        b = runs[4][rid]
        check(all(getattr(a, s) == getattr(b, s) for s in stamps)
              and np.array_equal(a.x_best, b.x_best), f"K-boundary: req {rid} K=4 != K=1")
    check(runs[1][0].preempted_ticks == [8] and any(r.migrated_ticks for r in runs[1].values()),
          "K-boundary: the scripted preempt or the drain did not act")
    log(f"  K-boundary scenario ({len(reqs)} requests x {cps} chains, preempt and resize(3) at "
        f"tick 8, drain(1) at 16): K=4 equals K=1 in champions and lifecycle stamps, every "
        f"result bit-exact against its standalone replay")


# ------------------------------------------------------------- slice 6
def counted_launches():
    """Zero B1's, B2's and B3's launch counters; returns a function that
    reads them as {"b1", "b2", "b3"}."""
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import qap_sweep as qs
    from repro_torch.kernels import reduce_min as rm
    ms.counter.launches = rm.counter.launches = qs.counter.launches = 0
    return lambda: {"b1": ms.counter.launches, "b2": rm.counter.launches,
                    "b3": qs.counter.launches}


def sync(dev=None):
    """Wait for the card (``dev``'s, default DEV's); nothing on the CPU."""
    if torch.device(DEV if dev is None else dev).type == "cuda":
        torch.cuda.synchronize()


def level_parity(name, obj, x, T, seed, step0, N):
    """One ladder level of kernel B1 full, as ``sa_minimize`` launches it
    (``ops.metropolis_sweep`` on every chain, scalar controls), held
    against its plain version on the same inputs by ``compare_sweep``.
    Returns the largest |f_kernel - f_plain|."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.metropolis_sweep import metropolis_sweep_plain
    n = x.shape[0]
    kid = obj.kernel_id

    def run(k):
        out_k = ops.metropolis_sweep(x, T, seed, step0, kid=kid, n_steps=k, variant="full")
        sync()
        return out_k, metropolis_sweep_plain(x, T, seed, step0, kid=kid, n_steps=k,
                                             blk=min(256, n), variant="full")
    ctl = dict(kid=np.full(n, kid), T=np.full(n, T, np.float32), seed=np.full(n, seed),
               step0=np.full(n, step0), cidx=np.arange(n))
    return compare_sweep(name, x, run, ctl, N, "full")


def phase11_suite():
    """The paper's Table 9: every problem of the 41-problem suite, V1
    (async) and V2 (sync), at the width and N of the reference bench's
    full mode with the depth of its quick ladder."""
    from repro_torch.core import SAConfig, annealing, sa_minimize
    from repro_torch.objectives import SUITE
    probe = SAConfig(**SUITE_CFG)
    log(f"phase 11: Table 9, the 41-problem suite, V1 and V2 at {SUITE_CFG} "
        f"({probe.n_levels} levels)")
    check(probe.n_levels == SUITE_LEVELS, f"suite ladder has {probe.n_levels} levels")
    total = {"b1": 0, "b2": 0}
    wins = known = 0
    worst = 0.0
    t_phase = time.perf_counter()
    for key, factory in SUITE.items():
        obj = factory()
        kernel = annealing.sweeps_in_kernel(obj, probe)
        if kernel:
            # Level 0 as sa_minimize runs it: its chains, T0, seed, step 0.
            gen = torch.Generator(device=DEV)
            gen.manual_seed(probe.seed)
            x0 = obj.sample_uniform(gen, (probe.n_chains,))
            worst = max(worst, level_parity(f"{key} {obj.name}({obj.dim}) level 0", obj, x0,
                                            probe.T0, probe.seed, 0, probe.N))
        errs, walls = {}, {}
        for tag, ex in (("V1", "async"), ("V2", "sync")):
            cfg = SAConfig(**SUITE_CFG, exchange=ex)
            sync()
            read = counted_launches()
            t0 = time.perf_counter()
            r = sa_minimize(obj, cfg)
            sync()
            walls[tag] = time.perf_counter() - t0
            got = read()
            total["b1"] += got["b1"]
            total["b2"] += got["b2"]
            check(math.isfinite(r.f_best) and r.x_best.shape == (obj.dim,),
                  f"{key} {tag}: f_best {r.f_best}")
            if kernel:
                check(got["b1"] == cfg.n_levels and got["b2"] >= cfg.n_levels,
                      f"{key} {tag}: a kernel objective launched B1 {got['b1']}, B2 "
                      f"{got['b2']} times")
            else:
                check(got["b1"] == 0 and got["b2"] >= cfg.n_levels,
                      f"{key} {tag}: launched B1 {got['b1']}, B2 {got['b2']} times")
            errs[tag] = abs(r.f_best - obj.f_opt) if obj.f_opt is not None else float("nan")
        win = ""
        if math.isfinite(errs["V2"]):
            known += 1
            ok = errs["V2"] <= SUITE_WIN * errs["V1"] + 1e-9
            wins += ok
            win = "y" if ok else "n"
        log(f"  {key:<6} {obj.name:<17} n={obj.dim:<4} "
            f"{'B1 full + B2' if kernel else 'torch sweep + B2':<16} |f-f*| V1 "
            f"{errs['V1']:.4e} V2 {errs['V2']:.4e} V2<=1.05V1 {win or '-'}  wall V1 "
            f"{walls['V1']:.3f} s V2 {walls['V2']:.3f} s")
    log(f"  V2 <= 1.05 V1 on {wins}/{known} problems with a known optimum; B1 full "
        f"launches {total['b1']}, B2 reductions {total['b2']}; B1 full against its plain "
        f"version on level 0 of each kernel objective, max |f_kernel - f_plain| {worst:.3e}; "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")
    total["max_abs_err"] = worst
    return total


def phase12_precision(gen):
    """The paper's Table 7: Schwefel-16 at the reference bench's full
    configuration in float32 (B1 full + B2) and float64 (the torch sweep,
    torch.argmin), a warm run first as the bench's child does (here the
    ladder's first TABLE7_WARM_LEVELS levels: the port compiles nothing,
    so a warm run only makes the first calls of its ops)."""
    import dataclasses
    from repro_torch.core import SAConfig, metropolis, sa_minimize
    from repro_torch.kernels import ops
    from repro_torch.objectives import functions as F
    obj = F.schwefel(TABLE7_DIM)
    log(f"phase 12: Table 7, schwefel({TABLE7_DIM}) at {TABLE7_CFG}, "
        f"{SAConfig(**TABLE7_CFG).n_levels} levels, float32 and float64")
    rows = {}
    total = {"b1": 0, "b2": 0}
    for dtype in ("float32", "float64"):
        cfg = SAConfig(**TABLE7_CFG, dtype=dtype)
        warm_t_min = cfg.T0 * cfg.rho ** (TABLE7_WARM_LEVELS - 0.5)
        sa_minimize(obj, dataclasses.replace(cfg, seed=0, T_min=warm_t_min))
        sync()
        read = counted_launches()
        t0 = time.perf_counter()
        r = sa_minimize(obj, dataclasses.replace(cfg, seed=1))
        sync()
        wall = time.perf_counter() - t0
        got = read()
        total["b1"] += got["b1"]
        total["b2"] += got["b2"]
        df, dx = obj.error_to_opt(r.x_best, r.f_best)
        rows[dtype] = dict(wall=wall, df=float(df), dx=float(dx))
        check(r.x_best.dtype == np.dtype(dtype) and math.isfinite(r.f_best),
              f"{dtype}: result {r.f_best} {r.x_best.dtype}")
        want_b1 = cfg.n_levels if dtype == "float32" else 0
        want_b2 = 2 * cfg.n_levels + 2 if dtype == "float32" else 0
        check(got["b1"] == want_b1 and got["b2"] == want_b2,
              f"{dtype}: B1 {got['b1']} / B2 {got['b2']} launches, expected "
              f"{want_b1} / {want_b2}")
        log(f"  {dtype}: wall {wall:.3f} s ({1e3 * wall / cfg.n_levels:.3f} ms per level), "
            f"|f - f*| {df:.4e}, relative x error {dx:.4e}, f_best {r.f_best:.9f}; B1 "
            f"{got['b1']}, B2 {got['b2']} launches")
    check(rows["float64"]["df"] <= rows["float32"]["df"],
          f"float64 |f - f*| {rows['float64']['df']} worse than float32's "
          f"{rows['float32']['df']}")
    log(f"  wall float64 / float32: {rows['float64']['wall'] / rows['float32']['wall']:.2f}")
    # B1 full against its plain version on the float32 run's first level.
    gen1 = torch.Generator(device=DEV)
    gen1.manual_seed(1)
    x32 = obj.sample_uniform(gen1, (TABLE7_CFG["n_chains"],))
    err = level_parity(f"schwefel({TABLE7_DIM}) level 0 of the float32 run", obj, x32,
                       TABLE7_CFG["T0"], 1, 0, TABLE7_CFG["N"])
    # The same code path in both precisions: device time per level of the
    # torch sweep, with B1 full's beside it.  A trace counts only when it
    # holds every launch and fits between its bound and its wall.
    n, N = TABLE7_CFG["n_chains"], TABLE7_CFG["N"]
    runs = {}
    for dtype in (torch.float32, torch.float64):
        x = obj.sample_uniform(gen, (n,), dtype)
        runs[dtype] = lambda x=x, fx=obj(x): metropolis.sweep_full(
            x, fx, 10.0, 3, 0, objective=obj, n_steps=N)
        runs[dtype]()
    # Wall per level (CUDA events) in turns: f32, f64, f64, f32.
    walls = {torch.float32: [], torch.float64: []}
    for dtype in (torch.float32, torch.float64, torch.float64, torch.float32):
        walls[dtype].append(cuda_ms(runs[dtype], n=3, warmup=1))
    per = {}
    for dtype, run in runs.items():
        # Bytes: x and f read once and written once.
        item = torch.tensor([], dtype=dtype).element_size()
        bound = 2 * n * (TABLE7_DIM + 1) * item / HBM_BYTES_PER_S * 1e3
        ms_dev, ops_per, _ = device_ms(run, n=TABLE7_PROFILE_LEVELS, bound_ms=bound)
        per[dtype] = (ms_dev, ops_per, statistics.median(walls[dtype]))
    b1_bound = b1_bounds(n, TABLE7_DIM, N, TERM_INSTR)["full"] if TERM_INSTR else (None, "")

    def b1_level():
        return ops.metropolis_sweep(x32, 10.0, 3, 0, kid=0, n_steps=N, variant="full")
    b1_dev, _, _ = device_ms(b1_level, n=20, bound_ms=b1_bound[0])
    b1_entry = kernel_ms(b1_level, "sa_metropolis_sweep")

    def shown(v):
        return "not measured" if v is None else f"{v:.4f} ms"
    f32, f64 = per[torch.float32], per[torch.float64]
    ratio = (f"{f64[0] / f32[0]:.2f}" if f32[0] and f64[0] is not None
             else "not measured")
    busy = ", ".join(f"{name} {100 * d[0] / d[2]:.1f}%" if d[0] is not None
                     else f"{name} not measured" for name, d in (("float32", f32),
                                                                 ("float64", f64)))
    log(f"  one level ({n} chains x {N} steps) of the torch sweep: device float32 "
        f"{shown(f32[0])} ({f32[1]:.0f} device ops), float64 {shown(f64[0])} "
        f"({f64[1]:.0f} ops), ratio {ratio}; wall (CUDA events) float32 {f32[2]:.4f} ms, "
        f"float64 {f64[2]:.4f} ms, ratio {f64[2] / f32[2]:.2f}; device busy {busy}; "
        f"B1 full device {shown(b1_dev)}, C entry (CUDA events) {b1_entry:.4f} ms"
        + (f" (bound {b1_bound[0]:.4f} ms, {b1_bound[1]})" if b1_bound[0] else ""))
    total["max_abs_err"] = err
    return total, rows


def temper_spies(weights=False):
    """Count, while inside, the B1 launches with a per-chain temperature
    (keeping the inputs of the widest, for a parity check after the run),
    the PT swaps and passes and the PA rows resampled to another ancestor
    and passes, from the masks the exchange stages return; with
    ``weights`` also the largest sum of a pass's quantized PA weights,
    which recomputes them.  The device counts are read at the end."""
    from repro_torch.core import exchange as exch
    from repro_torch.kernels import ops
    acc = {"pt_swaps": 0, "pt_passes": 0, "pa_rows": 0, "pa_passes": 0,
           "pa_max_sum": 0, "t_chain_launches": 0, "t_chain_call": None}
    dev = {k: None for k in ("pt_swaps", "pa_rows", "pa_max_sum")}
    real = (exch.pt_swap_segmented, exch.pa_resample_segmented, ops.metropolis_sweep_slots)

    def add(name, v, fn=torch.add):
        dev[name] = v if dev[name] is None else fn(dev[name], v)

    def pt_spy(*a, **kw):
        x, fx, swap = real[0](*a, **kw)
        add("pt_swaps", swap.sum())
        acc["pt_passes"] += 1
        return x, fx, swap

    def pa_spy(x, fx, fb_seg, seg, seg_lo, seg_hi, dbeta_c, is_pa, u, out=None):
        if weights:
            wq = exch.pa_weights(fx, fb_seg, seg, dbeta_c, is_pa)
            add("pa_max_sum", wq.sum(dtype=torch.int64), torch.maximum)
        x, fx, anc, take = real[1](x, fx, fb_seg, seg, seg_lo, seg_hi, dbeta_c, is_pa, u,
                                   out=out)
        rows = torch.arange(fx.shape[0], device=fx.device)
        add("pa_rows", (take & (anc != rows)).sum())
        acc["pa_passes"] += 1
        return x, fx, anc, take

    def sweep_spy(*a, **kw):
        if kw.get("T_chain") is not None:
            acc["t_chain_launches"] += 1
            kept = acc["t_chain_call"]
            if kept is None or a[0].shape[0] > kept[0][0].shape[0]:
                acc["t_chain_call"] = (
                    [v.clone() if isinstance(v, torch.Tensor) else np.copy(v) for v in a],
                    {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in kw.items() if k != "out"})
        return real[2](*a, **kw)

    @contextlib.contextmanager
    def inside():
        exch.pt_swap_segmented, exch.pa_resample_segmented = pt_spy, pa_spy
        ops.metropolis_sweep_slots = sweep_spy
        try:
            yield acc
        finally:
            exch.pt_swap_segmented, exch.pa_resample_segmented, \
                ops.metropolis_sweep_slots = real
            for k, v in dev.items():
                if v is not None:
                    acc[k] = int(v)
    return inside()


def t_chain_parity(call):
    """The packed group sweep that ``temper_spies`` kept, B1 with a
    per-chain temperature as the engine launched it, against its plain
    version on the same inputs (``compare_sweep``)."""
    from repro_torch.kernels.metropolis_sweep import (metropolis_sweep_kernel,
                                                      metropolis_sweep_plain)
    (x, kids, T, seeds, step0s, chain_base), kw = call
    x = torch.as_tensor(x, dtype=torch.float32, device=DEV)
    blk, n_steps, variant = kw["blk"], kw["n_steps"], kw.get("variant", "delta")
    n = x.shape[0]
    sweep = dict(kid=kids, blk=blk, variant=variant, chain_base=chain_base,
                 live=kw.get("live"), t_chain=kw["T_chain"])

    def run(k):
        out_k = metropolis_sweep_kernel(x, T, seeds, step0s, **sweep, n_steps=k)
        sync()
        return out_k, metropolis_sweep_plain(x, T, seeds, step0s, **sweep, n_steps=k)
    lane = np.tile(np.arange(blk), n // blk)
    ctl = dict(kid=_per_row(kids, blk, n),
               T=torch.as_tensor(kw["T_chain"]).cpu().numpy().reshape(-1),
               seed=_per_row(seeds, blk, n), step0=_per_row(step0s, blk, n),
               cidx=_per_row(chain_base, blk, n) + lane)
    dead = None
    if kw.get("live") is not None:
        dead = torch.from_numpy(_per_row(kw["live"], blk, n) == 0).to(DEV)
    return compare_sweep(f"B1 {variant} with t_chain, a packed PT group ({n // blk} slots "
                         f"x {blk}, dim {x.shape[1]}, {n_steps} steps)",
                         x, run, ctl, n_steps, variant, dead_rows=dead)


def temper_replay(req, res, cfg, what):
    """``res`` against its standalone run at its admitted width with its
    recorded external shrinks; the PA self-shrinks must be re-derived."""
    import dataclasses
    from repro_torch.service import run_standalone
    solo_req = req if res.admitted_chains >= req.n_chains else \
        dataclasses.replace(req, n_chains=res.admitted_chains)
    solo = run_standalone(solo_req, cfg, shrink_schedule=[
        (lvl, to) for lvl, _frm, to in res.shrink_events])
    assert_exact(res, solo, what)
    check(solo.pa_shrink_events == res.pa_shrink_events,
          f"{what}: req {req.req_id} PA self-shrinks {res.pa_shrink_events} not re-derived "
          f"({solo.pa_shrink_events})")


def exchange_ops_per_level(cps, device=None):
    """Top-level torch ops per level inside the engine's exchange
    (``engine._exchange``), from a torch.profiler trace of one K = 4 tick,
    for a group of each workload class alone and of all four together.
    Returns {class: ops per level}."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.service import EngineConfig, SAServeEngine, SARequest
    from repro_torch.service import engine as eng_mod
    real = eng_mod._exchange

    def exchange(*a, **kw):
        with record_function("serving_exchange"):
            return real(*a, **kw)
    mixes = {"sa": [{}], "sos": [dict(exchange="sos")], "pt": [dict(method="pt")],
             "pa": [dict(method="pa")],
             "all": [{}, dict(exchange="sos"), dict(method="pt"), dict(method="pa")]}
    out = {}
    eng_mod._exchange = exchange
    try:
        for name, mix in mixes.items():
            engine = SAServeEngine(EngineConfig(n_slots=4, chains_per_slot=cps, macro_k=4,
                                                device=device))
            for i, kw in enumerate(mix):
                engine.submit(SARequest(req_id=i, seed=100 + i, **{**dict(
                    objective="rastrigin", dim=4, n_chains=cps, T0=50.0, T_min=1.0,
                    rho=0.8, N=10), **kw}))
            engine.tick()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                engine.tick()
            spans = [e for e in prof.events() if e.name == "serving_exchange"]
            ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                      and e.cpu_parent is not None and e.cpu_parent.name == "serving_exchange")
            out[name] = ops / max(len(spans), 1)
    finally:
        eng_mod._exchange = real
    return out


def phase13_tempering():
    """Parallel tempering and population annealing through the serving
    engine: the mixed load at K = 1 and 4, the reference's preempt /
    resize / drain scenario at 512 chains per slot, and a pure-PA load on
    phase 8's pool whose weights sum past the reference's int32 bound."""
    from repro_torch.service import EngineConfig, SAServeEngine, SARequest
    from repro_torch.service.serve_sa import make_mix
    reqs = make_mix(TEMPER_REQUESTS, TEMPER_CFG["chains_per_slot"], seed=0,
                    method="mixed", family="mixed")
    by_method = collections.Counter(r.method for r in reqs if r.family == "continuous")
    log(f"phase 13: PT/PA serving, {len(reqs)} requests of make_mix(method='mixed', "
        f"family='mixed') (continuous {dict(by_method)}, "
        f"{sum(r.family == 'permutation' for r in reqs)} QAP SA), EngineConfig({TEMPER_CFG})")
    warm = SAServeEngine(EngineConfig(**TEMPER_CFG))         # first calls of the ops
    for r in reqs[:3]:
        warm.submit(r)
    warm.run()
    total = {"b1": 0, "b3": 0}

    def serve(k):
        engine = SAServeEngine(EngineConfig(**TEMPER_CFG, macro_k=k))
        for r in reqs:
            engine.submit(r)
        steps = time_host_steps(engine)
        with temper_spies() as spied:
            sync()
            read = counted_launches()
            t0 = time.perf_counter()
            got = {r.req_id: r for r in engine.run()}
            sync()
            wall = time.perf_counter() - t0
            launches = read()
        check(len(got) == len(reqs) and all(r.completed for r in got.values()),
              f"K={k}: not every request completed")
        check(launches["b1"] > 0 and launches["b3"] > 0 and spied["t_chain_launches"] > 0,
              f"K={k}: B1 {launches['b1']}, B3 {launches['b3']}, B1 with t_chain "
              f"{spied['t_chain_launches']}")
        return engine, got, wall, launches, spied, steps

    counts = {}
    for k in (1, 4):
        engine, got, wall, launches, spied, steps = serve(k)
        counts[k] = spied
        total["b1"] += launches["b1"]
        total["b3"] += launches["b3"]
        pa_shrinks = sum(len(r.pa_shrink_events) for r in got.values())
        evals = sum(r.n_evals for r in got.values())
        t1 = time.perf_counter()
        for req in reqs:
            res = got[req.req_id]
            check(np.isfinite(res.f_best) and res.x_best.shape == (req.dim,),
                  f"K={k}: req {req.req_id} output")
            temper_replay(req, res, engine.cfg, f"phase 13 K={k}")
        log(f"  K={k}: wall {wall:.3f} s, {len(got) / wall:.2f} requests/s, "
            f"{evals / wall:.4e} proposals/s, {engine.tick_count} ticks, "
            f"{engine.group_launches} group launches; B1 {launches['b1']} launches "
            f"({spied['t_chain_launches']} with t_chain), B3 {launches['b3']}; PA "
            f"self-shrinks {pa_shrinks}; all {len(reqs)} champions bit-exact against "
            f"run_standalone, PA self-shrinks re-derived ({time.perf_counter() - t1:.1f} s)")
        log(f"  K={k} host steps: {host_steps(steps, wall)}")
    for k, spied in counts.items():
        check(spied["pt_swaps"] > 0 and spied["pa_rows"] > 0,
              f"K={k}: PT swaps {spied['pt_swaps']}, PA resampled rows {spied['pa_rows']}")
        log(f"  K={k} exchange: PT swaps accepted {spied['pt_swaps']} in "
            f"{spied['pt_passes']} passes; PA rows resampled to another ancestor "
            f"{spied['pa_rows']} in {spied['pa_passes']} passes")
    total["max_abs_err"] = t_chain_parity(counts[4]["t_chain_call"])
    ops = exchange_ops_per_level(TEMPER_CFG["chains_per_slot"])
    log("  exchange, top-level torch ops per level by class (one K=4 tick, "
        "torch.profiler): " + ", ".join(f"{k} {v:.0f}" for k, v in ops.items()))
    # The reference's test_classes_survive_preempt_resize_drain at 512
    # chains per slot.
    cps = TEMPER_CFG["chains_per_slot"]
    base = dict(dim=4, n_chains=cps, T0=50.0, T_min=1.0, rho=0.8, N=10)
    mix = [dict(objective="rastrigin", method="pt"),
           dict(objective="ackley", dim=8, method="pa"),
           dict(objective="schwefel", exchange="sos"),
           dict(objective="griewank", n_chains=2 * cps, method="pt"),
           dict(objective="rastrigin", dim=8)]
    sreqs = [SARequest(req_id=i, seed=100 + i, **{**base, **kw}) for i, kw in enumerate(mix)]
    runs = {}
    for k in (1, 4):
        cfg = EngineConfig(n_slots=4, chains_per_slot=cps, n_devices=2, macro_k=k)
        engine = SAServeEngine(cfg)
        for r in sreqs:
            engine.submit(r)
        engine.schedule_op(8, lambda e=engine: e.preempt(0))
        engine.schedule_op(8, lambda e=engine: e.resize(3))
        engine.schedule_op(16, lambda e=engine: e.drain(1))
        runs[k] = {r.req_id: r for r in engine.run()}
        check(engine.preemptions >= 1 and engine.retired_shards,
              f"scenario K={k}: the preempt or the drain did not act")
        for req in sreqs:
            temper_replay(req, runs[k][req.req_id], cfg, f"scenario K={k}")
    stamps = ("champion_history", "f_best", "levels_run", "finish_tick", "first_tick")
    for rid, a in runs[1].items():
        b = runs[4][rid]
        check(all(getattr(a, s) == getattr(b, s) for s in stamps)
              and np.array_equal(a.x_best, b.x_best), f"scenario: req {rid} K=4 != K=1")
    log(f"  preempt/resize/drain scenario ({len(sreqs)} requests, PT, PA, SOS, sync, "
        f"{cps} chains per slot): K=4 equals K=1, every result bit-exact against its "
        f"standalone replay")
    # A pure-PA load on phase 8's pool, for its first levels: near T0 every
    # weight is close to the full scale, so the group's prefix sum passes
    # 2^31 - 1, where the reference's int32 sum would wrap.
    pcfg = EngineConfig(**SERVE_CFG)
    preqs = [SARequest(req_id=i, seed=7000 + i, n_chains=pcfg.chains_per_slot,
                       method="pa", **PA_LOAD) for i in range(pcfg.n_slots)]
    engine = SAServeEngine(pcfg)
    for r in preqs:
        engine.submit(r)
    with temper_spies(weights=True) as spied:
        sync()
        read = counted_launches()
        t0 = time.perf_counter()
        pgot = {r.req_id: r for r in engine.run()}
        sync()
        wall = time.perf_counter() - t0
        launches = read()
    total["b1"] += launches["b1"]
    check(len(pgot) == len(preqs) and launches["b1"] > 0, "pure-PA load did not complete")
    check(spied["pa_max_sum"] > 2**31 - 1,
          f"the PA weights summed to {spied['pa_max_sum']}, not past 2^31 - 1")
    for req in preqs:
        temper_replay(req, pgot[req.req_id], pcfg, "pure PA")
    log(f"  pure PA: {len(preqs)} requests x {pcfg.chains_per_slot} chains in one group "
        f"({len(preqs) * pcfg.chains_per_slot} chains), {preqs[0].n_levels} levels of "
        f"{PA_LOAD}, K={pcfg.macro_k}: wall {wall:.3f} s, B1 {launches['b1']} launches; "
        f"largest prefix sum of the quantized weights {spied['pa_max_sum']} "
        f"({spied['pa_max_sum'] / (2**31 - 1):.2f} x 2^31 - 1); PA rows resampled "
        f"{spied['pa_rows']}; every tenant bit-exact against its standalone run")
    return total


# ------------------------------------------------------------- slice 7
def elastic_engine(telemetry):
    """An engine with ``telemetry`` for phase 10's load, its scripted
    operations scheduled; returns (engine, arrivals)."""
    from repro_torch.service import ArrivalProcess, EngineConfig, SAServeEngine, SchedulerConfig
    cfg = EngineConfig(**ELASTIC_CFG, device=DEV, scheduler=SchedulerConfig(**ELASTIC_SCHED))
    engine = SAServeEngine(cfg, telemetry=telemetry)
    script_ops(engine, {})
    return engine, ArrivalProcess.bursty(elastic_requests(), **ELASTIC_ARRIVALS)


def serve_elastic(telemetry=None, engine=None, arrivals=None):
    """Phase 10's load through an engine with ``telemetry`` (or through
    ``engine`` from :func:`elastic_engine`); returns (engine, results by
    id, wall, launches, kernel builds during the run)."""
    from repro_torch.service import kernel_builds
    if engine is None:
        engine, arrivals = elastic_engine(telemetry)
    sync()
    read, builds = counted_launches(), kernel_builds()
    t0 = time.perf_counter()
    results = engine.run_stream(arrivals)
    sync()
    wall = time.perf_counter() - t0
    return engine, {r.req_id: r for r in results}, wall, read(), kernel_builds() - builds


def phase14a_telemetry():
    """Phase 10's load served with telemetry off, then on twice (trace and
    event log): the same champions and launches, no build, equal event
    logs, a valid trace; wall and CPU seconds per tick phase, device_wait
    per shard, the cost of the fence, and where dispatch's time goes."""
    from repro_torch.service import EventLog, Telemetry, TICK_PHASES, TraceBuilder, validate_trace
    from repro_torch.service.serve_sa import replay_check
    log(f"phase 14a: telemetry on phase 10's load ({ELASTIC_REQUESTS} requests, "
        f"EngineConfig({ELASTIC_CFG}), the scripted operations of phase 10): off, on, on")
    runs = [serve_elastic(None)]
    for _ in range(2):
        runs.append(serve_elastic(Telemetry(trace=TraceBuilder(), events=EventLog())))
    (_, off, off_wall, off_launches, _), on = runs[0], runs[1:]
    stamps = ("f_best", "champion_history", "levels_run", "finish_tick", "finish_reason",
              "preempted_ticks", "migrated_ticks", "shrink_events", "truncate_events")
    for engine, got, wall, launches, builds in on:
        check(got.keys() == off.keys(), "phase 14a: another set of results with telemetry on")
        for rid, res in got.items():
            ref = off[rid]
            check(all(getattr(res, s) == getattr(ref, s) for s in stamps)
                  and np.array_equal(res.x_best, ref.x_best),
                  f"phase 14a: req {rid} differs with telemetry on")
        check(launches == off_launches, f"phase 14a: launches on {launches}, off {off_launches}")
        check(builds == 0, f"phase 14a: {builds} kernel builds with telemetry on")
        errors = validate_trace(engine.telemetry.trace.to_json())
        check(errors == [], f"phase 14a: trace invalid: {errors[:3]}")
    (eng1, got1, wall1, _, _), (eng2, _, wall2, _, _) = on
    check(eng1.telemetry.events.dumps() == eng2.telemetry.events.dumps(),
          "phase 14a: the two event logs differ")
    t0 = time.perf_counter()
    by_req = {r.req_id: r for r in elastic_requests()}
    done = [rid for rid, res in got1.items() if res.completed]
    for rid in done:
        check(replay_check(by_req[rid], got1[rid], eng1.cfg),
              f"phase 14a: req {rid} differs from its standalone replay")
    log(f"  champions of all {len(got1)} requests equal across the three runs, the "
        f"{len(done)} completed ones bit-exact against run_standalone "
        f"({time.perf_counter() - t0:.1f} s); B1 {off_launches['b1']} and B3 "
        f"{off_launches['b3']} launches in every run; no kernel build; event logs equal "
        f"({len(eng1.telemetry.events.records)} records); trace valid "
        f"({len(eng1.telemetry.trace.events)} events)")
    log(f"  wall: off {off_wall:.3f} s, on {wall1:.3f} s and {wall2:.3f} s "
        f"(on/off {wall1 / off_wall:.3f}, {wall2 / off_wall:.3f})")
    for i, (engine, _, wall, _, _) in enumerate(on, 1):
        tel = engine.telemetry
        phases = engine.stats()["phases"]
        wall_s = {p: phases["aggregate"][p]["sum"] for p in TICK_PHASES}
        cpu_s = phases["cpu_seconds"]
        check(set(wall_s) == set(TICK_PHASES), f"phase 14a: phases {sorted(wall_s)}")
        log(f"  on run {i}: per tick phase, wall / CPU seconds: " + ", ".join(
            f"{p} {wall_s[p]:.4f} / {cpu_s[p]:.4f}" for p in TICK_PHASES)
            + f"; spans {sum(wall_s.values()):.3f} s of {wall:.3f} s")
        waits = {shard: secs for (shard, phase), secs
                 in sorted(tel.registry["sa_shard_phase_seconds_total"].series.items())
                 if phase == "device_wait"}
        launches = tel.registry["sa_group_launches_total"].value()
        log(f"  on run {i}: device_wait per shard (s): {waits}; dispatch wall "
            f"{wall_s['dispatch']:.4f} s against CPU {cpu_s['dispatch']:.4f} s "
            f"(CPU/wall {cpu_s['dispatch'] / wall_s['dispatch']:.3f}), "
            f"{1e3 * wall_s['dispatch'] / launches:.3f} ms wall per group launch "
            f"({launches:.0f})")
    # Where dispatch goes: one more run with the launch path's parts
    # timed, host packing against the K levels of launches.
    engine, arrivals = elastic_engine(Telemetry())
    with timed_dispatch_parts(engine) as parts:
        serve_elastic(engine=engine, arrivals=arrivals)
    dispatch = engine.stats()["phases"]["aggregate"]["dispatch"]["sum"]
    parts["other"] = dispatch - sum(parts.values())
    log("  dispatch split (one more on run, host clock around each part): " + ", ".join(
        f"{name} {secs:.4f} s ({100 * secs / dispatch:.1f}%)" for name, secs in parts.items())
        + f" of {dispatch:.4f} s")
    return off_launches


DISPATCH_PARTS = ("_pack", "_host_state", "_upload", "_group_tick_fused")


@contextlib.contextmanager
def timed_dispatch_parts(engine):
    """Host seconds of the fused launch path's parts while inside: the
    host packing of controls (``_pack``) and of state on a cache miss
    (``_host_state``), the upload (``_upload``), and the K levels of
    sweep and exchange launches (``_group_tick_fused``)."""
    from repro_torch.service import engine as engine_mod
    parts = time_host_steps(engine, DISPATCH_PARTS[:2])
    reals = {name: getattr(engine_mod, name) for name in DISPATCH_PARTS[2:]}
    for name, fn in reals.items():
        def part(*a, _fn=fn, _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                parts[_name] = parts.get(_name, 0.0) + time.perf_counter() - t
        setattr(engine_mod, name, part)
    try:
        yield parts
    finally:
        for name, fn in reals.items():
            setattr(engine_mod, name, fn)


def phase14b_autoscaler(smi):
    """The reference's autoscaler bench: a seeded diurnal trace with
    completion deadlines served by static fleets of 1-4 shards and by the
    autoscaler from one shard; its autoscale_committed gates, and every
    champion against its standalone replay."""
    from repro_torch.service import (ArrivalProcess, Autoscaler, AutoscalerConfig, EngineConfig,
                                     SAServeEngine, SchedulerConfig, latency_summary)
    from repro_torch.service.arrivals import percentile
    from repro_torch.service.serve_sa import make_mix, replay_check
    reqs = make_mix(AUTOSCALE_REQUESTS, AUTOSCALE_CFG["chains_per_slot"], **AUTOSCALE_MIX)
    log(f"phase 14b: autoscaler against static fleets, {len(reqs)} requests of "
        f"make_mix({AUTOSCALE_MIX}), diurnal arrivals {AUTOSCALE_ARRIVALS}, "
        f"EngineConfig({AUTOSCALE_CFG}); AutoscalerConfig({AUTOSCALE_CTL}); {smi}")
    fleets = [(f"static{n}", n, None) for n in range(1, AUTOSCALE_CTL["max_shards"] + 1)]
    ctl = Autoscaler(AutoscalerConfig(**AUTOSCALE_CTL))
    fleets.append(("auto", 1, ctl))
    rows, b1 = {}, 0
    for label, n, controller in fleets:
        cfg = EngineConfig(**AUTOSCALE_CFG, n_devices=n, device=DEV,
                           scheduler=SchedulerConfig())
        engine = SAServeEngine(cfg)
        if controller is not None:
            engine.attach_controller(controller)
        arrivals = ArrivalProcess.diurnal(reqs, **AUTOSCALE_ARRIVALS)
        sync()
        read = counted_launches()
        t0 = time.perf_counter()
        results = engine.run_stream(arrivals, max_ticks=20000)
        sync()
        wall = time.perf_counter() - t0
        b1 += read()["b1"]
        got = {r.req_id: r for r in results}
        viol = [got[q.req_id].latency_ticks - q.finish_deadline
                for q in reqs if q.req_id in got and got[q.req_id].completed]
        lat = latency_summary(results, ticks=engine.tick_count, n_submitted=engine.n_submitted)
        row = rows[label] = dict(
            shard_ticks=engine.slot_ticks / cfg.n_slots, ticks=engine.tick_count,
            completed=lat["completed"], lost=engine.n_submitted - len(results),
            p99_violation=percentile(viol, 99), truncations=engine.truncations, wall=wall)
        row["slo_met"] = bool(row["p99_violation"] <= 0.0)
        t1 = time.perf_counter()
        for req in reqs:
            res = got[req.req_id]
            check(res.completed and np.isfinite(res.f_best) and res.x_best.shape == (req.dim,),
                  f"phase 14b {label}: req {req.req_id} output")
            check(replay_check(req, res, cfg),
                  f"phase 14b {label}: req {req.req_id} differs from its standalone replay "
                  f"(cuts {res.truncate_events})")
        log(f"  {label}: shard_ticks {row['shard_ticks']:.0f}, ticks {row['ticks']}, p99 "
            f"violation {row['p99_violation']:.4f} ticks (SLO {'met' if row['slo_met'] else 'missed'}), "
            f"truncations {row['truncations']}, completed {row['completed']}, lost {row['lost']}, "
            f"wall {wall:.3f} s; every champion bit-exact against its standalone replay "
            f"({time.perf_counter() - t1:.1f} s)")
    auto = rows["auto"]
    static_ok = [label for label, row in rows.items() if label != "auto" and row["slo_met"]]
    best = min(static_ok, key=lambda label: rows[label]["shard_ticks"], default=None)
    saving = 100.0 * (1.0 - auto["shard_ticks"] / rows[best]["shard_ticks"]) if best else math.nan
    log(f"  autoscaler: {ctl.samples} samples, decisions {ctl.decisions}; shard-tick saving "
        f"{saving:.2f}% against {best}")
    check(all(row["lost"] == 0 for row in rows.values()), "phase 14b: a run lost a request")
    check(all(row["completed"] == len(reqs) for row in rows.values()),
          "phase 14b: a run did not complete every request")
    check(auto["slo_met"], "phase 14b: the autoscaler missed the p99 completion SLO")
    check(best is not None, "phase 14b: no static fleet meets the p99 completion SLO")
    check(saving >= AUTOSCALE_MIN_SAVING_PCT,
          f"phase 14b: shard-tick saving {saving:.2f}% < {AUTOSCALE_MIN_SAVING_PCT}%")
    check(ctl.samples > 0 and ctl.decisions, "phase 14b: the controller never acted")
    return b1


# ------------------------------------------------------------- slice 8
@contextlib.contextmanager
def world_of_one():
    """A world-size-1 NCCL process group in this process (a HashStore: no
    network), torn down on leaving."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_counted(fn, dev=None):
    """fn() with B1's, B2's and B3's launch counters zeroed just before it
    and read just after, and its all-gathers counted (on ``dev``, default
    DEV).  Returns (result, wall s, launches, all-gathers)."""
    import torch.distributed as dist
    real = dist.all_gather_into_tensor
    gathers = [0]

    def spy(*a, **kw):
        gathers[0] += 1
        return real(*a, **kw)

    sync(dev)
    read = counted_launches()
    dist.all_gather_into_tensor = spy
    try:
        t0 = time.perf_counter()
        r = fn()
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        dist.all_gather_into_tensor = real
    return r, wall, read(), gathers[0]


def same_bits(a, b, history=True):
    """Two SAResults hold the same f_best, x_best and (with ``history``)
    history_f, bit for bit."""
    return (np.float64(a.f_best).tobytes() == np.float64(b.f_best).tobytes()
            and a.x_best.dtype == b.x_best.dtype and a.x_best.tobytes() == b.x_best.tobytes()
            and (not history or (a.history_f is None) == (b.history_f is None)
                 and (a.history_f is None or a.history_f.tobytes() == b.history_f.tobytes())))


def phase15a_sharded(smi, p3):
    """The sharded ladder on the card: phase 4's cell over a (1,) mesh and
    a (1, 1) mesh cut along "data", in turns with the unsharded run; then
    phase 5's V1 and SOS cells and phase 3's hybrid over the (1,) mesh.
    Each equals its unsharded run bit for bit, with the same B1 and B2
    launches and one all-gather per exchange level."""
    from repro_torch.core import SAConfig, hybrid_minimize, sa_minimize
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.objectives import functions as F
    cfg = SAConfig(**MAIN_CFG)
    obj = F.schwefel(MAIN_DIM)
    L = cfg.n_levels
    mesh1 = make_mesh((1,), ("data",))
    meshes = {"(1,) over data": (mesh1, None),
              "(1, 1) over data": (make_mesh((1, 1), ("data", "model")), ("data",))}
    log(f"phase 15a: the sharded ladder, sa_minimize(schwefel({MAIN_DIM}), {MAIN_CFG}, "
        f"mesh=...) over a world-size-1 NCCL group, {L} levels, in turns with the "
        f"unsharded run; {smi}")
    # The first collective sets up NCCL's communicator: a one-level run.
    _, t_first, _, _ = run_counted(lambda: sa_minimize(
        obj, SAConfig(**{**MAIN_CFG, "T_min": MAIN_CFG["T0"]}), mesh=mesh1))
    log(f"  first sharded call (one level, NCCL's communicator set up): {t_first:.3f} s")
    labels = ["unsharded", *meshes]
    turns = labels + labels[:0:-1] + labels[:1]
    order = []
    for label in turns:
        m, a = meshes.get(label, (None, None))
        order.append((label, run_counted(lambda: sa_minimize(obj, cfg, mesh=m, mesh_axes=a))))
    ref, ref_wall, ref_n, ref_g = order[0][1]
    check(ref_g == 0, f"phase 15a: the unsharded run made {ref_g} all-gathers")
    out = {"b1_full": 0, "b1_delta": 0, "b2": 0}
    for label, (r, wall, n, g) in order:
        check(same_bits(r, ref), f"phase 15a {label}: f_best, x_best or history_f differ "
              f"from the first unsharded run ({r.f_best!r} vs {ref.f_best!r})")
        check(n == ref_n, f"phase 15a {label}: launches {n}, unsharded {ref_n}")
        if label != "unsharded":
            # One per exchange level, the final champion and the history.
            check(g == L + 2, f"phase 15a {label}: {g} all-gathers, expected {L + 2}")
            out["b1_full"] += n["b1"]
            out["b2"] += n["b2"]
    log(f"  f_best {ref.f_best:.6f}: f_best, x_best and history_f bit-equal to the unsharded "
        f"run on both meshes; launches {ref_n} in every run; {L} all-gathers in the levels "
        f"plus the final champion's and the history's")
    log("  wall in turns: " + ", ".join(f"{label} {run[1]:.3f} s" for label, run in order))
    walls = collections.defaultdict(list)
    for label, run in order:
        walls[label].append(run[1])
    log("  unsharded, profiled:")
    _, plain_ops = sa_device_share(obj, MAIN_CFG, min(walls["unsharded"]) / L,
                                   "sweep_full")
    log("  over the (1,) mesh, profiled:")
    _, mesh_ops = sa_device_share(obj, MAIN_CFG, min(walls["(1,) over data"]) / L,
                                  "sweep_full", mesh=mesh1)
    extra = {k: v - plain_ops.get(k, 0.0) for k, v in mesh_ops.items()
             if v - plain_ops.get(k, 0.0) > 1e-6}
    log("  device ms per level added by the mesh, by op: "
        + (", ".join(f"{k} {v:.5f}" for k, v in sorted(extra.items())) or "none measured"))
    gather_host_costs(mesh1)

    base = dict(T0=100.0, T_min=1.0, rho=0.9, N=100, use_delta_eval=True, n_chains=V1_CHAINS)
    obj32 = F.schwefel(32)
    for label, exchange in (("V1 async", "async"), ("SOS", "sos")):
        c = SAConfig(**base, exchange=exchange)
        u, _, un, _ = run_counted(lambda: sa_minimize(obj32, c))
        r, wall, n, g = run_counted(lambda: sa_minimize(obj32, c, mesh=mesh1))
        want_g = 1 if exchange == "async" else c.n_levels + 2
        check(same_bits(r, u, history=exchange != "async"),
              f"phase 15a {label}: differs from the unsharded run")
        check(exchange != "async" or r.history_f is None, "phase 15a V1: history kept")
        check(n == un and g == want_g,
              f"phase 15a {label}: launches {n} vs {un}, {g} all-gathers vs {want_g}")
        out["b1_delta"] += n["b1"]
        out["b2"] += n["b2"]
        log(f"  schwefel(32) {label}, {V1_CHAINS} chains: f_best {r.f_best:.4f} bit-equal to "
            f"the unsharded run, launches {n}, {g} all-gathers, wall {wall:.3f} s")

    h_ref = p3["result"]
    h, wall, n, g = run_counted(lambda: hybrid_minimize(obj, SAConfig(**DELTA_CFG), mesh=mesh1))
    check(same_bits(h.sa, h_ref.sa) and h.nm.f_best == h_ref.nm.f_best
          and h.x_best.tobytes() == h_ref.x_best.tobytes(),
          "phase 15a: hybrid_minimize(mesh=) differs from phase 3's run")
    check(n["b1"] == p3["launches"]["metropolis_sweep"] and n["b2"] == p3["launches"]["argmin_reduce"],
          f"phase 15a hybrid: launches {n} vs phase 3's {p3['launches']}")
    check(g == L + 2, f"phase 15a hybrid: {g} all-gathers, expected {L + 2}")
    out["b1_delta"] += n["b1"]
    out["b2"] += n["b2"]
    log(f"  hybrid_minimize(mesh=) on phase 3's cell: SA {h.sa.f_best:.6f}, NM {h.nm.f_best:.6f}, "
        f"bit-equal to phase 3's run, launches {n}, {g} all-gathers, wall {wall:.3f} s")
    return out, mesh1


def gather_host_costs(mesh, n=500):
    """Host microseconds per call of the sharded exchange's parts at phase
    4's shape, each loop of n calls ended by a synchronise: B2's local
    champion, one all-gather of dim + 1 floats, the champion over the
    shards given the local one, and the mesh lookup that a ladder makes
    once."""
    import torch.distributed as dist
    from repro_torch.core import exchange as exch
    x = torch.rand(MAIN_CFG["n_chains"], MAIN_DIM, device=DEV)
    fx = torch.rand(MAIN_CFG["n_chains"], device=DEV)
    packed = torch.rand(MAIN_DIM + 1, device=DEV)
    out = torch.empty_like(packed)
    shard = exch.Shard.over(mesh, ("data",))
    xb, fb = exch.local_champion(x, fx)
    parts = {"local_champion (B2)": lambda: exch.local_champion(x, fx),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                 out, packed, group=shard.group),
             "gather_champion": lambda: exch.gather_champion(xb, fb, shard),
             "Shard.over (once per ladder)": lambda: exch.Shard.over(mesh, ("data",))}
    cost = {}
    for name, fn in parts.items():
        for _ in range(20):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        cost[name] = (time.perf_counter() - t0) / n * 1e6
    log(f"  host us per call ({n} calls, then a synchronise): "
        + ", ".join(f"{k} {v:.1f}" for k, v in cost.items()))
    return cost


def phase15b_autotune(smi, mesh1):
    """The sharding autotuner on the card: SA (the plain sweep, B2's
    champions) against the exhaustive grid for every architecture, and
    one architecture again over the mesh."""
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.core import SAConfig
    from repro_torch.distributed import autotune as TA
    levels = SAConfig(T0=1.0, T_min=1e-3, rho=0.85, N=20).n_levels   # autotune's ladder
    log(f"phase 15b: the sharding autotuner, {len(ARCH_IDS)} architectures, "
        f"TuneProblem(**{AUTOTUNE_PROBLEM}), n_chains {AUTOTUNE_CHAINS}, seed 0, {levels} "
        f"levels of N = 20; constants PEAK_FLOPS {TA.PEAK_FLOPS:.4g}, HBM_BW {TA.HBM_BW:.4g}, "
        f"LINK_BW {TA.LINK_BW:.4g}, HBM_CAP {TA.HBM_CAP:.4g} (H100 SXM5 80GB datasheet); {smi}")
    b2 = 0
    for aid in ARCH_IDS:
        prob = TA.TuneProblem(cfg=get_arch(aid).model, **AUTOTUNE_PROBLEM)
        (choice, cost), wall, n, _ = run_counted(
            lambda: TA.autotune(prob, n_chains=AUTOTUNE_CHAINS, seed=0))
        t0 = time.perf_counter()
        ex_choice, ex_cost = TA.exhaustive_best(prob)
        sync()
        t_ex = time.perf_counter() - t0
        gap = (cost - ex_cost) / ex_cost
        log(f"  {aid}: SA {cost * 1e3:.4f} ms/step {choice} in {wall:.3f} s; exhaustive "
            f"{ex_cost * 1e3:.4f} ms/step {ex_choice} in {t_ex:.4f} s; gap {100 * gap:.3f}%; "
            f"launches {n}")
        check(cost <= (1.0 + AUTOTUNE_MAX_GAP) * ex_cost,
              f"phase 15b {aid}: SA cost {cost} above {1 + AUTOTUNE_MAX_GAP} x {ex_cost}")
        check(n["b1"] == 0 and n["b2"] == 2 * levels + 2,
              f"phase 15b {aid}: route (plain sweep + B2) not taken: launches {n}")
        b2 += n["b2"]
    prob = TA.TuneProblem(cfg=get_arch(AUTOTUNE_MESH_ARCH).model, **AUTOTUNE_PROBLEM)
    want = TA.autotune(prob, n_chains=AUTOTUNE_CHAINS, seed=0)
    got, wall, n, g = run_counted(
        lambda: TA.autotune(prob, n_chains=AUTOTUNE_CHAINS, seed=0, mesh=mesh1))
    check(got == want, f"phase 15b: autotune(mesh=) {got} differs from {want}")
    check(g == levels + 1, f"phase 15b: {g} all-gathers, expected {levels + 1}")
    b2 += n["b2"]
    log(f"  {AUTOTUNE_MESH_ARCH} over the (1,) mesh: {got[0]}, {got[1] * 1e3:.4f} ms/step, "
        f"equal to the unsharded run; {g} all-gathers, wall {wall:.3f} s")
    return b2


def phase15_sharded(smi, p3):
    with world_of_one():
        out, mesh1 = phase15a_sharded(smi, p3)
        out["b2"] += phase15b_autotune(smi, mesh1)
    return out


# ------------------------------------------------------------- slice 9
def tree_map(fn, tree):
    """fn on every tensor of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tensor_bytes(tree):
    """Bytes of every tensor of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def llm_cfg(arch, dtype, **over):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).model, param_dtype=dtype, compute_dtype=dtype,
                               **over)


def llm_bound(cfg, tokens, keys, read_bytes, decode=False, enc_len=0):
    """The least time of one forward over ``tokens`` query positions
    (``keys`` key positions each, per layer; ``enc_len`` encoder
    positions), in ms, and what bounds it: the bytes of ``read_bytes``
    (the weights the forward reads, plus the cache a decode tick reads)
    at the HBM rate, or the operations, layer by layer, in the forward's
    own dtypes: products of the compute dtype at its rate (bf16 at its
    dense tensor-core peak, float32 at the non-tensor-core one), float32
    ones (attention's float32 scores and output, p·c_kv, ctx·W_uv, the
    router, Mamba's scan) at the float32 rate.  GQA: 4·H·hd per
    query-key pair.  MLA prefill: 2·H·(d_nope+d_rope) per pair for the
    scores and 2·H·d_v for p·v, beside expanding c_kv through W_uk and
    W_uv for every token; absorbed decode: 2·H·(kv_lora+d_rope) for the
    scores and 2·H·kv_lora for p·c_kv, beside q·W_uk^T and ctx·W_uv.
    Mamba: its four projections (in, x, dt, out) in the compute dtype;
    the conv's 2·d_conv per channel and 7 float32 operations per token,
    channel and state (dA's product and exp, dBx's product, the
    recurrence's product and sum, y's product and sum).  Cross-attention:
    q and the output projections for every token, k and v over the
    ``enc_len`` encoder positions at prefill (decode reads them cached),
    4·H·hd float32 per query-key pair.  The encoder's dense layers run at
    prefill only, over ``enc_len`` positions each way.  MoE: the experts
    run E·C capacity rows (C from the forward's T = ``tokens``), the
    shared experts every token."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import layer_specs
    D, V, H = cfg.d_model, cfg.vocab_size, cfg.n_heads
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    mm = 2 * tokens * V * D                                    # the head
    f32 = 0
    for spec in layer_specs(cfg):
        mm += 2 * tokens * (1 + (spec.mlp != "none") + spec.cross_attn) * D   # the norms
        if spec.kind == "mla":
            c, dn, dr, dv = cfg.kv_lora, cfg.d_nope, cfg.d_rope, cfg.head_dim
            mm += 2 * tokens * (D * H * (dn + dr) + D * (c + dr) + H * dv * D)
            if decode:
                mm += 2 * tokens * H * dn * c + 2 * H * (c + dr) * tokens * keys
                f32 += 2 * H * c * tokens * keys + 2 * tokens * H * c * dv
            else:
                mm += 2 * tokens * c * H * (dn + dv) + 2 * H * (dn + dr) * tokens * keys
                f32 += 2 * H * dv * tokens * keys
        elif spec.kind == "mamba":
            Di, N, R = cfg.d_inner, cfg.d_state, cfg.dt_rank_eff
            mm += 2 * tokens * (D * 2 * Di + Di * (R + 2 * N) + R * Di + Di * D)
            f32 += tokens * Di * (2 * cfg.d_conv + 7 * N)
        else:
            mm += 2 * tokens * (D * (H + 2 * kv) * hd + H * hd * D)
            f32 += 4 * H * hd * tokens * keys
        if spec.cross_attn:
            mm += 2 * tokens * 2 * D * H * hd
            if not decode:
                mm += 2 * enc_len * 2 * D * H * hd
            f32 += 4 * H * hd * tokens * enc_len
        if spec.mlp == "moe":
            E, F = cfg.n_experts, cfg.d_ff_expert
            C = L.moe_capacity(tokens, cfg.top_k, E, cfg.capacity_factor)
            mm += 2 * E * C * 3 * D * F + 2 * tokens * 3 * D * cfg.n_shared * F
            f32 += 2 * tokens * D * E
        elif spec.mlp == "dense":
            mm += 2 * tokens * 3 * D * cfg.d_ff
    if cfg.kind == "encdec" and not decode:
        mm += cfg.n_enc_layers * 2 * enc_len * (2 * D + D * (H + 2 * kv) * hd + H * hd * D
                                                + 3 * D * cfg.d_ff)
        f32 += cfg.n_enc_layers * 4 * H * hd * enc_len * enc_len
    mm_rate = BF16_OPS_PER_S if cfg.compute_dtype == "bfloat16" else FP32_OPS_PER_S
    ops_ms = (mm / mm_rate + f32 / FP32_OPS_PER_S) * 1e3
    bytes_ms = read_bytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def weight_read_bytes(cfg, params, tokens, decode):
    """The parameter bytes one forward reads: every tensor, but of the
    learned position tables only the rows it gathers (``tokens`` of the
    decoder's, the frames' of the encoder's), and at decode none of the
    encoder nor the cross-attention's ``wk`` and ``wv`` (k and v are in
    the ``ck``/``cv`` caches)."""
    total = tensor_bytes(params)
    if "pos_embed" in params:
        t = params["pos_embed"]
        total -= tensor_bytes(t) - tokens * t.shape[1] * t.element_size()
    if "enc" in params:
        t = params["enc"]["pos_embed"]
        total -= (tensor_bytes(params["enc"]) if decode else
                  tensor_bytes(t) - cfg.frontend_len * t.shape[1] * t.element_size())
    if decode:
        total -= sum(tensor_bytes(lp["cross"][w]) for lp in params["layers"] if "cross" in lp
                     for w in ("wk", "wv"))
    return total


@contextlib.contextmanager
def timed_forward():
    """Every ``models.model.forward`` call of the serving path (the
    driver's prefills and the steps' decode ticks) timed with CUDA events
    by mode, and its logits' non-finite values counted on the card.
    Yields {"prefill": [ms], "decode": [ms], "bad": tensor}, filled on
    leaving."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M
    real = M.forward
    marks = {"prefill": [], "decode": []}
    out = {"prefill": [], "decode": [], "bad": torch.zeros((), dtype=torch.int64, device=DEV)}

    def wrapped(params, cfg, tokens=None, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        logits, caches = real(params, cfg, tokens, **kw)
        b.record()
        marks[kw.get("mode", "train")].append((a, b))
        out["bad"] += (~torch.isfinite(logits)).sum()
        return logits, caches

    M.forward = serve_mod.forward = wrapped
    try:
        yield out
    finally:
        M.forward = serve_mod.forward = real
        torch.cuda.synchronize()
        for mode, pairs in marks.items():
            out[mode] = [a.elapsed_time(b) for a, b in pairs]


def device_by_op(fn, n, top=8):
    """The device time of n calls of fn, per call, summed by the aten op
    that launched it (self time), its largest ``top`` as text with each
    op's calls per fn()."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        sync()
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    return ", ".join(f"{e.key} {e.self_device_time_total / 1e3 / n:.3f} ms ({e.count // n})"
                     for e in ops[:top])


def serve_load(smi, label, cfg, load, seed=0, breakdown=True):
    """One full-width serving run through ``launch.serve.serve`` (after a
    two-request warm-up), logged: timings, rates, memory, the decode
    tick's bound and a profiler trace of 10 ticks; with ``breakdown`` a
    second trace's device ms by aten op and the cache's float32 cast
    timed apart.  An encoder-decoder's requests carry audio-stub frames
    (frontend_len, D) from the seed.  Returns the model."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    model = M.Model(cfg, device=DEV, seed=seed)
    sync()
    init_s = time.perf_counter() - t0
    weight_bytes = tensor_bytes(model.params())
    rng = np.random.default_rng(seed)
    queue = [rng.integers(1, cfg.vocab_size, size=load["prompt"]).astype(np.int32)
             for _ in range(load["requests"])]
    kw = dict(batch=load["batch"], max_new=load["max_new"], s_max=load["s_max"], device=DEV)
    if cfg.kind == "encdec":
        kw["frames"] = [rng.standard_normal((cfg.frontend_len, cfg.d_model)).astype(np.float32)
                        for _ in queue]
    warm = dict(kw, max_new=4)
    if "frames" in kw:
        warm["frames"] = kw["frames"][:2]
    serve_mod.serve(cfg, model, queue[:2], **warm)                   # warm-up
    caches = M.init_cache(cfg, load["batch"], load["s_max"],
                          dtype=getattr(torch, cfg.compute_dtype), device=DEV,
                          enc_len=serve_mod.enc_len(cfg))
    cache_bytes = tensor_bytes(caches)
    cross_bytes = sum(tensor_bytes(c[n]) for c in caches for n in ("ck", "cv") if n in c)
    del caches
    torch.cuda.reset_peak_memory_stats()
    with timed_forward() as times:
        t0 = time.perf_counter()
        outputs, ticks = serve_mod.serve(cfg, model, queue, **kw)
        sync()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(all(len(o) == load["max_new"] for o in outputs),
          f"phase {label}: a request got {sorted({len(o) for o in outputs})} tokens, not "
          f"{load['max_new']}")
    check(int(times["bad"]) == 0, f"phase {label}: {int(times['bad'])} non-finite logits")
    check(len(times["decode"]) == ticks and len(times["prefill"]) == len(queue),
          f"phase {label}: {len(times['prefill'])} prefills and {len(times['decode'])} ticks timed")
    tokens = sum(len(o) for o in outputs)
    pre_ms, tick_ms = statistics.median(times["prefill"]), statistics.median(times["decode"])
    params = model.params()
    enc = serve_mod.enc_len(cfg)
    pre_bound = llm_bound(cfg, load["prompt"], load["prompt"],
                          weight_read_bytes(cfg, params, load["prompt"], False), enc_len=enc)
    tick_weights = weight_read_bytes(cfg, params, load["batch"], True)
    tick_bound = llm_bound(cfg, load["batch"], load["s_max"], tick_weights + cache_bytes,
                           decode=True, enc_len=enc)
    log(f"  {cfg.name} {cfg.param_dtype}: {model.cfg.param_count()[0] / 1e9:.3f} B parameters, "
        f"{cfg.n_layers} layers, init {init_s:.2f} s; {len(queue)} requests x prompt "
        f"{load['prompt']}, max_new {load['max_new']}, {load['batch']} slots, s_max "
        f"{load['s_max']}; {smi}")
    log(f"  prefill {pre_ms:.3f} ms per request (median of {len(queue)}, CUDA events; bound "
        f"{pre_bound[0]:.3f} ms by {pre_bound[1]}, {100 * pre_bound[0] / pre_ms:.1f}% of it)")
    log(f"  decode {tick_ms:.3f} ms per tick (median of {ticks}; min "
        f"{min(times['decode']):.3f}, max {max(times['decode']):.3f}); bound "
        f"{tick_bound[0]:.3f} ms by {tick_bound[1]} ((weights read {fmt_mem(tick_weights)} + "
        f"cache {fmt_mem(cache_bytes)}) / 3.35 TB/s for bytes), the tick at "
        f"{100 * tick_bound[0] / tick_ms:.1f}% of it")
    if cross_bytes:
        log(f"  cross-attention caches ck + cv: {fmt_mem(cross_bytes)} of the cache "
            f"({load['batch']} slots x {enc} encoder positions)")
    log(f"  {tokens} tokens in {ticks} ticks, wall {wall:.3f} s, {tokens / wall:.1f} tokens/s; "
        f"weights {fmt_mem(weight_bytes)}, cache {fmt_mem(cache_bytes)}, peak card memory "
        f"{fmt_mem(peak)}; every request {load['max_new']} tokens, all logits finite")
    # A profiler trace of 10 ticks of the full batch at the last tick's
    # positions (each rewrites its own cache slots with the same values).
    slots = serve_mod.SlotCache(cfg, load["batch"], load["s_max"],
                                getattr(torch, cfg.compute_dtype), DEV)
    step = make_serve_step(cfg)
    tok = torch.as_tensor([[o[-1]] for o in outputs[-load["batch"]:]], dtype=torch.int32,
                          device=DEV)
    pos = torch.full((load["batch"],), load["prompt"] + load["max_new"] - 1,
                     dtype=torch.int32, device=DEV)
    def tick():
        return step(params, slots.caches, tok, pos)[0].cpu()

    dev, busy, ok = profile_calls(tick, 10)
    by_op = collections.Counter()
    for name, ms in dev:
        by_op[name[:70]] += ms / 10
    top = ", ".join(f"{name} {ms:.3f}" for name, ms in by_op.most_common(6))
    log(f"  profiler, 10 ticks: device {busy:.3f} ms per tick{'' if ok else ' (incomplete)'} in "
        f"{tick_ms:.3f} ms of tick: busy {100 * busy / tick_ms:.1f}%; {len(dev) / 10:.0f} device "
        f"ops per tick; top kernels (ms per tick): {top}")
    if breakdown:
        log(f"  device ms per tick by aten op (self): {device_by_op(tick, 10)}")
        # What the float32 attention costs in reads alone: every layer's cached
        # k and v (or c_kv and k_rope) cast to float32 once; _gqa_scores and
        # _gqa_out cast k and v each tick, MLA's decode c_kv.
        cast_ms = cuda_ms(lambda: [t.float() for c in slots.caches for n, t in c.items()
                                   if n != "pos_k"])
        log(f"  casting the cache's float tensors to float32 once: {cast_ms:.3f} ms per tick "
            f"({100 * cast_ms / busy:.1f}% of the tick's device time)")
    if cfg.n_experts:
        moe_serve_drops(label, cfg, model, queue, kw, outputs)
    return model


def assert_close(label, got, want, rtol=LLM_RTOL, atol=LLM_ATOL):
    """``got`` within atol + rtol·|want| of ``want``; logs the largest
    error beside the tolerance."""
    got, want = got.float(), want.float().to(got.device)
    err = (got - want).abs()
    excess = float((err - (atol + rtol * want.abs())).max())
    log(f"    {label}: max |err| {float(err.max()):.3e}, tolerance {atol:g} + {rtol:g}·|ref| "
        f"(worst excess {excess:.3e})")
    check(excess <= 0, f"phase {label}: beyond its tolerance")


def teacher_forced(label, model, tokens, pre, s_max, **enc):
    """Prefill ``tokens[:, :pre]``, then decode the rest one at a time
    (teacher-forced): each decode step's logits against train mode's.
    ``enc`` is an encoder-decoder's ``enc_frames``."""
    from repro_torch.launch.serve import enc_len
    from repro_torch.models import model as M
    cfg = model.cfg
    full = model(tokens, **enc)
    caches = M.init_cache(cfg, 1, s_max, dtype=torch.float32, device=DEV, enc_len=enc_len(cfg))
    logits, caches = model(tokens[:, :pre], caches=caches, mode="prefill", **enc)
    assert_close(f"{label} prefill logits (positions 0-{pre - 1}) vs train", logits,
                 full[:, :pre])
    steps = []
    for i in range(pre, tokens.shape[1]):
        out, caches = model(tokens[:, i:i + 1], caches=caches, mode="decode",
                            positions=torch.full((1, 1), i, dtype=torch.int32, device=DEV))
        steps.append(out[:, 0])
    assert_close(f"{label} decode logits (positions {pre}-{tokens.shape[1] - 1}) vs train",
                 torch.stack(steps, 1), full[:, pre:])


def near_tie_ok(model, prompt, got, want):
    """Two greedy token lists of a request agree, or part at a step where
    the model's train-mode logits put both tokens within the tolerance of
    each other."""
    if got == want:
        return True
    i = next(j for j in range(len(got)) if got[j] != want[j])
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(want[:i], np.int32)]),
                          device=DEV)[None]
    logits = model(seq)[0, -1]
    a, b = float(logits[got[i]]), float(logits[want[i]])
    log(f"    tokens part at step {i}: {got[i]} vs {want[i]}, logits {a:.6f} vs {b:.6f}")
    return abs(a - b) <= 2 * (LLM_ATOL + LLM_RTOL * max(abs(a), abs(b)))


def phase16_llm(smi):
    """The dense LLM scaffold at full width and depth on the card: (a)
    stablelm-1.6b served in bf16; (b) float32 checks at its width; (c)
    gemma3-4b's sliding-window path served in bf16, with a float32
    teacher-forced check over the window's roll.  Returns B1's, B2's and
    B3's launches in the phase (it checks they are none)."""
    from repro_torch.configs.common import dense_blocks
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    # float32 products are the reference's float32 products only with TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    try:
        log(f"phase 16a: LLM serving at full width, bf16, TF32 off; {smi}")
        serve_load(smi, "16a", llm_cfg(LLM_SERVE["arch"], "bfloat16"), LLM_SERVE)

        log("phase 16b: float32 checks at full width (stablelm-1.6b), TF32 off")
        cfg32 = llm_cfg(LLM_SERVE["arch"], "float32")
        model = M.Model(cfg32, device=DEV, seed=1)
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (1, LLM_TF["prompt"] +
                                                                  LLM_TF["decode"])), device=DEV)
        teacher_forced("16b.1", model, toks, LLM_TF["prompt"], LLM_TF["s_max"])
        queue = [rng.integers(1, cfg32.vocab_size, size=LLM_BATCH["prompt"]).astype(np.int32)
                 for _ in range(LLM_BATCH["requests"])]
        kw = dict(max_new=LLM_BATCH["max_new"], s_max=LLM_BATCH["s_max"], device=DEV)
        wide, _ = serve_mod.serve(cfg32, model, queue, batch=LLM_BATCH["requests"], **kw)
        one, _ = serve_mod.serve(cfg32, model, queue, batch=1, **kw)
        same = sum(w == o for w, o in zip(wide, one))
        check(all(near_tie_ok(model, q, w, o) for q, w, o in zip(queue, wide, one)),
              "phase 16b.3: batch 8 and batch 1 part beyond a near-tie")
        log(f"    16b.3: {len(queue)} requests at batch {len(queue)} and batch 1: {same} of "
            f"{len(queue)} token lists equal, every other parts at a near-tie")
        del model
        cfg2 = dataclasses.replace(cfg32, blocks=dense_blocks(LLM_CPU["layers"]))
        model = M.Model(cfg2, device=DEV, seed=2)
        host = tree_map(lambda t: t.detach().cpu(), model.params())
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg2.vocab_size, (1, LLM_CPU["prompt"])), device=DEV)
        assert_close(f"16b.2 card vs CPU forward ({LLM_CPU['layers']} layers)", model(toks),
                     M.forward(host, cfg2, toks.cpu()))
        del model, host
        torch.cuda.empty_cache()

        log(f"phase 16c: the sliding-window path at full width, bf16; {smi}")
        serve_load(smi, "16c", llm_cfg(LLM_WINDOW["arch"], "bfloat16"), LLM_WINDOW)
        torch.cuda.empty_cache()
        cfg32 = llm_cfg(LLM_WINDOW["arch"], "float32")
        model = M.Model(cfg32, device=DEV, seed=3)
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg32.vocab_size, (1, LLM_WINDOW["prompt"] + LLM_WINDOW["max_new"])), device=DEV)
        teacher_forced("16c float32", model, toks, LLM_WINDOW["prompt"], LLM_WINDOW["s_max"])
        del model
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 16: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 16: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


# ------------------------------------------------------------- slice 10
@contextlib.contextmanager
def counted_drops(keep=False):
    """Every ``forward`` call (``models.model.forward``, ``launch.serve``'s
    import of it and ``Model``'s) with the MoE dispatch of each of its MoE
    layers.  Yields a list, filled as the calls run, of (mode, [one
    record per MoE layer]): {"dropped": (T, k) bool on the device} and,
    with ``keep``, the dispatch ("picks", "dest") and the router's
    probabilities ("probs")."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    real_fwd, real_dispatch = M.forward, L.moe_dispatch
    calls = []

    def fwd(params, cfg, tokens=None, **kw):
        calls.append((kw.get("mode", "train"), []))
        return real_fwd(params, cfg, tokens, **kw)

    def dispatch(router, xt, top_k, capacity_factor):
        gate, picks, dest, C = real_dispatch(router, xt, top_k, capacity_factor)
        rec = {"dropped": (dest == router.shape[-1] * C).view(-1, top_k)}
        if keep:
            rec.update(picks=picks, dest=dest, probs=(xt.float() @ router).softmax(-1))
        calls[-1][1].append(rec)
        return gate, picks, dest, C

    M.forward = serve_mod.forward = fwd
    L.moe_dispatch = dispatch
    try:
        yield calls
    finally:
        M.forward = serve_mod.forward = real_fwd
        L.moe_dispatch = real_dispatch


def moe_serve_drops(label, cfg, model, queue, kw, outputs):
    """The served load again, untimed (counting syncs the host), with
    every MoE dispatch's dropped picks counted: the same tokens as the
    timed run, and the drops per prefill and per decode tick logged."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import layers as L
    from repro_torch.models.model import layer_specs
    with counted_drops() as calls:
        again, _ = serve_mod.serve(cfg, model, queue, **kw)
    check(again == outputs, f"phase {label}: the untimed run gave other tokens")
    per = {"prefill": [], "decode": []}
    for mode, recs in calls:
        per[mode].append(sum(int(r["dropped"].sum()) for r in recs))
    moe_layers = sum(spec.mlp == "moe" for spec in layer_specs(cfg))
    for mode, T in (("prefill", len(queue[0])), ("decode", kw["batch"])):
        C = L.moe_capacity(T, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        n = per[mode]
        log(f"  dropped picks per {mode} (T = {T}, C = {C} rows per expert, {T * cfg.top_k} "
            f"picks in each of {moe_layers} MoE layers): sum {sum(n)} over {len(n)}, max "
            f"{max(n)}, {sum(x > 0 for x in n)} of {len(n)} with a drop (untimed rerun, the same "
            f"tokens)")


def cut_depth(cfg, layers):
    """``cfg`` with its first (dense) pattern once and its second (MoE)
    pattern repeated to ``layers`` layers in all."""
    (first, _), (moe, _) = cfg.blocks
    return dataclasses.replace(cfg, blocks=((first, 1), (moe, layers - 1)))


def same_dispatch(label, card, host, top_k):
    """The card's MoE dispatch against the CPU's, layer by layer: the same
    picks and dispatch rows, or else the first token whose picks differ
    is a router near-tie (logged with its margin) and the rows agree
    before it.  Returns that token over the layers, or None."""
    first = None
    for i, (a, b) in enumerate(zip(card, host)):
        pa, pb = a["picks"].cpu().sort(1).values, b["picks"].sort(1).values
        differ = (pa != pb).any(1).nonzero().flatten().tolist()
        n = differ[0] if differ else len(pa)
        if differ:
            s = b["probs"][n].sort(descending=True).values
            margin = float(s[top_k - 1] - s[top_k])
            log(f"    {label}, MoE layer {i}: token {n} picks {pa[n].tolist()} on the card and "
                f"{pb[n].tolist()} on the CPU; its k-th and (k+1)-th probabilities "
                f"{float(s[top_k - 1]):.8g} and {float(s[top_k]):.8g}, margin {margin:.3g}")
            check(margin <= ROUTER_NEAR_TIE, f"phase {label}: picks differ on a margin "
                  f"{margin:.3g} beyond {ROUTER_NEAR_TIE:g}")
            first = n if first is None else min(first, n)
        check(torch.equal(a["dest"].cpu()[:n * top_k], b["dest"][:n * top_k]),
              f"phase {label}: the dispatch rows differ before any near-tie")
    return first


def phase17_moe(smi):
    """MLA and the local MoE on the card: (a) deepseek-v2-lite-16b served
    in bf16 at full width and depth; (b) float32 checks at its width,
    depth cut; (c) kimi-k2-1t-a32b's 384-expert layer served in bf16 at
    full width, depth cut to 2.  Returns B1's, B2's and B3's launches in
    the phase (it checks they are none)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    try:
        log(f"phase 17a: MLA + MoE serving at full width and depth, bf16, TF32 off; {smi}")
        serve_load(smi, "17a", llm_cfg(LLM_MOE["arch"], "bfloat16"), LLM_MOE)
        torch.cuda.empty_cache()

        base = llm_cfg(LLM_MOE["arch"], "float32")
        E, k, cf = base.n_experts, base.top_k, base.capacity_factor
        log(f"phase 17b: float32 checks at full width ({base.name}), TF32 off")
        cfg4 = dataclasses.replace(cut_depth(base, LLM_MOE_TF["layers"]), capacity_factor=E / k)
        log(f"    17b.1 cut: depth {base.n_layers} -> {cfg4.n_layers} (1 dense + "
            f"{cfg4.n_layers - 1} MoE); capacity factor {cf} -> E/k = {E / k:.6g}, so C >= T "
            f"and no pick drops in any mode")
        model = M.Model(cfg4, device=DEV, seed=4)
        rng = np.random.default_rng(4)
        toks = torch.as_tensor(rng.integers(0, base.vocab_size, (1, LLM_MOE_TF["prompt"] +
                                                                 LLM_MOE_TF["decode"])), device=DEV)
        with counted_drops() as calls:
            teacher_forced("17b.1", model, toks, LLM_MOE_TF["prompt"], LLM_MOE_TF["s_max"])
        drops = sum(int(r["dropped"].sum()) for _, recs in calls for r in recs)
        check(drops == 0, f"phase 17b.1: {drops} picks dropped at capacity factor E/k")

        cfg125 = dataclasses.replace(cfg4, capacity_factor=cf)
        model = M.Model(cfg125, device=DEV, params=model.params())
        queue = [rng.integers(1, base.vocab_size, size=LLM_MOE_BATCH["prompt"]).astype(np.int32)
                 for _ in range(LLM_MOE_BATCH["requests"])]
        kw = dict(max_new=LLM_MOE_BATCH["max_new"], s_max=LLM_MOE_BATCH["s_max"], device=DEV)
        with counted_drops() as calls:
            wide, _ = serve_mod.serve(cfg125, model, queue, batch=len(queue), **kw)
        # Eight requests on eight slots: request i decodes in slot i.
        slot_drops = torch.zeros(len(queue), dtype=torch.bool, device=DEV)
        for mode, recs in calls:
            if mode == "decode":
                for r in recs:
                    slot_drops |= r["dropped"].any(1)
        exempt = slot_drops.tolist()
        one, _ = serve_mod.serve(cfg125, model, queue, batch=1, **kw)
        held = [(q, w, o) for q, w, o, x in zip(queue, wide, one, exempt) if not x]
        same = sum(w == o for _, w, o in held)
        check(all(near_tie_ok(model, q, w, o) for q, w, o in held),
              "phase 17b.3: batch 8 and batch 1 part beyond a near-tie")
        log(f"    17b.3 ({cfg125.n_layers} layers, capacity factor {cf}: C = "
            f"{L.moe_capacity(len(queue), k, E, cf)} at batch {len(queue)}, "
            f"{L.moe_capacity(1, k, E, cf)} at batch 1): {len(queue)} requests at batch "
            f"{len(queue)} and batch 1; {sum(exempt)} had a decode pick dropped at batch "
            f"{len(queue)}; of the other {len(held)}, {same} token lists equal, every other "
            f"parts at a near-tie")
        del model
        torch.cuda.empty_cache()

        cfg2 = cut_depth(base, LLM_MOE_CPU["layers"])
        model = M.Model(cfg2, device=DEV, seed=2)
        host = tree_map(lambda t: t.detach().cpu(), model.params())
        T = LLM_MOE_CPU["prompt"]
        toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg2.vocab_size, (1, T)),
                               device=DEV)
        with counted_drops(keep=True) as card:
            got = model(toks)
        with counted_drops(keep=True) as cpu:
            want = M.forward(host, cfg2, toks.cpu())
        dropped = sum(int(r["dropped"].sum()) for r in cpu[0][1])
        log(f"    17b.2 cut: depth {base.n_layers} -> {cfg2.n_layers} (1 dense + 1 MoE) for the "
            f"CPU's time; capacity factor {cf}: C = {L.moe_capacity(T, k, E, cf)} for T = {T}, "
            f"{dropped} of {T * k} picks dropped on the CPU")
        check(dropped > 0, "phase 17b.2: no pick dropped in the prefill")
        t = same_dispatch("17b.2", card[0][1], cpu[0][1], k)
        n = T if t is None else t
        assert_close(f"17b.2 card vs CPU forward ({cfg2.n_layers} layers, dispatch "
                     f"{'equal' if t is None else f'equal before token {t}'})",
                     got[:, :n], want[:, :n])
        del model, host, got, want, card, cpu
        torch.cuda.empty_cache()

        full = llm_cfg(LLM_KIMI["arch"], "bfloat16")
        kimi = cut_depth(full, LLM_KIMI["layers"])
        log(f"phase 17c: MoE behind GQA at full width, bf16; depth cut {full.n_layers} -> "
            f"{kimi.n_layers} (1 dense + 1 MoE of {kimi.n_experts} experts top-{kimi.top_k}): "
            f"the whole model does not fit one card; {smi}")
        serve_load(smi, "17c", kimi, LLM_KIMI)
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 17: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 17: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


# ------------------------------------------------------------- slice 11
def with_depth(cfg, pattern_reps):
    """``cfg`` with its one pattern repeated ``pattern_reps`` times."""
    ((pattern, _),) = cfg.blocks
    return dataclasses.replace(cfg, blocks=((pattern, pattern_reps),))


def phase18_mamba_encdec(smi):
    """Mamba and the encoder-decoder on the card: (a) falcon-mamba-7b
    served in bf16 at full width and depth, with a prefill through each
    scan path timed apart; (b) float32 checks at its width, depth cut;
    (c) jamba-v0.1-52b served in bf16, depth cut to two periods, and its
    attention + Mamba + MoE layers in float32 against the CPU; (d)
    whisper-base served in bf16 at full width and depth, with float32
    checks at full depth.  Returns B1's, B2's and B3's launches in the
    phase (it checks they are none)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    try:
        log(f"phase 18a: Mamba serving at full width and depth, bf16, TF32 off; {smi}")
        cfg = llm_cfg(LLM_MAMBA["arch"], "bfloat16")
        model = serve_load(smi, "18a", cfg, LLM_MAMBA)
        rng = np.random.default_rng(18)
        for S in (LLM_MAMBA["prompt"], LLM_STEP_PROMPT):
            prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, S)), device=DEV)

            def prefill():
                row = M.init_cache(cfg, 1, LLM_MAMBA["s_max"], dtype=torch.bfloat16, device=DEV)
                return model(prompt, caches=row, mode="prefill")[0]

            check(bool(torch.isfinite(prefill()).all()), f"phase 18a: prefill {S} not finite")
            path = "chunked scan" if S % 256 == 0 else "per-step scan"
            log(f"  prefill of {S} tokens ({path}): {cuda_ms(prefill, n=5, warmup=1):.3f} ms "
                f"(median of 5, CUDA events)")
        del model
        torch.cuda.empty_cache()

        base = llm_cfg(LLM_MAMBA["arch"], "float32")
        log(f"phase 18b: float32 checks at full width ({base.name}), TF32 off")
        cfg4 = with_depth(base, LLM_MAMBA_TF["layers"])
        log(f"    18b cut: depth {base.n_layers} -> {cfg4.n_layers} (teacher-forced, batch) "
            f"and {LLM_MAMBA_CPU['layers']} (card vs CPU), for memory and the CPU's time")
        model = M.Model(cfg4, device=DEV, seed=4)
        rng = np.random.default_rng(4)
        for pre in LLM_MAMBA_TF["prompts"]:
            total = pre + LLM_MAMBA_TF["decode"]
            toks = torch.as_tensor(rng.integers(0, base.vocab_size, (1, total)), device=DEV)
            teacher_forced(f"18b.1 prompt {pre} ({'chunked' if pre % 256 == 0 else 'per-step'} "
                           f"prefill, per-step train over {total})", model, toks, pre, total)
        B = LLM_MAMBA_BATCH
        queue = [rng.integers(1, base.vocab_size, size=B["prompt"]).astype(np.int32)
                 for _ in range(B["requests"])]
        kw = dict(max_new=B["max_new"], s_max=B["s_max"], device=DEV)
        wide, _ = serve_mod.serve(cfg4, model, queue, batch=len(queue), **kw)
        one, _ = serve_mod.serve(cfg4, model, queue, batch=1, **kw)
        same = sum(w == o for w, o in zip(wide, one))
        check(all(near_tie_ok(model, q, w, o) for q, w, o in zip(queue, wide, one)),
              "phase 18b.3: batch 8 and batch 1 part beyond a near-tie")
        log(f"    18b.3: {len(queue)} requests at batch {len(queue)} and batch 1: {same} of "
            f"{len(queue)} token lists equal, every other parts at a near-tie")
        del model
        cfg2 = with_depth(base, LLM_MAMBA_CPU["layers"])
        model = M.Model(cfg2, device=DEV, seed=2)
        host = tree_map(lambda t: t.detach().cpu(), model.params())
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg2.vocab_size, (1, LLM_MAMBA_CPU["prompt"])), device=DEV)
        assert_close(f"18b.2 card vs CPU forward ({cfg2.n_layers} layers)", model(toks),
                     M.forward(host, cfg2, toks.cpu()))
        del model, host
        torch.cuda.empty_cache()

        full = llm_cfg(LLM_JAMBA["arch"], "bfloat16")
        jamba = with_depth(full, LLM_JAMBA["periods"])
        kinds = collections.Counter(s.kind for s in M.layer_specs(jamba))
        moe = sum(s.mlp == "moe" for s in M.layer_specs(jamba))
        log(f"phase 18c: attention + Mamba + MoE at full width, bf16; depth cut {full.n_layers} "
            f"-> {jamba.n_layers} ({kinds['mamba']} Mamba + {kinds['attn']} attention layers, "
            f"{moe} with an MoE of {jamba.n_experts} experts top-{jamba.top_k}): the whole "
            f"model does not fit one card; {smi}")
        serve_load(smi, "18c", jamba, LLM_JAMBA)
        torch.cuda.empty_cache()
        base = llm_cfg(LLM_JAMBA["arch"], "float32")
        ((pattern, _),) = base.blocks
        lo, hi = LLM_JAMBA_CPU["layers"]
        cut = dataclasses.replace(base, blocks=((pattern[lo:hi], 1),),
                                  capacity_factor=base.n_experts / base.top_k)
        log(f"    18c.2 cut: float32, depth {base.n_layers} -> {cut.n_layers} (layers {lo}-"
            f"{hi - 1} of the period: {', '.join(f'{s.kind} + {s.mlp}' for s in pattern[lo:hi])})"
            f"; capacity factor {base.capacity_factor} -> E/k = {cut.capacity_factor:.6g}")
        model = M.Model(cut, device=DEV, seed=3)
        host = tree_map(lambda t: t.detach().cpu(), model.params())
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cut.vocab_size, (1, LLM_JAMBA_CPU["prompt"])), device=DEV)
        with counted_drops(keep=True) as card:
            got = model(toks)
        with counted_drops(keep=True) as cpu:
            want = M.forward(host, cut, toks.cpu())
        drops = sum(int(r["dropped"].sum()) for _, recs in card + cpu for r in recs)
        check(drops == 0, f"phase 18c.2: {drops} picks dropped at capacity factor E/k")
        t = same_dispatch("18c.2", card[0][1], cpu[0][1], cut.top_k)
        n = toks.shape[1] if t is None else t
        assert_close(f"18c.2 card vs CPU forward ({cut.n_layers} layers, dispatch "
                     f"{'equal' if t is None else f'equal before token {t}'})",
                     got[:, :n], want[:, :n])
        del model, host, got, want, card, cpu
        torch.cuda.empty_cache()

        log(f"phase 18d: the encoder-decoder at full width and depth, bf16; {smi}")
        serve_load(smi, "18d", llm_cfg(LLM_WHISPER["arch"], "bfloat16"), LLM_WHISPER)
        torch.cuda.empty_cache()
        cfg32 = llm_cfg(LLM_WHISPER["arch"], "float32")
        model = M.Model(cfg32, device=DEV, seed=5)
        rng = np.random.default_rng(5)
        W = LLM_WHISPER_TF
        toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (1, W["prompt"] + W["decode"])),
                               device=DEV)
        frames = torch.as_tensor(rng.standard_normal((1, cfg32.frontend_len, cfg32.d_model)),
                                 dtype=torch.float32, device=DEV)
        teacher_forced("18d float32 (full depth)", model, toks, W["prompt"], W["s_max"],
                       enc_frames=frames)
        host = tree_map(lambda t: t.detach().cpu(), model.params())
        assert_close(f"18d card vs CPU forward (full depth, {cfg32.frontend_len} frames)",
                     model(toks[:, :W["prompt"]], enc_frames=frames),
                     M.forward(host, cfg32, toks[:, :W["prompt"]].cpu(),
                               enc_frames=frames.cpu()))
        del model, host
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 18: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 18: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


# ------------------------------------------------------------- slice 12
def train_bound(cfg, n_params, batch, seq):
    """The least time of one float32 train step, in ms, and what bounds
    it: the operations, 6 per parameter and token (forward 2, backward
    4) plus the attention's two products of every query-key pair (4·H·hd
    each, the full S x S that the port computes before its mask) three
    times over, at the float32 rate; or the bytes, the parameters and
    AdamW's m and v each read once and written once, at the HBM rate."""
    from repro_torch.models.model import layer_specs
    tokens = batch * seq
    attn = sum(spec.kind == "attn" for spec in layer_specs(cfg))
    ops = 6 * n_params * tokens + 3 * attn * 4 * cfg.n_heads * cfg.head_dim * seq * tokens
    state_bytes = 3 * 4 * n_params
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, 2 * state_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations", ops) if ops_ms >= bytes_ms else (bytes_ms, "bytes", ops)


@contextlib.contextmanager
def timed_train_steps():
    """Every train step that ``launch.steps.make_train_step`` builds, and
    its optimizer update (``opt_step``), timed with CUDA events.  Yields
    {"step": [ms], "opt": [ms]}, filled on leaving."""
    from repro_torch.launch import steps as steps_mod
    real_make, real_opt = steps_mod.make_train_step, steps_mod.opt_step
    marks = {"step": [], "opt": []}
    out = {"step": [], "opt": []}

    def timed(kind, fn):
        def call(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            r = fn(*a, **kw)
            ev[1].record()
            marks[kind].append(ev)
            return r
        return call

    steps_mod.make_train_step = lambda *a, **kw: timed("step", real_make(*a, **kw))
    steps_mod.opt_step = timed("opt", real_opt)
    try:
        yield out
    finally:
        steps_mod.make_train_step, steps_mod.opt_step = real_make, real_opt
        torch.cuda.synchronize()
        for kind, pairs in marks.items():
            out[kind] = [a.elapsed_time(b) for a, b in pairs]


def train_main_run(T, batch, steps, label="phase 19a"):
    """``launch.train.main`` on the card at ``batch`` x ``T["seq"]`` for
    ``steps`` steps, every step and its ``opt_step`` timed.  Checks the
    losses are finite; returns (losses, step ms and optimizer ms of the
    steps after the warm-up, peak card memory, main's wall)."""
    from repro_torch.launch import train as train_mod
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", T["arch"], "--seq", str(T["seq"]), "--batch", str(batch),
            "--steps", str(steps), "--log-every", "1", "--device", DEV]
    with timed_train_steps() as times:
        t0 = time.perf_counter()
        losses = train_mod.main(argv)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{label}: losses {losses} at batch {batch}")
    return losses, times["step"][T["warmup"]:], times["opt"][T["warmup"]:], peak, wall


def train_step_line(cfg, n_params, T, batch, steps, opt, peak):
    """The step's median ms, tokens/s, optimizer share, bound and peak."""
    step_ms, opt_ms = statistics.median(steps), statistics.median(opt)
    bound_ms, bound_by, ops = train_bound(cfg, n_params, batch, T["seq"])
    log(f"  batch {batch}: step {step_ms:.3f} ms (median of {len(steps)} steps after "
        f"{T['warmup']} warm-up, CUDA events; min {min(steps):.3f}, max {max(steps):.3f}); "
        f"{batch * T['seq'] / step_ms * 1e3:.1f} tokens/s; optimizer (opt_step) {opt_ms:.3f} ms, "
        f"{100 * opt_ms / step_ms:.1f}% of the step")
    log(f"  batch {batch}: bound {bound_ms:.3f} ms by {bound_by} ({ops:.4g} operations at "
        f"67 TFLOP/s; the state read and written once, {fmt_mem(6 * 4 * n_params)} at "
        f"3.35 TB/s, {6 * 4 * n_params / HBM_BYTES_PER_S * 1e3:.3f} ms), the step at "
        f"{100 * bound_ms / step_ms:.1f}% of it; peak card memory {fmt_mem(peak)} of "
        f"{fmt_mem(torch.cuda.get_device_properties(0).total_memory)}")
    return step_ms, bound_ms


def phase19a_train(smi):
    """stablelm-1.6b trained at full width and depth through
    ``launch.train.main``: finite, falling losses; step ms, tokens/s,
    peak memory and the share of the step's bound; a profiler trace of
    one step of a fresh state (busy share, top aten ops); then the
    driver at the wider batch, its step, share and peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import OptConfig
    T = TRAIN_MAIN
    cfg = get_arch(T["arch"]).model
    log(f"phase 19a: training {cfg.name} at full width and depth, {cfg.param_dtype} parameters "
        f"and compute, AdamW, TF32 off; cut: {T['batch']} x {T['seq']} tokens per step, not the "
        f"--arch default of 256 x 4096 (the sequence: float32 S x S scores at 4096 without "
        f"remat do not fit; the batch: the phase's time); {smi}")
    losses, steps, opt, peak, wall = train_main_run(T, T["batch"], T["steps"])
    check(losses[-1] < losses[0], f"phase 19a: the loss did not fall ({losses[0]} -> {losses[-1]})")
    n_params = cfg.param_count()[0]
    log(f"  {n_params:,} parameters (param_count, embeddings tied); state (params, m, v) "
        f"{fmt_mem(3 * 4 * n_params)}; main's wall {wall:.1f} s for {T['steps']} steps, init "
        f"and the synthetic corpus included")
    log(f"  losses {', '.join(f'{x:.4f}' for x in losses)}: finite, falling")
    step_ms, bound_ms = train_step_line(cfg, n_params, T, T["batch"], steps, opt, peak)
    # A profiler trace of one step of a fresh state (its losses unchecked).
    ocfg = OptConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    state = train_mod.build_state(cfg, ocfg, seed=1, device=DEV)
    toks = torch.as_tensor(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (T["batch"], T["seq"] + 1)), device=DEV)
    step = steps_mod.make_train_step(cfg, ocfg)

    def one():
        return step(state, {"tokens": toks})[1]

    dev, busy, ok = profile_calls(one, 1)
    log(f"  profiler, one step: device {busy:.3f} ms{'' if ok else ' (incomplete)'} in the "
        f"{step_ms:.3f} ms step: busy {100 * busy / step_ms:.1f}%; {len(dev)} device ops")
    log(f"  device ms per step by aten op (self): {device_by_op(one, 1)}")
    del state, step
    losses, steps, opt, peak, wall = train_main_run(T, T["wide_batch"], T["wide_steps"])
    log(f"  the same driver at {T['wide_batch']} x {T['seq']} tokens per step, "
        f"{T['wide_steps']} steps in {wall:.1f} s: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (finite)")
    train_step_line(cfg, n_params, T, T["wide_batch"], steps, opt, peak)
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "bound_ms": bound_ms}


def phase19b_resume(smi):
    """The 100m preset trained with a checkpoint every 5 steps, then
    resumed from step 10: the same losses, bit for bit (deterministic
    algorithms: the embedding's backward accumulates without atomics);
    one save and one restore of its state timed."""
    import tempfile
    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import OptConfig
    from repro_torch._tree import flatten
    R = TRAIN_RESUME
    log(f"phase 19b: resume on the card, preset {R['preset']}, {R['steps']} steps, a checkpoint "
        f"every {R['every']}, deterministic algorithms; {smi}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--preset", R["preset"], "--steps", str(R["steps"]), "--ckpt-dir", tmp,
                    "--log-every", "100", "--device", DEV]
            first = train_mod.main(argv + ["--ckpt-every", str(R["every"])])
            again = train_mod.main(argv + ["--ckpt-every", "100", "--resume"])
    finally:
        torch.use_deterministic_algorithms(False)
    start = R["steps"] - len(again)
    check(start == R["every"] * (R["steps"] // R["every"]),
          f"phase 19b: resumed at step {start}")
    check(again == first[start:], f"phase 19b: resumed losses {again} != {first[start:]}")
    log(f"  losses {', '.join(f'{x:.6f}' for x in first)}; resumed at step {start}: "
        f"{', '.join(f'{x:.6f}' for x in again)}, equal bit for bit")
    cfg, _, _ = train_mod.preset_config(R["preset"])
    state = train_mod.build_state(cfg, OptConfig(), seed=0, device=DEV)
    nbytes = sum(t.numel() * t.element_size() for t in flatten(state).values())
    with tempfile.TemporaryDirectory() as tmp:
        sync()
        t0 = time.perf_counter()
        save_state(tmp, 1, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = restore_state(tmp, 1, state)
        sync()
        restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(flatten(back).values(), flatten(state).values()))
    check(same, "phase 19b: the restored state differs")
    log(f"  save_state of {fmt_mem(nbytes)} (params, m, v, step): {save_s:.3f} s "
        f"({nbytes / save_s / 1e9:.2f} GB/s); restore_state onto the card: {restore_s:.3f} s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s), equal bit for bit (host clocks)")
    del state, back
    torch.cuda.empty_cache()


def phase19c_gradients(smi):
    """Gradients of jamba's layers 4-5 (attention with a dense MLP, Mamba
    with the MoE) at full width in float32, card against CPU, through
    both scan paths: the loss and every parameter's gradient, with the
    MoE dispatch equal (or parting at a router near-tie, logged)."""
    from repro_torch._tree import flatten
    from repro_torch.models import model as M
    G = TRAIN_GRAD
    base = llm_cfg(G["arch"], "float32")
    ((pattern, _),) = base.blocks
    lo, hi = G["layers"]
    cut = dataclasses.replace(base, blocks=((pattern[lo:hi], 1),),
                              capacity_factor=base.n_experts / base.top_k)
    log(f"phase 19c: gradients, card against CPU, float32, {base.name} layers {lo}-{hi - 1} "
        f"({', '.join(f'{s.kind} + {s.mlp}' for s in pattern[lo:hi])}), capacity factor E/k = "
        f"{cut.capacity_factor:.6g}; cut: depth {base.n_layers} -> {cut.n_layers} (the CPU's "
        f"memory and time); {smi}")
    params = M.init_params(cut, torch.Generator(device=DEV).manual_seed(19))
    host = tree_map(lambda t: t.detach().cpu(), params)
    for t in list(flatten(params).values()) + list(flatten(host).values()):
        t.requires_grad_(True)
    for S in G["seqs"]:
        toks = torch.as_tensor(np.random.default_rng(S).integers(0, cut.vocab_size, (1, S + 1)))
        path = "chunked scan" if S % 256 == 0 else "per-step scan"
        res = {}
        for where, p, tk in (("card", params, toks.to(DEV)), ("cpu", host, toks)):
            if where == "card":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with counted_drops(keep=True) as calls:
                loss = M.lm_loss(p, cut, {"tokens": tk})
            flat = flatten(p)
            grads = torch.autograd.grad(loss, list(flat.values()))
            sync()
            res[where] = (float(loss.detach()), dict(zip(flat, grads)), calls[0][1],
                          time.perf_counter() - t0)
            if where == "card":
                peak = torch.cuda.max_memory_allocated()
        (lc, gc, dc, sc), (lh, gh, dh, sh) = res["card"], res["cpu"]
        drops = sum(int(r["dropped"].sum()) for r in dc + dh)
        check(drops == 0, f"phase 19c: {drops} picks dropped at capacity factor E/k")
        t = same_dispatch(f"19c {S} tokens", dc, dh, cut.top_k)
        check(t is None, f"phase 19c: the dispatch parts at token {t} (a router near-tie, "
              f"logged above): the gradients cannot be compared")
        lerr = abs(lc - lh) / abs(lh)
        worst, worst_name = 0.0, None
        for name, g in gc.items():
            want = gh[name]
            r = float((g.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if r > worst:
                worst, worst_name = r, name
        log(f"  {S} tokens ({path}): loss card {lc:.7f}, CPU {lh:.7f}, rel err {lerr:.3e} "
            f"(tolerance {TRAIN_LOSS_RTOL:g}); {len(gc)} gradients, worst max |dg| / max |g| "
            f"{worst:.3e} ({worst_name}; tolerance {TRAIN_GRAD_TOL:g}); dispatch equal, 0 drops; "
            f"card {sc:.2f} s, CPU {sh:.2f} s (host clocks, first call); peak card memory of the "
            f"card's pass {fmt_mem(peak)}")
        check(lerr <= TRAIN_LOSS_RTOL, f"phase 19c: loss beyond rtol at {S} tokens")
        check(worst <= TRAIN_GRAD_TOL, f"phase 19c: gradient {worst_name} beyond its tolerance")
        del res, gc, gh
    del params, host
    torch.cuda.empty_cache()


def phase19_train(smi):
    """Training on the card: 19a, 19b and 19c with TF32 off.  Returns B1's,
    B2's and B3's launches in the phase (it checks they are none)."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    try:
        p19a = phase19a_train(smi)
        phase19b_resume(smi)
        phase19c_gradients(smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 19: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 19: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {**n, "p19a": p19a}


# ------------------------------------------------------------- slice 13
def f32_cell(arch, seq, batch, remat, mesh, ocfg):
    """``launch.steps.build_cell`` of a float32 train step of ``arch``
    at ``batch`` x ``seq`` with ``remat``, over ``mesh``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell
    return build_cell(get_arch(arch), "train_4k", mesh, ocfg=ocfg, shape=(seq, batch, "train"),
                      overrides=dict(param_dtype="float32", compute_dtype="float32",
                                     remat=remat, moe_ep=False))


def census_of(cell):
    """The op census of one step of ``cell`` on its fake tensors."""
    from repro_torch.launch.opcensus import op_census
    with cell.mode:
        with op_census(*cell.args) as c:
            cell.fn(*cell.args)
    return c


def real_train(cell, ocfg, seed, steps, profile_flops=False):
    """``steps`` steps of ``cell``'s model and step on the card from a
    fresh state (``launch.train.build_state``) and random tokens: step
    ms (CUDA events), the peak card memory above what was allocated
    before the state, the losses, and with ``profile_flops`` the FLOPs a
    ``torch.profiler`` trace (``with_flops``) counts over one more step:
    (total, of ``mm``/``addmm``/``bmm``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_mod
    cfg, (_, bdata) = cell.model_cfg, cell.args
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = train_mod.build_state(cfg, ocfg, seed=seed, device=DEV)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, tuple(bdata["tokens"].shape), dtype=np.int32), device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        _, loss = cell.fn(state, {"tokens": toks})
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() - base
    flops = None
    if profile_flops:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            cell.fn(state, {"tokens": toks})
            torch.cuda.synchronize()
        ka = prof.key_averages()
        flops = (sum(e.flops for e in ka),
                 sum(e.flops for e in ka if e.key in ("aten::mm", "aten::addmm", "aten::bmm")))
    del state, toks
    torch.cuda.empty_cache()
    return ms, peak, losses, flops


def phase20a_census(smi, mesh, ocfg):
    C = DRYRUN_CELL
    cell = f32_cell(C["arch"], C["seq"], C["batch"], "none", mesh, ocfg)
    t0 = time.perf_counter()
    c = census_of(cell)
    t_census = time.perf_counter() - t0
    ms, peak, losses, (pflops, pmm) = real_train(cell, ocfg, seed=20, steps=1,
                                                 profile_flops=True)
    check(all(math.isfinite(x) for x in losses), f"phase 20a: losses {losses}")
    ferr, perr = abs(c.flops - pflops) / pflops, abs(c.peak - peak) / peak
    log(f"phase 20a: the dry run's census of phase 19a's cell ({cell.model_cfg.name}, float32, "
        f"AdamW, {C['batch']} x {C['seq']}, a world of one; fake tensors on "
        f"{cell.layout['device']}, census {t_census:.1f} s) against one step on the card; {smi}")
    log(f"  FLOPs: census {c.flops:.6e}, profiler (with_flops) {pflops:.6e} (of it mm/addmm/bmm "
        f"{pmm:.6e}): {100 * ferr:.3f}% apart (limit {100 * DRYRUN_FLOPS_RTOL:.0f}%)")
    log(f"  peak: census {fmt_mem(c.peak)}, max_memory_allocated {fmt_mem(peak)}: "
        f"{100 * perr:.2f}% apart (limit {100 * DRYRUN_PEAK_RTOL:.0f}%); the step {ms[0]:.3f} ms")
    check(ferr <= DRYRUN_FLOPS_RTOL, f"phase 20a: FLOPs {c.flops} vs profiler {pflops}")
    check(perr <= DRYRUN_PEAK_RTOL, f"phase 20a: peak {c.peak} vs measured {peak}")
    return {"flops": (c.flops, pflops), "peak": (c.peak, peak)}


def largest_batch(arch, seq, remat, mesh, ocfg, limit):
    """The largest batch whose census peak stays under ``limit``: the
    peak is linear in the batch, so two censuses place it and a third
    confirms it (one more per step down).  Returns (batch, its census)."""
    p1 = census_of(f32_cell(arch, seq, 1, remat, mesh, ocfg)).peak
    p2 = census_of(f32_cell(arch, seq, 2, remat, mesh, ocfg)).peak
    b = max(1, int((limit - p1) // (p2 - p1)) + 1)
    while True:
        c = census_of(f32_cell(arch, seq, b, remat, mesh, ocfg))
        if c.peak < limit or b == 1:
            return b, c, (p1, p2)
        b -= 1


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's expandable segments, on for the span: at
    4096 tokens each layer's float32 scores are blocks of gigabytes of
    varying sizes, and fixed segments leave many of them reserved but
    unusable."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def phase20b_remat(smi, mesh, ocfg):
    from repro_torch._tree import flatten
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as M
    R = DRYRUN_REMAT
    log(f"phase 20b: remat on the card, {R['arch']} float32 at {R['seq']} tokens, each mode at "
        f"the largest batch whose predicted peak is under {R['peak_limit'] / 1e9:.0f} GB; {smi}")
    out = {}
    for remat in ("full", "dots"):
        t0 = time.perf_counter()
        b, c, (p1, p2) = largest_batch(R["arch"], R["seq"], remat, mesh, ocfg, R["peak_limit"])
        t_fit = time.perf_counter() - t0
        cell = f32_cell(R["arch"], R["seq"], b, remat, mesh, ocfg)
        with expandable_segments():
            ms, peak, losses, _ = real_train(cell, ocfg, seed=21, steps=R["steps"])
        check(all(math.isfinite(x) for x in losses), f"phase 20b: {remat} losses {losses}")
        n_params = cell.model_cfg.param_count()[0]
        bound_ms, bound_by, _ = train_bound(cell.model_cfg, n_params, b, R["seq"])
        step = statistics.median(ms[1:])
        log(f"  remat {remat}: batch {b} (census peaks {fmt_mem(p1)} at 1, {fmt_mem(p2)} at 2; "
            f"fit in {t_fit:.1f} s); predicted peak {fmt_mem(c.peak)}, measured "
            f"{fmt_mem(peak)} ({100 * (c.peak - peak) / peak:+.2f}%)")
        log(f"  remat {remat}: step ms {', '.join(f'{x:.3f}' for x in ms)} (median of the last "
            f"{len(ms) - 1}: {step:.3f}); {b * R['seq'] / step * 1e3:.1f} tokens/s; bound "
            f"{bound_ms:.3f} ms by {bound_by}, the step at {100 * bound_ms / step:.1f}% of it; "
            f"losses {', '.join(f'{x:.4f}' for x in losses)}")
        out[remat] = {"batch": b, "pred_peak": c.peak, "peak": peak, "step_ms": step}
    # bit-equal gradients at 4 x 512 under deterministic algorithms
    C = DRYRUN_CELL
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = f32_cell(C["arch"], C["seq"], C["batch"], "none", mesh, ocfg).model_cfg
        state = train_mod.build_state(cfg, ocfg, seed=22, device=DEV)
        params = state.pop("params")
        del state
        toks = torch.as_tensor(np.random.default_rng(22).integers(
            0, cfg.vocab_size, (C["batch"], C["seq"] + 1), dtype=np.int32), device=DEV)
        flat = flatten(params)
        grads = {}
        for remat in ("none", "full", "dots"):
            loss = M.lm_loss(params, dataclasses.replace(cfg, remat=remat), {"tokens": toks})
            grads[remat] = [loss.detach(), *torch.autograd.grad(loss, list(flat.values()))]
        for remat in ("full", "dots"):
            same = all(torch.equal(a, b) for a, b in zip(grads[remat], grads["none"]))
            log(f"  {C['batch']} x {C['seq']}: loss and {len(flat)} gradients with remat {remat} "
                f"{'equal' if same else 'NOT equal'} to those without, bit for bit")
            check(same, f"phase 20b: remat {remat} changed the gradients")
        del params, flat, grads
    finally:
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
    return out


def phase20c_host(smi):
    """The dry run's records of one cell and the SA cell on the
    single-pod mesh, on this host (fake tensors, a fake world of 256)."""
    import tempfile
    from repro_torch.launch import dryrun
    H = DRYRUN_HOST
    log(f"phase 20c: the dry run on the card machine's host, {H['arch']} {H['shape']} and the SA "
        f"cell on the (16, 16) mesh (fake world of 256; nothing allocated); {smi}")
    allocated = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as out, dryrun.fake_world(False) as mesh:
        rec = dryrun.run_cell(H["arch"], H["shape"], multi_pod=False, out_dir=Path(out), mesh=mesh)
        sa = dryrun.run_sa_cell(multi_pod=False, out_dir=Path(out), mesh=mesh)
    check(torch.cuda.memory_allocated() == allocated, "phase 20c: the dry run allocated")
    bpd = rec["bytes_per_device"]
    log(f"  {H['arch']} {H['shape']}: state {fmt_mem(bpd['state'])} (under the reference's specs "
        f"{fmt_mem(bpd['state_under_specs'])}), batch {fmt_mem(bpd['batch'])}, activations' peak "
        f"{fmt_mem(bpd['activations_peak'])}, peak {fmt_mem(bpd['peak'])}; {rec['flops']:.4e} FLOPs, "
        f"{rec['bytes']:.4e} bytes, collectives {rec['collectives']}; bottleneck {rec['bottleneck']}; "
        f"fake tensors on {rec['layout']['device']}; build {rec['build_s']:.1f} s, measure "
        f"{rec['measure_s']:.1f} s")
    log(f"  SA: {sa['levels']} levels of {sa['chains_per_rank']} chains per rank, launches "
        f"{sa['launches']}, roofline {sa['roofline']}, bottleneck {sa['bottleneck']}")
    return rec, sa


def phase20_dryrun(smi):
    """The dry run held against the card: 20a, 20b and 20c, TF32 off.
    Returns B1's, B2's and B3's launches in the phase (none)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, start_fake_world
    from repro_torch.optim import OptConfig
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    ocfg = OptConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    try:
        start_fake_world(1)     # a world of one: its all-reduces are no-ops
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
            phase20a_census(smi, mesh, ocfg)
            phase20b_remat(smi, mesh, ocfg)
        finally:
            dist.destroy_process_group()
        phase20c_host(smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 20: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 20: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


def phase_b3_times(gen):
    """B3 at phase 8's group shape: 64 slots x 512 chains of grid12,
    N = 40, every block live."""
    from repro_torch.kernels import qap_sweep as qs
    n_slots = SERVE_CFG["n_slots"] // 2
    host, args, kw = qap_layout(12, n_slots=n_slots, seed=99, all_live=True)
    kw = {**kw, "n_steps": QAP_STEPS}
    k = kernel_ms(lambda: qs.qap_sweep_kernel(*args, **kw), "sa_qap_sweep")
    call = cuda_ms(lambda: qs.qap_sweep_kernel(*args, **kw))
    p = cuda_ms(lambda: qs.qap_sweep_plain(*args, **kw), n=10, warmup=1)
    chains, n = host["p"].shape
    proposals = chains * QAP_STEPS
    bound, by = b3_bound(chains, n, n_slots, QAP_STEPS)
    log(f"  B3 at phase 8's group shape ({chains} chains, n={n}, N={QAP_STEPS}): "
        f"kernel {k:.4f} ms (the call with its wrapper {call:.4f} ms), plain {p:.4f} ms, "
        f"bound {bound:.4f} ms ({by}), {proposals / (k * 1e-3):.4e} proposals/s")
    # Where the time goes: loads, tables and initial costs alone (N = 0),
    # then more moves.
    shown = []
    for steps in (0, 1, 16, QAP_STEPS):
        dev_ms, _, _ = device_ms(lambda: qs.qap_sweep_kernel(*args, **{**kw, "n_steps": steps}),
                                 n=20, bound_ms=b3_bound(chains, n, n_slots, steps)[0])
        shown.append(f"N={steps} {dev_ms:.4f} ms" if dev_ms is not None
                     else f"N={steps} not measured")
    log("  B3 device time by steps: " + ", ".join(shown))
    return k, call, p, bound, by


# ------------------------------------------------------ against a tree
@contextlib.contextmanager
def use_lib(lib):
    """Launch through ``lib`` (a loaded kernel library) while inside."""
    from repro_torch.kernels import _build
    real = _build.lib
    _build.lib = lambda: lib
    try:
        yield
    finally:
        _build.lib = real


def build_tree_lib(root):
    """The kernel library of the tree at ``root``, built with this tree's
    flags; its C entries must take the same arguments."""
    import ctypes
    from repro_torch.kernels import _build
    cus = sorted((root / "src/repro_torch/kernels/csrc").glob("*.cu"))
    check(bool(cus), f"no CUDA sources under {root}")
    out = _build.BUILD_DIR / "against.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           *map(str, cus)], capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc for {root} failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def against(root, gen):
    """B1 full and B3 of this tree against the kernels of the tree at
    ``root``: bit for bit on phase 1's full cases and phase 7's cases,
    then C entry and device times at the main paths' shapes and phase
    4's SA wall, the two trees in turns (that, this, this, that)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import qap_sweep as qs
    other, this = build_tree_lib(root), _build.lib()
    log(f"against {root}: this tree's B1 full and B3 vs that tree's kernels")
    for dim, with_t, n_steps, step0_base in ((SWEEP_DIMS[0], False, 16, 2**31 - 8),
                                             (MAIN_DIM, False, 16, 2**31 - 8),
                                             (3, False, 100, 2**32 - 60),
                                             (3, True, 100, 2**32 - 60)):
        lay = slot_layout(dim, gen, seed=dim + 4 + with_t, step0_base=step0_base)
        n = lay["x"].shape[0]
        t_chain = (10.0 ** (torch.rand(n, generator=gen, device=DEV) * 3 - 1)).contiguous() \
            if with_t else None
        args = (lay["x"], lay["T"], lay["seed"], lay["step0"])
        kw = dict(kid=lay["kid"], blk=lay["blk"], variant="full", n_steps=n_steps,
                  chain_base=lay["chain_base"], live=lay["live"], t_chain=t_chain)
        xa, fa = ms.metropolis_sweep_kernel(*args, **kw)
        with use_lib(other):
            xb, fb = ms.metropolis_sweep_kernel(*args, **kw)
        torch.cuda.synchronize()
        name = f"B1 full dim {dim} n_steps {n_steps}" + (" t_chain" if with_t else "")
        check(torch.equal(xa, xb) and torch.equal(fa, fb), f"{name}: trees differ")
        log(f"  {name}: x and f bit-equal to that tree's")
    for n, blk in [(n, QAP_BLK) for n in QAP_SIZES + (qs.MAX_N,)] + [(12, QAP_BLK_ODD),
                                                                     (31, QAP_BLK_ODD)]:
        _, args, kw = qap_layout(n, blk=blk, seed=n)
        pa, fa = qs.qap_sweep_kernel(*args, n_steps=QAP_STEPS, **kw)
        with use_lib(other):
            pb, fb = qs.qap_sweep_kernel(*args, n_steps=QAP_STEPS, **kw)
        torch.cuda.synchronize()
        check(torch.equal(pa, pb) and torch.equal(fa, fb), f"B3 n={n} blk {blk}: trees differ")
        log(f"  B3 n={n} blk {blk}: p and f bit-equal to that tree's")
    n, dim, N = MAIN_CFG["n_chains"], MAIN_DIM, MAIN_CFG["N"]
    x = ((torch.rand(n, dim, generator=gen, device=DEV) - 0.5) * 1024).contiguous()
    host, qargs, qkw = qap_layout(12, n_slots=SERVE_CFG["n_slots"] // 2, seed=99,
                                  all_live=True)
    calls = {
        "B1 full": (lambda: ms.metropolis_sweep_kernel(
            x, 5.0, 0, 0, kid=0, n_steps=N, blk=256, variant="full"), "sa_metropolis_sweep"),
        "B1 delta": (lambda: ms.metropolis_sweep_kernel(
            x, 5.0, 0, 0, kid=0, n_steps=N, blk=256, variant="delta"), "sa_metropolis_sweep"),
        "B3": (lambda: qs.qap_sweep_kernel(*qargs, n_steps=QAP_STEPS, **qkw), "sa_qap_sweep"),
    }
    b1 = b1_bounds(n, dim, N, TERM_INSTR)
    bounds = {"B1 full": b1["full"], "B1 delta": b1["delta"],
              "B3": b3_bound(*host["p"].shape, SERVE_CFG["n_slots"] // 2, QAP_STEPS)}
    log(f"  C entry (CUDA events) and device (profiler) ms at {n} x {dim}, N={N} (B1) "
        f"and {host['p'].shape[0]} chains of n=12, N={QAP_STEPS} (B3)")
    for label, lib in (("that", other), ("this", this), ("this", this), ("that", other)):
        with use_lib(lib):
            for name, (fn, entry) in calls.items():
                k = kernel_ms(fn, entry)
                dev_ms, _, _ = device_ms(fn, n=20, bound_ms=bounds[name][0])
                b, by = bounds[name]
                shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
                log(f"  {label} tree {name}: C entry {k:.4f} ms, device {shown}, "
                    f"bound {b:.4f} ms ({by}, {100 * b / k:.1f}% of it at the C entry)")
    # End to end: phase 4's main path through each tree's kernels.
    from repro_torch.core import SAConfig, sa_minimize
    from repro_torch.objectives import functions as F
    cfg, obj = SAConfig(**MAIN_CFG), F.schwefel(MAIN_DIM)
    sa_minimize(obj, SAConfig(**{**MAIN_CFG, "T_min": MAIN_CFG["T0"] * MAIN_CFG["rho"] ** 19.5}))
    found = {}
    for label, lib in (("that", other), ("this", this), ("this", this), ("that", other)):
        with use_lib(lib):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = sa_minimize(obj, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        found.setdefault(label, r.f_best)
        log(f"  {label} tree main path (phase 4, {cfg.n_levels} levels): SA wall {wall:.3f} s, "
            f"{cfg.n_evals / wall:.4e} proposals/s, f_best {r.f_best:.6f}")
    check(found["this"] == found["that"], f"main path f_best differs between trees: {found}")


# Boundary work the elastic engine does on every path, one shard too:
# scripted ops, truncation planning, and the migration and rebalance
# planners inside admission.
BOUNDARY_STEPS = (("engine", "_run_due_ops"), ("engine", "_plan_truncations"),
                  ("scheduler", "plan_migrations"), ("scheduler", "plan_rebalance"))
SERVE_WALL_REPS = 3


def serve_walls():
    """Phase 8's load, SERVE_WALL_REPS times at K = 4 and at K = 1, through
    whichever ``repro_torch`` comes first on ``sys.path``, without phase
    8's checks: prints one JSON line with the package's path, each run's
    wall, B3's launches and kernel seconds, host steps and the seconds in
    BOUNDARY_STEPS that the package has, and a digest of every champion."""
    import hashlib
    import repro_torch
    from repro_torch.service import EngineConfig, SAServeEngine
    from repro_torch.service import engine as engine_mod, scheduler as scheduler_mod
    boundary = {}
    owners = {"engine": engine_mod.SAServeEngine, "scheduler": scheduler_mod.AdmissionScheduler}
    for owner, name in BOUNDARY_STEPS:
        fn = getattr(owners[owner], name, None)
        if fn is None:
            continue

        def step(*a, _fn=fn, _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                boundary[_name] = boundary.get(_name, 0.0) + time.perf_counter() - t
        setattr(owners[owner], name, step)
    reqs = qap_requests()
    warm = SAServeEngine(EngineConfig(**SERVE_CFG))     # first calls of the torch ops
    warm.submit(reqs[0])
    warm.run()
    out, digest = {"package": str(Path(repro_torch.__file__).parent)}, hashlib.sha256()
    for k in (4, 1):
        out[k] = []
        for rep in range(SERVE_WALL_REPS):
            boundary.clear()
            got, wall, launches, kernel_s, engine, steps = serve_timed(
                EngineConfig(**{**SERVE_CFG, "macro_k": k}), reqs)
            if rep == 0:
                for rid in sorted(got):
                    digest.update(np.float64(got[rid].f_best).tobytes())
                    digest.update(np.asarray(got[rid].x_best).tobytes())
            out[k].append(dict(wall_s=wall, kernel_s=kernel_s, launches=launches,
                               ticks=engine.tick_count, steps=steps,
                               boundary=dict(boundary)))
    out["digest"] = digest.hexdigest()
    print(json.dumps(out))


def serve_against(root):
    """Phase 8's load through this tree's engine and the engine of the
    tree at ``root``, each run in a process of its own that imports only
    that tree's package, in turns (that, this, this, that, twice); the
    champions must be the same bits."""
    code = ("import sys; sys.path.insert(0, {here!r}); import chip_smoke as cs; "
            "sys.path.remove(str(cs.ROOT / 'src')); sys.path.insert(0, {src!r}); "
            "cs.serve_walls()")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log(f"phase 8's load ({len(qap_requests())} QAP requests, EngineConfig({SERVE_CFG}), "
        f"{SERVE_WALL_REPS} runs at K = 4 then at K = 1) through each tree's engine")
    digests, walls = set(), collections.defaultdict(list)
    for label, tree in (("that", root), ("this", ROOT), ("this", ROOT), ("that", root)) * 2:
        src = str(Path(tree).resolve() / "src")
        proc = subprocess.run([sys.executable, "-c", code.format(here=str(ROOT), src=src)],
                              capture_output=True, text=True, timeout=900, env=env)
        check(proc.returncode == 0, f"{label} tree's serving run failed:\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        check(got["package"] == str(Path(src) / "repro_torch"),
              f"{label} tree's run imported {got['package']}, not {src}")
        digests.add(got["digest"])
        for k in ("4", "1"):
            for r in got[k]:
                extra = ", ".join(f"{n.lstrip('_')} {v * 1e3:.2f} ms"
                                  for n, v in r["boundary"].items()) or "none"
                log(f"  {label} tree K={k}: wall {r['wall_s']:.3f} s, ticks {r['ticks']}, "
                    f"B3 launches {r['launches']}, B3 kernel {r['kernel_s']:.4f} s; host "
                    f"steps: {host_steps(r['steps'], r['wall_s'])}; boundary steps: {extra}")
            walls[label, k].extend(r["wall_s"] for r in got[k])
    check(len(digests) == 1, "phase 8's champions differ between the trees")
    for k in ("4", "1"):
        log(f"  K={k} least wall: that tree {min(walls['that', k]):.3f} s, "
            f"this tree {min(walls['this', k]):.3f} s "
            f"(median {statistics.median(walls['that', k]):.3f} s, "
            f"{statistics.median(walls['this', k]):.3f} s)")
    log("  champions bit-equal between the trees")


# ------------------------------------------------------------- slice 14
def phase21a_sharded_train(smi, p19a):
    """Phase 19a's cell by the sharded path (a world-of-one NCCL group, a
    (1, 1) mesh): its losses against the unsharded path's, bit for bit
    under deterministic algorithms; then 19a's timed steps beside 19a's."""
    T, det = TRAIN_MAIN, SHARDED["det_steps"]
    log(f"phase 21a: {T['arch']} float32, AdamW, {T['batch']} x {T['seq']} tokens, TF32 off, "
        f"through launch.train.main under a world-of-one NCCL group: the state as the rank's "
        f"blocks on a (1, 1) mesh (every block the whole leaf, every group of one a view); {smi}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        whole = train_main_run(T, T["batch"], det, "phase 21a")[0]
        with world_of_one():
            blocks = train_main_run(T, T["batch"], det, "phase 21a")[0]
    finally:
        torch.use_deterministic_algorithms(False)
    check(blocks == whole, f"phase 21a: sharded losses {blocks} != unsharded {whole}")
    log(f"  {det} steps under deterministic algorithms, unsharded and sharded: "
        f"{', '.join(f'{x:.6f}' for x in blocks)}, equal bit for bit")
    with world_of_one():
        losses, steps, opt, peak, wall = train_main_run(T, T["batch"], T["steps"], "phase 21a")
    check(losses[-1] < losses[0], f"phase 21a: the loss did not fall ({losses[0]} -> {losses[-1]})")
    step_ms = statistics.median(steps)
    log(f"  sharded, {T['steps']} steps in {wall:.1f} s (main's wall): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step {step_ms:.3f} ms (median of "
        f"{len(steps)} after {T['warmup']} warm-up, CUDA events; min {min(steps):.3f}, max "
        f"{max(steps):.3f}), optimizer {statistics.median(opt):.3f} ms; phase 19a's unsharded "
        f"step in this run {p19a['step_ms']:.3f} ms: {100 * (step_ms / p19a['step_ms'] - 1):+.2f}%; "
        f"peak card memory {fmt_mem(peak)}")
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "peak": peak}


def phase21b_checkpoints(smi):
    """A checkpoint saved by the sharded path restores into the unsharded
    one, and the other way round, bit for bit (the preset's state after
    one step); the sharded save and restore timed."""
    import tempfile
    from repro_torch._tree import flatten
    from repro_torch.checkpoint import CheckpointManager, restore_state, save_state
    from repro_torch.distributed import sharded
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    cfg, seq, batch = train_mod.preset_config(SHARDED["ckpt_preset"])
    ocfg = OptConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    log(f"phase 21b: checkpoints of the {SHARDED['ckpt_preset']} preset's state (AdamW, after one "
        f"step of {batch} x {seq}) between the sharded path ((1, 1) mesh, world of one) and the "
        f"unsharded one; {smi}")
    toks = torch.as_tensor(np.random.default_rng(21).integers(0, cfg.vocab_size, (batch, seq + 1)),
                           device=DEV)

    def same(a, b):
        fa, fb = flatten(a), flatten(b)
        return fa.keys() == fb.keys() and all(torch.equal(fa[k].detach(), fb[k].detach())
                                              for k in fa)

    with world_of_one(), tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
        specs = steps_mod.train_specs(cfg, ocfg, mesh)
        blocks = train_mod.build_state(cfg, ocfg, seed=0, device=DEV, mesh=mesh, specs=specs)
        steps_mod.make_train_step(cfg, ocfg, mesh, batch, specs=specs)(blocks, {"tokens": toks})
        sync()
        t0 = time.perf_counter()
        mgr = CheckpointManager(a, specs=specs, mesh=mesh)
        mgr.save_async(1, blocks, {"data_step": 1})
        mgr.wait()
        save_s = time.perf_counter() - t0
        whole, _ = restore_state(a, 1, train_mod.build_state(cfg, ocfg, seed=1, device=DEV))
        out = same(whole, sharded.gather_state(blocks, specs, mesh))
        save_state(b, 1, whole, {"data_step": 1})
        like = train_mod.build_state(cfg, ocfg, seed=1, device=DEV, mesh=mesh, specs=specs)
        t0 = time.perf_counter()
        back, extras = CheckpointManager(b, specs=specs, mesh=mesh).restore(like)
        sync()
        restore_s = time.perf_counter() - t0
        back_ok = same(back, blocks) and extras == {"data_step": 1}
        nbytes = sharded.block_bytes(blocks)
        del blocks, whole, like, back
    check(out, "phase 21b: the sharded save restored by the unsharded path differs")
    check(back_ok, "phase 21b: the unsharded save restored by the sharded path differs")
    log(f"  sharded save_async of {fmt_mem(nbytes)} (gathered leaf by leaf, one writer): "
        f"{save_s:.3f} s ({nbytes / save_s / 1e9:.2f} GB/s); restored by the unsharded path "
        f"equal bit for bit; the unsharded save restored as blocks: {restore_s:.3f} s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s), equal bit for bit (host clocks)")
    torch.cuda.empty_cache()


def phase21c_host(smi):
    """The dry run's train records on the single-pod mesh, on this host:
    each rank's state against the reference's specs, the peak, and
    whether it fits the card."""
    import tempfile
    from repro_torch._tree import flatten
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import OptConfig
    log(f"phase 21c: the dry run's {SHARDED['host_shape']} records of "
        f"{', '.join(SHARDED['host_archs'])} on the (16, 16) mesh (fake world of 256, fake tensors "
        f"on the host's fake device), the compute cut over 'model' (tensor parallelism); {smi}")
    card = torch.cuda.get_device_properties(0).total_memory
    recs = {}
    with tempfile.TemporaryDirectory() as out, dryrun.fake_world(False) as mesh:
        for arch in SHARDED["host_archs"]:
            spec, depth = get_arch(arch), SHARDED["host_depth"].get(arch)
            if depth:
                spec = dataclasses.replace(spec, model=cut_depth(spec.model, depth))
            rec = dryrun.run_cell(arch, SHARDED["host_shape"], multi_pod=False, out_dir=Path(out),
                                  mesh=mesh, spec=spec)
            cfg = steps_mod._dryrun_model_cfg(spec, SHARDED["host_shape"], mesh)
            leaves = len(flatten(steps_mod.state_shapes(cfg, OptConfig(**rec["optimizer"]))))
            bpd = rec["bytes_per_device"]
            # each storage is rounded up to the allocator's 512-byte blocks on a cuda fake device
            slack = 511 * leaves if rec["layout"]["device"] == "cuda" else 0
            check(bpd["state_under_specs"] <= bpd["state"] <= bpd["state_under_specs"] + slack,
                  f"phase 21c: {arch} state {bpd['state']} against {bpd['state_under_specs']}")
            beside = (f"depth cut to {depth} layers" if depth else
                      f"with the compute replicated over 'model': "
                      f"{SHARDED['replicated_peak_mib'][arch]:.1f} MiB")
            log(f"  {arch}: state {fmt_mem(bpd['state'])} per rank ({leaves} leaves), under the "
                f"reference's specs {fmt_mem(bpd['state_under_specs'])}; peak {fmt_mem(bpd['peak'])} "
                f"(activations {fmt_mem(bpd['activations_peak'])}; {beside}), "
                f"{'fits' if bpd['peak'] <= 80 * 2**30 else 'does not fit'} 80 GiB "
                f"({'fits' if bpd['peak'] <= card else 'does not fit'} this card's "
                f"{fmt_mem(card)}); collectives {rec['collectives']}; {rec['optimizer']['kind']}; "
                f"bottleneck {rec['bottleneck']}; build {rec['build_s']:.1f} s, measure "
                f"{rec['measure_s']:.1f} s")
            recs[arch] = bpd
            HOST_RECORDS[(arch, SHARDED["host_shape"])] = rec
    return recs


def phase21_sharded_state(smi, p19a):
    """The training state as each rank's blocks: 21a, 21b and 21c, TF32
    off.  Returns B1's, B2's and B3's launches in the phase (none)."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    try:
        phase21a_sharded_train(smi, p19a)
        phase21b_checkpoints(smi)
        phase21c_host(smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 21: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 21: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


# ------------------------------------------------------------- slice 15
def tp_serve_run(cfg, prefill, tick, params, caches, toks, max_new, dev=None):
    """A prefill of ``toks`` (B, prompt + 1, the training layout) and
    ``max_new - 1`` decode ticks through the given steps on ``dev``
    (default DEV).  Returns (the tokens (B, max_new) on the host, each
    tick's ms: CUDA events on the card, the host clock on the CPU)."""
    dev = torch.device(DEV if dev is None else dev)
    B, P = toks.shape[0], toks.shape[1] - 1
    nxt, caches = prefill(params, {"tokens": toks}, caches)
    out, times = [nxt], []
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    for _ in range(max_new - 1):
        (nxt, caches), ms = timed_ms(lambda: tick(params, caches, nxt, pos), dev)
        out.append(nxt)
        pos = pos + 1
        times.append(ms)
    return torch.cat(out, 1).cpu(), times


def phase22a_tp_serving(smi):
    """The sharded prefill and decode steps (a mesh and specs over a
    world-of-one NCCL group) against the unsharded steps: the same
    tokens, tick ms beside tick ms (TP_SERVE's pairs of runs, in turns)."""
    from repro_torch.distributed import sharded
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    T = TP_SERVE
    cfg = llm_cfg(T["arch"], "bfloat16")
    log(f"phase 22a: {T['arch']} bf16 at full width and depth through make_prefill_step and "
        f"make_serve_step with a mesh and specs (a (1, 1) mesh over a world-of-one NCCL group: "
        f"every 'model' group of one) against the unsharded steps; {T['requests']} prompts of "
        f"{T['prompt']} tokens, {T['max_new']} tokens each, s_max {T['s_max']}; {smi}")
    model = M.Model(cfg, device=DEV, seed=5)
    params = model.params()
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (T["requests"], T["prompt"] + 1)), device=DEV)
    dtype = torch.bfloat16
    whole_steps = (steps_mod.make_prefill_step(cfg), steps_mod.make_serve_step(cfg))
    t_whole, t_tp, got = [], [], []
    with world_of_one():
        mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
        pspecs = steps_mod.param_specs(params, cfg, mesh)
        blocks = sharded.shard_state(params, pspecs, mesh)
        kw = dict(batch=T["requests"], s_max=T["s_max"])
        tp_steps = (steps_mod.make_prefill_step(cfg, mesh, pspecs, **kw),
                    steps_mod.make_serve_step(cfg, mesh, pspecs, **kw))
        read = counted_launches()
        # three pairs in turns (unsharded first, then sharded first, ...):
        # the host's drift falls on both
        for pair in range(T["pairs"]):
            for sharded_run in (False, True) if pair % 2 == 0 else (True, False):
                if sharded_run:
                    toks_out, t = tp_serve_run(cfg, *tp_steps, blocks, steps_mod.cache_blocks(
                        cfg, mesh, T["requests"], T["s_max"], dtype, DEV), toks, T["max_new"])
                    got.append(toks_out)
                    t_tp.append(statistics.median(t))
                else:
                    want, t = tp_serve_run(cfg, *whole_steps, params, M.init_cache(
                        cfg, T["requests"], T["s_max"], dtype, DEV), toks, T["max_new"])
                    t_whole.append(statistics.median(t))
        n = read()
        nbytes = sharded.block_bytes(blocks)
        under = steps_mod.bytes_under_specs(params, pspecs, mesh)
    check(all(torch.equal(g, want) for g in got), f"phase 22a: sharded tokens "
          f"{[g.tolist() for g in got]} != unsharded {want.tolist()}")
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 22a: launched {n} of B1-B3")
    check(nbytes == under, f"phase 22a: the rank's parameters {nbytes} != {under} under the specs")
    ratios = [100 * (a / b - 1) for a, b in zip(t_tp, t_whole)]
    log(f"  tokens equal ({T['requests']} x {T['max_new']}, each run); decode tick (median of "
        f"{T['max_new'] - 1}, CUDA events) sharded {', '.join(f'{x:.3f}' for x in t_tp)} ms "
        f"against unsharded {', '.join(f'{x:.3f}' for x in t_whole)} ms in {T['pairs']} pairs "
        f"in turns: {', '.join(f'{x:+.2f}' for x in ratios)}% (median "
        f"{statistics.median(ratios):+.2f}%); the rank's parameters {fmt_mem(nbytes)} = "
        f"bytes_under_specs; B1-B3 launches {n}")
    del model, params, blocks
    torch.cuda.empty_cache()


def phase22b_host(smi):
    """The dry run's serving records on the single-pod mesh, on this
    host: each rank's parameters against bytes_under_specs, the peak, the
    tensor-parallel all-reduces."""
    import tempfile
    from repro_torch._tree import flatten
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    T = TP_SERVE
    log(f"phase 22b: the dry run's {', '.join(T['serve_shapes'])} records of "
        f"{', '.join(T['serve_archs'])} on the (16, 16) mesh (fake world of 256, fake tensors on "
        f"the host's fake device), the parameters as the rank's blocks; {smi}")
    with tempfile.TemporaryDirectory() as out, dryrun.fake_world(False) as mesh:
        for arch in T["serve_archs"]:
            cfg = steps_mod._dryrun_model_cfg(get_arch(arch), T["serve_shapes"][0], mesh)
            leaves = len(flatten(steps_mod.state_shapes(cfg)))
            for shape in T["serve_shapes"]:
                rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=Path(out), mesh=mesh)
                bpd = rec["bytes_per_device"]
                slack = 511 * leaves if rec["layout"]["device"] == "cuda" else 0
                check(bpd["state_under_specs"] <= bpd["params"] <= bpd["state_under_specs"] + slack,
                      f"phase 22b: {arch} {shape} parameters {bpd['params']} against "
                      f"{bpd['state_under_specs']}")
                check(rec["calls"].get("all-reduce", 0) > 0,
                      f"phase 22b: {arch} {shape} runs no tensor-parallel all-reduce")
                HOST_RECORDS[(arch, shape)] = rec
                log(f"  {arch} {shape}: parameters {fmt_mem(bpd['params'])} per rank, under the "
                    f"reference's specs {fmt_mem(bpd['state_under_specs'])}; cache "
                    f"{fmt_mem(bpd['cache'])}; peak {fmt_mem(bpd['peak'])}; all-reduces "
                    f"{rec['calls']['all-reduce']} ({rec['collectives']['all-reduce'] / 2**20:.1f} "
                    f"MiB on the wire); collectives {rec['collectives']}; bottleneck "
                    f"{rec['bottleneck']}; build {rec['build_s']:.1f} s, measure "
                    f"{rec['measure_s']:.1f} s")


def phase22c_dense_rest(smi):
    """granite-20b, internlm2-20b and internvl2-2b served at full width
    and depth in bf16 with 16a's metrics (not its by-op breakdown and
    cast, to keep the script's time): every request its tokens, all
    logits finite."""
    L = LLM_DENSE_REST
    for arch in L["archs"]:
        log(f"phase 22c: {arch} served at full width and depth, bf16, TF32 off (one request, "
            f"prompt {L['prompt']}, {L['max_new'] - 1} decode ticks); {smi}")
        model = serve_load(smi, f"22c {arch}", llm_cfg(arch, "bfloat16"), L, breakdown=False)
        del model
        torch.cuda.empty_cache()


def phase22_tensor_parallel(smi):
    """The compute cut over 'model': 22a, 22b and 22c, TF32 off.  Returns
    B1's, B2's and B3's launches in the phase (none)."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    try:
        for part in (phase22a_tp_serving, phase22b_host, phase22c_dense_rest):
            t0 = time.perf_counter()
            part(smi)
            log(f"  {part.__name__}: {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 22: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 22: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


# ------------------------------------------------------------- slice 16
def phase23a_long_decode(smi):
    """gemma3-4b batch 1 at 524288 positions: the sharded steps over a
    world-of-one NCCL group against the unsharded steps."""
    from repro_torch.distributed import sharded
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    T = SEQ_CUT
    cfg = llm_cfg(T["arch"], "bfloat16")
    S, dtype = T["s_max"], torch.bfloat16
    log(f"phase 23a: {T['arch']} bf16 at full width and depth, batch 1, a cache of {S} "
        f"positions (long_500k's), through make_prefill_step and make_serve_step with a mesh "
        f"and specs over a world-of-one NCCL group (every sequence group of one: no collective) "
        f"against the unsharded steps; prompt {T['prompt']}, {T['ticks']} ticks; {smi}")
    model = M.Model(cfg, device=DEV, seed=11)
    params = model.params()
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        1, cfg.vocab_size, (1, T["prompt"] + 1)), device=DEV)
    whole_steps = (steps_mod.make_prefill_step(cfg), steps_mod.make_serve_step(cfg))
    with world_of_one():
        mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
        pspecs = steps_mod.param_specs(params, cfg, mesh)
        blocks = sharded.shard_state(params, pspecs, mesh)
        kw = dict(batch=1, s_max=S)
        plan, _ = steps_mod._serving_plan(cfg, mesh, pspecs, **kw)
        check(len(plan.seq) == cfg.n_layers and not any(plan.seq),
              f"phase 23a: a sequence group of more than one rank over (1, 1): {plan.seq}")
        tp_steps = (steps_mod.make_prefill_step(cfg, mesh, pspecs, **kw),
                    steps_mod.make_serve_step(cfg, mesh, pspecs, **kw))
        read = counted_launches()
        caches = M.init_cache(cfg, 1, S, dtype, DEV)
        cache_bytes = tensor_bytes(caches)
        torch.cuda.reset_peak_memory_stats()
        want, t_whole = tp_serve_run(cfg, *whole_steps, params, caches, toks, T["ticks"] + 1)
        peak_whole = torch.cuda.max_memory_allocated()
        del caches
        torch.cuda.empty_cache()
        caches = steps_mod.cache_blocks(cfg, mesh, 1, S, dtype, DEV)
        check(tensor_bytes(caches) == cache_bytes, "phase 23a: the rank's cache is not whole")
        torch.cuda.reset_peak_memory_stats()
        got, t_cut = tp_serve_run(cfg, *tp_steps, blocks, caches, toks, T["ticks"] + 1)
        peak_cut = torch.cuda.max_memory_allocated()
        check(torch.equal(got, want), f"phase 23a: sharded tokens {got.tolist()} != unsharded "
              f"{want.tolist()}")
        # The prefill's caches were replaced: a profiler trace of 5 ticks
        # over fresh ones at the last position (each rewrites its slot).
        caches = steps_mod.cache_blocks(cfg, mesh, 1, S, dtype, DEV)
        _, caches = tp_steps[0](blocks, {"tokens": toks}, caches)
        tok = got[:, -1:].to(DEV)
        pos = torch.full((1,), T["prompt"] + T["ticks"] - 1, dtype=torch.int32, device=DEV)
        def tick():
            return tp_steps[1](blocks, caches, tok, pos)[0].cpu()
        dev, busy, ok = profile_calls(tick, 5)
        by_op = device_by_op(tick, 5)

        def casts():
            for c in caches:
                for name, t in c.items():
                    if name != "pos_k":
                        t.float()
        cast_ms = cuda_ms(casts, n=5, warmup=1)
        n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 23a: launched {n} of B1-B3")
    weights = weight_read_bytes(cfg, params, 1, True)
    bound = llm_bound(cfg, 1, S, weights + cache_bytes, decode=True)
    tick, tick_whole = statistics.median(t_cut), statistics.median(t_whole)
    log(f"  tokens equal bit for bit (1 x {T['ticks'] + 1}); decode tick {tick:.3f} ms sharded "
        f"(median of {len(t_cut)}, CUDA events; min {min(t_cut):.3f}, max {max(t_cut):.3f}) "
        f"against {tick_whole:.3f} ms unsharded; bound {bound[0]:.3f} ms by {bound[1]} ((weights "
        f"read {fmt_mem(weights)} + cache {fmt_mem(cache_bytes)}) / 3.35 TB/s for bytes), the "
        f"tick at {100 * bound[0] / tick:.1f}% of it")
    log(f"  profiler, 5 ticks: device {busy:.3f} ms per tick{'' if ok else ' (incomplete)'}, "
        f"busy {100 * busy / tick:.1f}%; {len(dev) / 5:.0f} device ops per tick; the cache's "
        f"float tensors cast to float32 once: {cast_ms:.3f} ms ({100 * cast_ms / busy:.1f}% of "
        f"the tick's device time)")
    log(f"  device ms per tick by aten op (self): {by_op}")
    log(f"  cache {fmt_mem(cache_bytes)}; peak card memory {fmt_mem(peak_cut)} sharded, "
        f"{fmt_mem(peak_whole)} unsharded; B1-B3 launches {n}")
    del model, params, blocks, caches
    torch.cuda.empty_cache()
    return {"tick_ms": tick, "bound_ms": bound[0]}


def phase23b_merge(smi):
    """The partials of 16 slot blocks merged with no collective against
    the whole softmax·v: one gemma3-4b global layer's decode and one
    deepseek-v2-lite-16b MLA layer's at 524288 slots.  Returns the worst
    error over MERGE_TOL's scale."""
    from repro_torch.distributed import sequence as SQ
    from repro_torch.models import layers as L
    T = SEQ_CUT
    S, n, gen = T["s_max"], T["blocks"], torch.Generator(device=DEV).manual_seed(23)
    b = SQ.block_len(S, n)
    valid = torch.ones((1, S), dtype=torch.bool, device=DEV)
    valid[:, S - T["masked"]:] = False

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(torch.bfloat16)

    def held(label, got, want, values):
        err = float((got - want).abs().max())
        scale = float(values.abs().max())
        log(f"    {label}: max |merged - whole| {err:.3e}, {err / scale:.3e} of max |value| "
            f"{scale:.3f}; largest |output| {float(want.abs().max()):.3e}; tolerance "
            f"{MERGE_TOL:g} of max |value|")
        check(err <= MERGE_TOL * scale, f"phase 23b: {label} beyond its tolerance")
        return err / scale

    log(f"phase 23b: the merge of {n} slot blocks of {b} (no collective) against the whole "
        f"softmax·v at {S} slots, the last {T['masked']} unwritten; {smi}")
    cfg = llm_cfg(T["arch"], "bfloat16")
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = randn(1, 1, H, hd, scale=T["score_std"])
    k, v = randn(1, S, G, hd), randn(1, S, G, hd)
    want = L._gqa_out(L._softmax(L._gqa_scores(q, k, H // G), valid[:, None, None, None, :]),
                      v, H // G)
    parts = [L.gqa_partial(q, k[:, i:i + b], v[:, i:i + b], H // G, valid[:, i:i + b])
             for i in range(0, S, b)]
    worst = held(f"{T['arch']} global layer (q {H} heads over {G} KV heads of {hd})",
                 L.gqa_heads(SQ.merge(parts)), want, v)
    del k, v, want, parts
    mcfg = llm_cfg(T["mla_arch"], "bfloat16")
    H, c, dr = mcfg.n_heads, mcfg.kv_lora, mcfg.d_rope
    scale = float(1.0 / np.sqrt(mcfg.d_nope + dr).astype(np.float32))
    std = T["score_std"] / math.sqrt((c + dr) * scale * scale)
    q_abs, q_r = randn(1, 1, H, c, scale=std), randn(1, 1, H, dr, scale=std)
    ckv, kr = randn(1, S, c), randn(1, S, dr)
    p = L._softmax(L._mla_scores("bshc,btc->bsht", q_abs, ckv, q_r, kr, scale),
                   valid[:, None, None, :])
    want = torch.einsum("bsht,btc->bshc", p, ckv.float())
    parts = [L.mla_partial(q_abs, q_r, ckv[:, i:i + b], kr[:, i:i + b], valid[:, i:i + b], scale)
             for i in range(0, S, b)]
    worst = max(worst, held(f"{T['mla_arch']} MLA layer (ctx over kv_lora {c}, {H} heads)",
                            SQ.merge(parts), want, ckv))
    del ckv, kr, want, parts, p
    torch.cuda.empty_cache()
    return worst


def cut_cache_bound(cfg, shape, n):
    """The bytes of a cell's whole cache cut n ways: a leaf that holds a
    sequence by whole slots of ceil(C / n) (the last block's padding), any
    other leaf by n."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import SHAPES
    from repro_torch.models import model as M
    seq, batch, _ = SHAPES[shape]
    with FakeTensorMode():
        whole = M.init_cache(cfg, batch, seq, dtype=M._dtype(cfg.compute_dtype), device="cpu")
    return sum(-(-t.shape[1] // n) * (t.numel() // t.shape[1]) * t.element_size()
               if k in ("k", "v", "pos_k", "c_kv", "k_rope") else t.numel() * t.element_size() / n
               for c in whole for k, t in c.items())


def phase23c_host(smi):
    """The dry run's long_500k records and seq_shard_kv's decode_32k
    records on the single-pod mesh, on this host."""
    import tempfile
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    T = SEQ_CUT
    log(f"phase 23c: the dry run's long_500k records of {', '.join(T['long'])} and decode_32k "
        f"records with seq_shard_kv of {', '.join(T['knob'])} on the (16, 16) mesh (fake world of "
        f"256, fake tensors on the host's fake device); {smi}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp, dryrun.fake_world(False) as mesh:
        jobs = [(a, "long_500k", None) for a in T["long"]] + \
               [(a, "decode_32k", {"seq_shard_kv": True}) for a in T["knob"]]
        for arch, shape, over in jobs:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=Path(tmp), mesh=mesh,
                                  overrides=over)
            bpd = rec["bytes_per_device"]
            cfg = steps_mod._dryrun_model_cfg(get_arch(arch), shape, mesh, over)
            leaves = sum(len(c) for c in steps_mod.cache_specs(cfg, mesh, SHAPES[shape][1]))
            # a fake CUDA storage is rounded up to the allocator's 512-byte blocks
            slack = 511 * leaves if rec["layout"]["device"] == "cuda" else 0
            check(bpd["cache_under_specs"] <= bpd["cache"] <= bpd["cache_under_specs"] + slack,
                  f"phase 23c: {arch} {shape} cache {bpd['cache']} against cache_under_specs "
                  f"{bpd['cache_under_specs']}")
            bound = cut_cache_bound(cfg, shape, T["blocks"]) if shape == "long_500k" else None
            check(bound is None or bpd["cache"] <= bound + slack, f"phase 23c: {arch} long_500k "
                  f"cache {bpd['cache']} above the whole cache / {T['blocks']}, {bound}")
            cut_line = "" if bound is None else f", whole cache / {T['blocks']} {fmt_mem(bound)}"
            was = T["pr25_peak_gib"][(arch, shape)]
            peak = bpd["peak"] / 2**30
            out[(arch, shape)] = peak
            log(f"  {arch} {shape}{' ' + rec['tag'] if rec['tag'] else ''}: peak {peak:.2f} GiB "
                f"({fmt_mem(bpd['peak'])}) per rank (PR 25: {was} GiB"
                f"{', default record' if over else ''}); cache "
                f"{fmt_mem(bpd['cache'])}, cache_under_specs {fmt_mem(bpd['cache_under_specs'])}"
                f"{cut_line}; "
                f"parameters {fmt_mem(bpd['params'])}; all-reduces "
                f"{rec['calls'].get('all-reduce', 0)}, all-gathers "
                f"{rec['calls'].get('all-gather', 0)}; collectives {rec['collectives']}; "
                f"bottleneck {rec['bottleneck']}; {time.perf_counter() - t0:.1f} s")
    check(out[("gemma3-4b", "long_500k")] < 2, "phase 23c: gemma3-4b long_500k at or above 2 GiB")
    check(all(peak < T["pr25_peak_gib"][k] for k, peak in out.items() if k[0] != "falcon-mamba-7b"),
          "phase 23c: a peak that holds a cut cache did not fall below PR 25's")
    check(out[("jamba-v0.1-52b", "long_500k")] < T["jamba_limit_gib"],
          f"phase 23c: jamba-v0.1-52b long_500k at or above {T['jamba_limit_gib']} GiB")
    return out


def phase23_sequence(smi):
    """The caches cut on their sequence: 23a, 23b and 23c, TF32 off.
    Returns B1's, B2's and B3's launches in the phase (none)."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    read = counted_launches()
    try:
        for part in (phase23a_long_decode, phase23b_merge, phase23c_host):
            t0 = time.perf_counter()
            part(smi)
            log(f"  {part.__name__}: {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 23: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 23: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


def phase24_seq_parallel(smi):
    """The dry run's seq_parallel knob records on the single-pod mesh,
    on this host, each against its default record.  Returns B1's, B2's
    and B3's launches in the phase (none)."""
    import tempfile
    from repro_torch._tree import flatten
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import OptConfig
    t_phase = time.perf_counter()
    read = counted_launches()
    S = SEQ_PAR
    jobs = [(a, "train_4k") for a in S["train"]] + [(a, "prefill_32k") for a in S["prefill"]]
    log(f"phase 24: the dry run's seq_parallel records of "
        f"{', '.join(f'{a} {sh}' for a, sh in jobs)} on the (16, 16) mesh (fake world of 256, "
        f"fake tensors on the host's fake device), each beside its default record; {smi}")
    with tempfile.TemporaryDirectory() as tmp, dryrun.fake_world(False) as mesh:
        for arch, shape in jobs:
            t0 = time.perf_counter()
            base = HOST_RECORDS.get((arch, shape))
            made = base is None
            if made:
                base = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=Path(tmp), mesh=mesh)
            over = {"seq_parallel": True}
            rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=Path(tmp), mesh=mesh,
                                  overrides=over)
            check("block of the sequence" in rec["layout"]["stream"] and
                  "block of the sequence" not in base["layout"]["stream"],
                  f"phase 24: {arch} {shape}: the records' layouts {rec['layout']['stream']!r}, "
                  f"{base['layout']['stream']!r}")
            cfg = steps_mod._dryrun_model_cfg(get_arch(arch), shape, mesh, over)
            train = SHAPES[shape][2] == "train"
            part = "state" if train else "params"
            leaves = len(flatten(steps_mod.state_shapes(
                cfg, OptConfig(**rec["optimizer"]) if train else None)))
            slack = 511 * leaves if rec["layout"]["device"] == "cuda" else 0
            bpd, was = rec["bytes_per_device"], base["bytes_per_device"]
            check(bpd["state_under_specs"] <= bpd[part] <= bpd["state_under_specs"] + slack,
                  f"phase 24: {arch} {shape} {part} {bpd[part]} against "
                  f"{bpd['state_under_specs']}")
            drop = (was["peak"] - bpd["peak"]) / 2**30

            def model_wire(r):
                by_kind = r["collectives_by_axis"].get("model", {})
                calls = r["collective_calls_by_axis"].get("model", {})
                return sum(by_kind.values()), ", ".join(
                    f"{k} {v / 2**30:.3f} GiB in {calls[k]} calls"
                    for k, v in sorted(by_kind.items()))

            (w_sp, by_sp), (w_base, by_base) = model_wire(rec), model_wire(base)
            log(f"  {arch} {shape} seq_parallel=True: peak {bpd['peak'] / 2**30:.2f} GiB "
                f"({fmt_mem(bpd['peak'])}) per rank against the default record's "
                f"{was['peak'] / 2**30:.2f} GiB ({fmt_mem(was['peak'])}"
                f"{', made here' if made else ''}), {drop:.2f} GiB lower; {part} "
                f"{fmt_mem(bpd[part])}, the specs' {fmt_mem(bpd['state_under_specs'])}; wire "
                f"bytes over 'model' {w_sp / 2**30:.3f} GiB ({by_sp}) against "
                f"{w_base / 2**30:.3f} GiB ({by_base}), {100 * (w_sp / w_base - 1):+.2f}%; "
                f"bottleneck {rec['bottleneck']}; build {rec['build_s']:.1f} s, measure "
                f"{rec['measure_s']:.1f} s; {time.perf_counter() - t0:.1f} s")
            if train:
                check(drop >= S["min_drop_gib"], f"phase 24: {arch} train_4k's peak fell by "
                      f"{drop:.2f} GiB, less than {S['min_drop_gib']}")
    n = read()
    check(n == {"b1": 0, "b2": 0, "b3": 0}, f"phase 24: launched {n} of B1-B3")
    log(f"  B1, B2 and B3 launches in phase 24: {n}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return n


def four_cards_sp_rank(argv):
    """One rank of the four-card seq_parallel training under
    ``torchrun``: launch/train.py's main with ``argv`` and the process's
    own arguments after them (``python -c CODE ARGS``: ``--preset smoke
    --device cpu`` rehearses it on the CPU), its model (an ``--arch``'s or
    a ``--preset``'s) with seq_parallel on."""
    from repro_torch import configs
    from repro_torch.launch import train
    arch, preset = configs.get_arch, train.preset_config

    def sp(cfg):
        return dataclasses.replace(cfg, seq_parallel=True)

    configs.get_arch = lambda a: dataclasses.replace(arch(a), model=sp(arch(a).model))
    train.preset_config = lambda name: (sp(preset(name)[0]), *preset(name)[1:])
    try:
        train.main(argv + sys.argv[1:])
    finally:
        configs.get_arch, train.preset_config = arch, preset


def four_cards_seq_rank(out_path):
    """One rank of the four-card sequence-cut decodes (FOUR_CARDS_SEQ),
    under ``torchrun`` (NCCL, one card per rank): for each run, the
    unsharded steps, then the sharded ones over the mesh with the rank's
    cache blocks; rank 0 writes {run: tokens of both, each layer's cut,
    the sharded tick ms} to ``out_path``."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, shrink
    from repro_torch.distributed import sharded
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    F = FOUR_CARDS_SEQ
    if DEV == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo")
    try:
        rec = {}
        for shape, knob in F["runs"]:
            over = dict(seq_shard_kv=True, n_kv_heads=F["kv_heads"]) if knob else {}
            cfg = shrink(get_arch(F["arch"]).model, **over)
            params = M.init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
            toks = torch.as_tensor(np.random.default_rng(0).integers(
                1, cfg.vocab_size, (1, F["prompt"] + 1)), device=DEV)
            want, _ = tp_serve_run(cfg, steps_mod.make_prefill_step(cfg),
                                   steps_mod.make_serve_step(cfg), params,
                                   M.init_cache(cfg, 1, F["s_max"], torch.float32, DEV), toks,
                                   F["ticks"] + 1)
            mesh = make_mesh(shape, ("data", "model"), device=DEV)
            pspecs = steps_mod.param_specs(params, cfg, mesh)
            kw = dict(batch=1, s_max=F["s_max"])
            got, times = tp_serve_run(
                cfg, steps_mod.make_prefill_step(cfg, mesh, pspecs, **kw),
                steps_mod.make_serve_step(cfg, mesh, pspecs, **kw),
                sharded.shard_state(params, pspecs, mesh),
                steps_mod.cache_blocks(cfg, mesh, 1, F["s_max"], torch.float32, DEV), toks,
                F["ticks"] + 1)
            plan, _ = steps_mod._serving_plan(cfg, mesh, pspecs, **kw)
            rec[f"{shape} seq_shard_kv={knob}"] = {
                "want": want.tolist(), "got": got.tolist(), "tick_ms": statistics.median(times),
                "cuts": [None if c is None else [list(c.axes), c.block] for c in plan.seq]}
        arch, shape = F["repair"]          # the MoE without expert parallelism, batch 1
        cfg = shrink(get_arch(arch).model)
        params = M.init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            1, cfg.vocab_size, (1, F["prompt"] + 1)), device=DEV)
        want, _ = tp_serve_run(cfg, steps_mod.make_prefill_step(cfg),
                               steps_mod.make_serve_step(cfg), params,
                               M.init_cache(cfg, 1, F["s_max"], torch.float32, DEV), toks,
                               F["ticks"] + 1)
        mesh = make_mesh(shape, ("data", "model"), device=DEV)
        pspecs = steps_mod.param_specs(params, cfg, mesh)
        kw = dict(batch=1, s_max=F["s_max"])
        got, times = tp_serve_run(
            cfg, steps_mod.make_prefill_step(cfg, mesh, pspecs, **kw),
            steps_mod.make_serve_step(cfg, mesh, pspecs, **kw),
            sharded.shard_state(params, pspecs, mesh),
            steps_mod.cache_blocks(cfg, mesh, 1, F["s_max"], torch.float32, DEV), toks,
            F["ticks"] + 1)
        plan, _ = steps_mod._serving_plan(cfg, mesh, pspecs, **kw)
        stacks = [p for p, spec in sharded.spec_paths(pspecs).items()
                  if p.rsplit("/", 1)[-1] in M.EXPERT_STACKS and "/shared/" not in p
                  and "model" in spec]
        repair = {"run": f"{shape} shrink({arch}) moe_ep={cfg.moe_ep}", "want": want.tolist(),
                  "got": got.tolist(), "tick_ms": statistics.median(times),
                  "stacks_kept_cut": bool(stacks) and all(
                      plan.gathers.get(p, (0, 0, ("model",)))[2] == ("model",) for p in stacks)}
        if dist.get_rank() == 0:
            Path(out_path).write_text(json.dumps({"runs": rec, "repair": repair}))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- slice 18
# The four-card paths (four_cards): one torchrun launch of
# four_cards_paths_rank (NCCL, one card per rank) runs the cases below in
# order, each held against the port's own unsharded path on one card in
# the same launch.  `sa`: the sharded ladder on phase 4's cell over each
# of `meshes` (shape, dim names, the dims the chains are cut along: None
# for all of them), f_best and x_best bit for bit, the history the
# reference defines for a sharded run (the first shard's best-so-far) and
# L + 2 all-gathers; V1 and SOS on schwefel(`v1_dim`) with `v1`, and the
# hybrid of `delta_cfg`, over the first mesh; the wall per level on one
# card and over the first mesh at n_chains and at `wide` times as many,
# each beside the device's busy share over its first `profile_levels`
# levels.  `ep`: `arch` float32 AdamW (train.main's OptConfig) cut to
# `layers` layers (the dense first one and MoE ones: the 27 layers' state
# does not fit one card), `steps` steps of `batch` x `seq` tokens, over
# (1, 4) with moe_ep against one card and against (1, 4) without it (every
# rank sees every token, so the dispatch is the same).  `tp`: `arch`
# float32 at full width and depth through the sharded prefill and decode
# steps over each of `meshes` against the unsharded steps on one card
# (TP_SERVE's requests and lengths).  `ckpt`: launch/train.py's main over
# (2, 2) for `steps` steps, and for `save_at` steps with a checkpoint,
# then resumed over (1, 4), and without a group on one card in
# four_cards' own process.  `pipe`: the GPipe pipeline of `layers` tanh
# layers over each of `meshes` (the stages on 'pod'), against the layers
# in order.  `compress`: compressed_psum and compress_grads_tree over each
# of `meshes` (shape, dim names, the dims summed), against the dense
# all_reduce.  tests/test_torch_four_cards.py runs the same function over
# gloo on the CPU at small sizes.
FOUR_CARDS_PATHS = dict(
    sa=dict(dim=MAIN_DIM, cfg=MAIN_CFG, delta_cfg=DELTA_CFG,
            meshes=(((4,), ("data",), None), ((2, 2), ("data", "model"), None),
                    ((2, 2), ("data", "model"), ("data",))),
            wide=4, profile_levels=100, v1_dim=32,
            v1=dict(T0=100.0, T_min=1.0, rho=0.9, N=100, use_delta_eval=True,
                    n_chains=V1_CHAINS)),
    ep=dict(arch="deepseek-v2-lite-16b", shrink=False, layers=4, seq=512, batch=8, steps=12,
            timed_from=2),
    tp=dict(arch="stablelm-1.6b", shrink=False, meshes=((1, 4), (2, 2)),
            **{k: TP_SERVE[k] for k in ("requests", "prompt", "max_new", "s_max")}),
    ckpt=dict(arch="stablelm-1.6b", shrink=False, seq=512, batch=8, steps=12, save_at=6),
    pipe=dict(layers=8, d=8, microbatches=4, mb=2,
              meshes=(((2, 2), ("pod", "data")), ((4,), ("pod",)))),
    compress=dict(n=32, meshes=(((4,), ("data",), ("data",)),
                                ((2, 2), ("data", "model"), ("data",)),
                                ((2, 2), ("data", "model"), ("data", "model")))),
)
# The gloo tests' tolerances (tests/test_torch_distributed.py): the
# pipeline within 1e-5 of the layers in order, a compressed sum within
# 5% of the dense sum and within 1e-6 of its group's dequantized shards.
PIPE_TOL, COMPRESS_REL, COMPRESS_ATOL = 1e-5, 0.05, 1e-6
# tests/test_moe_ep.py:62-63: the expert-parallel MoE's loss and gradients
# within 1e-5 (relative) of the local form's.
EP_REL = 1e-5
# The engine's shards on four cards (four_cards_engine, one process):
# phase 10's load on ELASTIC_CFG's shards but `n_devices` of them, shard
# `drain` drained at DRAIN_AT, in turns on the four cards and all on
# cuda:0; then `cli`, the reference's serve_sa commands (the verify
# skill's), each with --check.
ENGINE_FOUR = dict(n_devices=4, drain=3, cli=(
    ("--devices", "4", "--slots", "2", "--chains-per-slot", "16", "--arrivals", "poisson",
     "--rate", "1.0", "--requests", "8", "--max-ticks", "400", "--migration-budget", "2",
     "--drain-at", "6", "--check"),
    ("--autoscale", "--devices", "1", "--min-shards", "1", "--max-shards", "4", "--slots", "4",
     "--chains-per-slot", "8", "--requests", "24", "--arrivals", "diurnal", "--rate", "0.2",
     "--period", "120", "--amplitude", "0.9", "--finish-deadline-factor", "2.0",
     "--max-ticks", "1200", "--check")))


def gather_ranks(obj):
    """Every rank's ``obj`` (JSON-able), in rank order, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def timed_ms(fn, dev):
    """fn()'s result and its ms: CUDA events on the card, the host clock
    on the CPU."""
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = fn()
        b.record()
        b.synchronize()
        return r, a.elapsed_time(b)
    t0 = time.perf_counter()
    r = fn()
    return r, 1e3 * (time.perf_counter() - t0)


def device_busy(fn, dev):
    """fn() under a torch.profiler trace, after a call before the trace
    and one inside it before the span ``measured`` (a trace that starts
    cold can lose its first kernels): the union of the intervals of the
    device ops launched inside the span, NCCL's aside, over the span's
    length (the busy share: an NCCL kernel also spins while it waits for
    its peers), and device ms by kind (B1, B2, NCCL, other).  Every rank
    calls it alike, since fn may hold collectives.  (None, {}) on the
    CPU."""
    if dev.type != "cuda":
        return None, {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("measured"):
            fn()
            torch.cuda.synchronize()
    raw = list(prof.profiler.kineto_results.events())
    span = next(e for e in raw if e.name() == "measured")
    lo, hi = span.start_ns(), span.start_ns() + span.duration_ns()
    launched = {e.correlation_id() for e in raw if e.device_type() == DeviceType.CPU
                and e.name() in LAUNCH_CALLS and lo <= e.start_ns() <= hi}
    ops = sorted((e.start_ns(), min(e.start_ns() + e.duration_ns(), hi), e.name()) for e in raw
                 if e.device_type() == DeviceType.CUDA and lo <= e.start_ns() < hi
                 and (e.correlation_id() in launched or "nccl" in e.name().lower()))
    busy, end, by = 0, lo, collections.Counter()
    for s, t, name in ops:
        kind = ("B1" if "sweep" in name else "B2" if "argmin" in name else
                "NCCL" if "nccl" in name.lower() else "other")
        by[kind] += (t - s) / 1e6
        if kind != "NCCL":
            busy += max(0, t - max(s, end))
            end = max(end, t)
    return busy / (hi - lo), dict(by)


def first_shard_history(obj, cfg, n_shards, dev):
    """The history the reference defines for a ladder cut into
    ``n_shards`` shards, the first shard's best-so-far, from the unsharded
    ladder level by level: the running min of chains [0, n/R) after each
    level's exchange."""
    from repro_torch.core import annealing
    from repro_torch.core.metropolis import DTYPES
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    x0c = obj.sample_uniform(gen, (cfg.n_chains,), DTYPES[cfg.dtype])
    per = cfg.n_chains // n_shards
    state = annealing.init_state(x0c, objective=obj, cfg=cfg)
    best, out = state.fx[:per].min(), []
    for lvl, T in enumerate(cfg.ladder().tolist()):
        state = annealing.level_step(state, lvl, T, objective=obj, cfg=cfg)
        best = torch.minimum(best, state.fx[:per].min())
        out.append(best)
    return torch.stack(out).cpu().numpy()


def paths_sa(S, dev):
    """Case 1 on this rank: see FOUR_CARDS_PATHS."""
    from repro_torch.core import SAConfig, hybrid_minimize, sa_minimize
    from repro_torch.launch.mesh import make_mesh, shard_count
    from repro_torch.objectives import functions as F
    obj, cfg = F.schwefel(S["dim"]), SAConfig(**S["cfg"])
    meshes = []
    for shape, names, axes in S["meshes"]:
        m = make_mesh(shape, names, device=dev.type)
        meshes.append((m, axes, f"{shape} over {'/'.join(axes or names)}",
                       shard_count(m, axes or names)))
    mesh4, _, label4, n4 = meshes[0]
    # First calls: the kernels' first launches and NCCL's communicators.
    one = SAConfig(**{**S["cfg"], "T_min": S["cfg"]["T0"]})
    sa_minimize(obj, one, device=dev)
    for m, axes, _, _ in meshes:
        sa_minimize(obj, one, mesh=m, mesh_axes=axes)
    ref, _, ref_n, ref_g = run_counted(lambda: sa_minimize(obj, cfg, device=dev), dev)
    out = {"levels": cfg.n_levels, "f_best": ref.f_best, "unsharded_gathers": ref_g,
           "meshes": [], "variants": []}
    hist = {}
    for m, axes, label, n_sh in meshes:
        r, wall, n, g = run_counted(lambda: sa_minimize(obj, cfg, mesh=m, mesh_axes=axes), dev)
        if n_sh not in hist:
            hist[n_sh] = first_shard_history(obj, cfg, n_sh, dev)
        out["meshes"].append({
            "mesh": label, "shards": n_sh, "same": same_bits(r, ref, history=False),
            "history": r.history_f.tobytes() == hist[n_sh].tobytes(), "gathers": g,
            "want_gathers": cfg.n_levels + 2, "launches": n, "want_launches": ref_n,
            "wall_s": wall})
    P = S["profile_levels"]
    walls = {}
    for label, n_chains, kw in (
            ("one card", cfg.n_chains, dict(device=dev)),
            ("four cards", cfg.n_chains, dict(mesh=mesh4)),
            ("one card", S["wide"] * cfg.n_chains, dict(device=dev)),
            ("four cards", S["wide"] * cfg.n_chains, dict(mesh=mesh4))):
        c = SAConfig(**{**S["cfg"], "n_chains": n_chains})
        _, wall, n, _ = run_counted(lambda: sa_minimize(obj, c, **kw), dev)
        cut = SAConfig(**{**S["cfg"], "n_chains": n_chains,
                          "T_min": S["cfg"]["T0"] * S["cfg"]["rho"] ** (P - 0.5)})
        busy, by = device_busy(lambda: sa_minimize(obj, cut, **kw), dev)
        walls[f"{label}, {n_chains} chains"] = {
            "ms_per_level": 1e3 * wall / c.n_levels, "busy": busy, "launches": n,
            "device_ms_per_level": {k: v / cut.n_levels for k, v in by.items()}}
    out["walls"] = walls
    objv = F.schwefel(S["v1_dim"])
    for label, exchange in (("V1 async", "async"), ("SOS", "sos")):
        c = SAConfig(**S["v1"], exchange=exchange)
        u, _, un, _ = run_counted(lambda: sa_minimize(objv, c, device=dev), dev)
        r, wall, n, g = run_counted(lambda: sa_minimize(objv, c, mesh=mesh4), dev)
        want = None if exchange == "async" else first_shard_history(objv, c, n4, dev)
        out["variants"].append({
            "label": f"schwefel({S['v1_dim']}) {label} over {label4}",
            "same": same_bits(r, u, history=False),
            "history": (r.history_f is None if want is None else
                        r.history_f is not None and r.history_f.tobytes() == want.tobytes()),
            "gathers": g, "want_gathers": 1 if exchange == "async" else c.n_levels + 2,
            "launches": n, "want_launches": un, "wall_s": wall})
    c = SAConfig(**S["delta_cfg"])
    hu, _, hun, _ = run_counted(lambda: hybrid_minimize(obj, c, device=dev), dev)
    h, wall, n, g = run_counted(lambda: hybrid_minimize(obj, c, mesh=mesh4), dev)
    out["variants"].append({
        "label": f"hybrid over {label4}", "nm_f_best": h.nm.f_best,
        "same": (same_bits(h.sa, hu.sa, history=False) and h.nm.f_best == hu.nm.f_best
                 and h.x_best.tobytes() == hu.x_best.tobytes()),
        "history": h.sa.history_f.tobytes() == first_shard_history(obj, c, n4, dev).tobytes(),
        "gathers": g, "want_gathers": c.n_levels + 2, "launches": n, "want_launches": hun,
        "wall_s": wall})
    return out


def main_opt(steps):
    """launch/train.py main's optimizer for a run of ``steps`` steps."""
    from repro_torch.optim import OptConfig
    return OptConfig(lr=3e-4, total_steps=max(steps, 100),
                     warmup_steps=min(50, max(5, steps // 10)))


def arch_model(arch, shrunk):
    """``arch``'s model, shrink()'s form of it with ``shrunk``."""
    from repro_torch.configs import get_arch, shrink
    cfg = get_arch(arch).model
    return shrink(cfg) if shrunk else cfg


def train_run(cfg, ocfg, mesh, toks, dev, timed_from):
    """make_train_step's steps over ``toks`` (steps, batch, seq + 1), the
    whole batch on every rank (a mesh with one data rank), from
    build_state's seed 0.  Returns ({the losses, the median host ms of the
    steps from ``timed_from``, the peak card memory in MiB (None on the
    CPU), the all_to_all calls}, every MoE dispatch's picks with, per
    token, the smallest gap between neighbours among the router's k + 1
    largest probabilities: a near-tie there can route or order the picks
    otherwise)."""
    import torch.distributed as dist
    from repro_torch.launch import steps as TST
    from repro_torch.launch import train as TT
    from repro_torch.models import layers as L
    specs = TST.train_specs(cfg, ocfg, mesh) if mesh is not None else None
    state = TT.build_state(cfg, ocfg, seed=0, device=dev, mesh=mesh, specs=specs)
    step = TST.make_train_step(cfg, ocfg, mesh, toks.shape[1], specs=specs)
    real_a2a, real_dispatch = dist.all_to_all_single, L.moe_dispatch
    a2a, routes = [0], []

    def count_a2a(*a, **kw):
        a2a[0] += 1
        return real_a2a(*a, **kw)

    def dispatch(router, xt, top_k, capacity_factor):
        out = real_dispatch(router, xt, top_k, capacity_factor)
        with torch.no_grad():
            s = (xt.float() @ router).softmax(-1).topk(top_k + 1, -1).values
            routes.append((out[1].to(torch.int16), (s[:, :-1] - s[:, 1:]).min(-1).values))
        return out

    dist.all_to_all_single, L.moe_dispatch = count_a2a, dispatch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    try:
        for t in toks:
            t0 = time.perf_counter()
            state, loss = step(state, {"tokens": torch.as_tensor(t, device=dev)})
            losses.append(float(loss))
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        dist.all_to_all_single, L.moe_dispatch = real_a2a, real_dispatch
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": statistics.median(ms[timed_from:]), "peak_mib": peak,
            "all_to_all": a2a[0]}, routes


def first_parting(a, b, steps):
    """The first MoE dispatch at which two runs' picks (``train_run``'s
    routes) part: its step, its index, the tokens that part and the
    largest of their margins (each token's smaller one of the two runs);
    None when every dispatch agrees."""
    for i, ((pa, ma), (pb, mb)) in enumerate(zip(a, b)):
        if not torch.equal(pa, pb):
            t = (pa != pb).any(-1)
            return {"step": i // (len(a) // steps), "dispatch": i, "tokens": int(t.sum()),
                    "margin": float(torch.minimum(ma[t], mb[t]).max())}
    return None


def ep_layer(cfg, mesh, dev, tokens):
    """One routed MoE layer of ``cfg`` at full width on seeded (B, S, D)
    inputs (``tokens`` = (B, S)): ``_moe`` with moe_ep under ``mesh`` (the
    all_to_all forward and backward) against the local form on the same
    card and inputs, so the same dispatch: sum(y²) and the gradients of
    the inputs, the router and the three stacks, each as max |a - b| /
    max |b|."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev).manual_seed(1)
    init = L.init_moe(gen, cfg.d_model, cfg.d_ff_expert, cfg.n_experts, 0, cfg.d_ff_expert,
                      torch.float32)
    x = torch.randn((*tokens, cfg.d_model), generator=gen, device=dev)
    forms = {"local": lambda p, h: L.moe_apply(p, h, top_k=cfg.top_k,
                                               capacity_factor=cfg.capacity_factor),
             "ep": lambda p, h: M._moe(p, h, dataclasses.replace(cfg, moe_ep=True), mesh)}
    got = {}
    for name, fn in forms.items():
        p = {k: init[k].detach().clone().requires_grad_(True)
             for k in ("router", "w_gate", "w_up", "w_down")}
        h = x.clone().requires_grad_(True)
        loss = (fn(p, h) ** 2).sum()
        got[name] = [loss.detach(), *torch.autograd.grad(loss, [h, *p.values()])]
    return {k: float((a - b).abs().max() / b.abs().max())
            for k, a, b in zip(("loss", "x", "router", "w_gate", "w_up", "w_down"),
                               got["ep"], got["local"])}


def paths_ep(E, dev):
    """Case 3 on this rank: see FOUR_CARDS_PATHS.  Each pair of runs is
    held at ORDER_TOL on the steps before the first MoE dispatch at which
    their picks part (the cut compute's rounding can tip a router
    near-tie, and past it the capacity drops move), and that parting must
    be a near-tie (ROUTER_NEAR_TIE).  One MoE layer with moe_ep is held
    against the local form on the same inputs at EP_REL."""
    from repro_torch.launch.mesh import make_mesh
    cfg = cut_depth(arch_model(E["arch"], E["shrink"]), E["layers"])
    ocfg = main_opt(E["steps"])
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (E["steps"], E["batch"], E["seq"] + 1))
    mesh = make_mesh((1, 4), ("data", "model"), device=dev.type)
    out = {"layers": E["layers"], "experts": cfg.n_experts, "top_k": cfg.top_k,
           "capacity_factor": cfg.capacity_factor,
           "layer": ep_layer(cfg, mesh, dev, (E["batch"], E["seq"]))}
    runs = {}
    for label, c, m in (("one card", cfg, None),
                        ("(1, 4) moe_ep", dataclasses.replace(cfg, moe_ep=True), mesh),
                        ("(1, 4) without moe_ep", cfg, mesh)):
        out[label], runs[label] = train_run(c, ocfg, m, toks, dev, E["timed_from"])
    m = torch.stack([t.min() for _, t in runs["one card"]]).cpu()
    out["margin"] = {"min": float(m.min()), "dispatch": int(m.argmin()), "dispatches": len(m)}
    out["parting"] = {f"{a} | {b}": first_parting(runs[a], runs[b], E["steps"]) for a, b in (
        ("one card", "(1, 4) moe_ep"), ("(1, 4) without moe_ep", "(1, 4) moe_ep"),
        ("one card", "(1, 4) without moe_ep"))}
    return out


def paths_tp(T, dev):
    """Case 4 on this rank: see FOUR_CARDS_PATHS.  A row whose tokens part
    from the unsharded ones passes only where the unsharded step's logits
    put both tokens within near_tie_ok's tolerance of each other."""
    from repro_torch.distributed import sharded
    from repro_torch.launch import steps as TST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    cfg, R = arch_model(T["arch"], T["shrink"]), T["requests"]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(5))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (R, T["prompt"] + 1)), device=dev)
    seen, real = [], TST._next_token

    def spy(logits, plan):
        seen.append(logits.detach().float().reshape(logits.shape[0], -1).cpu())
        return real(logits, plan)

    TST._next_token = spy
    try:
        want, ticks = tp_serve_run(cfg, TST.make_prefill_step(cfg), TST.make_serve_step(cfg),
                                   params, M.init_cache(cfg, R, T["s_max"], torch.float32, dev),
                                   toks, T["max_new"], dev)
    finally:
        TST._next_token = real
    want = want.tolist()
    logits = torch.stack(seen)                                # (max_new, R, V)
    top2 = logits.topk(2, -1).values
    out = {"unsharded": {"tokens": want, "tick_ms": statistics.median(ticks),
                         "margin": float((top2[..., 0] - top2[..., 1]).min())}, "meshes": []}
    kw = dict(batch=R, s_max=T["s_max"])
    for shape in T["meshes"]:
        mesh = make_mesh(shape, ("data", "model"), device=dev.type)
        pspecs = TST.param_specs(params, cfg, mesh)
        rows = sharded.shard_leaf(torch.arange(R), TST.batch_specs(cfg, mesh, R)["tokens"][:1],
                                  mesh).tolist()
        got, ticks = tp_serve_run(cfg, TST.make_prefill_step(cfg, mesh, pspecs, **kw),
                                  TST.make_serve_step(cfg, mesh, pspecs, **kw),
                                  sharded.shard_state(params, pspecs, mesh),
                                  TST.cache_blocks(cfg, mesh, R, T["s_max"], torch.float32, dev),
                                  toks[rows], T["max_new"], dev)
        got = got.tolist()
        parts = []
        for g, r in zip(got, rows):
            if g != want[r]:   # the first step where they part, and both logits there
                i = next(j for j in range(len(g)) if g[j] != want[r][j])
                a, b = float(logits[i, r, g[i]]), float(logits[i, r, want[r][i]])
                parts.append({"row": r, "step": i, "got": g[i], "want": want[r][i],
                              "logits": [a, b], "near_tie": abs(a - b) <= 2 * (
                                  LLM_ATOL + LLM_RTOL * max(abs(a), abs(b)))})
        out["meshes"].append({"mesh": list(shape), "rows": rows, "tokens": got,
                              "tick_ms": statistics.median(ticks),
                              "parts": parts})
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def shrunk_archs(on):
    """With ``on``, ``configs.get_arch`` gives each architecture with its
    model shrink()'s (launch/train.py's ``--arch`` reads it)."""
    from repro_torch import configs
    real = configs.get_arch
    if on:
        configs.get_arch = lambda a: dataclasses.replace(
            real(a), model=configs.shrink(real(a).model))
    try:
        yield
    finally:
        configs.get_arch = real


def ckpt_argv(C, dev):
    return ["--arch", C["arch"], "--seq", str(C["seq"]), "--batch", str(C["batch"]),
            "--log-every", str(C["steps"]), "--device", dev.type]


def restored_blocks(C, dev, ckpt_dir):
    """The latest checkpoint of ``ckpt_dir`` restored as this rank's
    blocks over (1, 4) (``CheckpointManager(specs=, mesh=).restore``),
    each against the rank's block of the saved whole leaf
    (``sharded.shard_leaf`` of the file), bit for bit."""
    from repro_torch._tree import flatten
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharded
    from repro_torch.launch import steps as TST
    from repro_torch.launch import train as TT
    from repro_torch.launch.mesh import make_mesh
    cfg, ocfg = arch_model(C["arch"], C["shrink"]), main_opt(C["steps"])
    mesh = make_mesh((1, 4), ("data", "model"), device=dev.type)
    specs = TST.train_specs(cfg, ocfg, mesh)
    like = TT.build_state(cfg, ocfg, seed=1, device=dev, mesh=mesh, specs=specs)
    mgr = CheckpointManager(ckpt_dir, specs=specs, mesh=mesh)
    step = mgr.latest_step()
    got, extras = mgr.restore(like)
    got, fs = flatten(got), sharded.spec_paths(specs)
    d = Path(ckpt_dir) / f"step_{step:09d}"
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    equal = cut = 0
    for rec in leaves:
        whole = torch.from_numpy(np.load(d / f"arr_{rec['index']:06d}.npy"))
        if rec["dtype"] == "bfloat16":
            whole = whole.view(torch.bfloat16)
        want = sharded.shard_leaf(whole, fs[rec["path"]], mesh)
        equal += torch.equal(got[rec["path"]].detach().cpu(), want)
        cut += want.numel() < whole.numel()
    return {"step": step, "data_step": extras["data_step"], "leaves": len(leaves),
            "equal": equal, "cut": cut}


def paths_ckpt(C, dev, ckpt_dir):
    """Case 5 on this rank: see FOUR_CARDS_PATHS."""
    import torch.distributed as dist
    from repro_torch.launch import train as TT
    argv = ckpt_argv(C, dev)
    with shrunk_archs(C["shrink"]):
        whole = TT.main(argv + ["--steps", str(C["steps"]), "--model-parallel", "2"])
        first = TT.main(argv + ["--steps", str(C["save_at"]), "--model-parallel", "2",
                                "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(C["save_at"])])
        dist.barrier()   # rank 0 alone writes; the others read only once it has published
        blocks = restored_blocks(C, dev, ckpt_dir)
        resumed = TT.main(argv + ["--steps", str(C["steps"]), "--model-parallel", "4",
                                  "--ckpt-dir", str(ckpt_dir), "--resume"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"whole": whole, "first": first, "resumed": resumed, "blocks": blocks}


def four_cards_resume_one(C, ckpt_dir, device):
    """Case 5's resume without a process group on one card (or the CPU):
    launch/train.py's main from the checkpoint of ``ckpt_dir``.  Returns
    its losses."""
    import torch.distributed as dist
    from repro_torch.launch import train as TT
    check(not dist.is_initialized(), "four cards: the one-card resume needs no process group")
    with shrunk_archs(C["shrink"]):
        losses = TT.main(ckpt_argv(C, torch.device(device)) + [
            "--steps", str(C["steps"]), "--ckpt-dir", str(ckpt_dir), "--resume"])
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return losses


def paths_pipe(P, dev):
    """Case 6's pipeline on this rank: see FOUR_CARDS_PATHS."""
    from repro_torch.distributed.pipeline import bubble_fraction, make_pipelined_fn
    from repro_torch.launch.mesh import make_mesh
    rng = np.random.default_rng(0)
    ws = torch.as_tensor(rng.normal(size=(P["layers"], P["d"], P["d"])).astype(np.float32) * 0.3,
                         device=dev)
    x = torch.as_tensor(rng.normal(size=(P["microbatches"], P["mb"], P["d"])).astype(np.float32),
                        device=dev)

    def layer_fn(stage_ws, h):
        for i in range(stage_ws.shape[0]):
            h = torch.tanh(h @ stage_ws[i])
        return h

    seq = layer_fn(ws, x)
    out = []
    for shape, names in P["meshes"]:
        mesh = make_mesh(shape, names, device=dev.type)
        y = make_pipelined_fn(layer_fn, mesh, axis="pod")(ws, x)
        n = shape[names.index("pod")]
        out.append({"mesh": f"{shape} over {'/'.join(names)}", "stages": n,
                    "err": float((y - seq).abs().max()),
                    "bubble": bubble_fraction(n, P["microbatches"]),
                    "want_bubble": (n - 1) / (P["microbatches"] + n - 1)})
    return out


def paths_compress(C, dev):
    """Case 6's compressed sums on this rank: see FOUR_CARDS_PATHS.  Each
    sum against the dense all_reduce over the same group and against the
    group's dequantized shards (all-gathered here), each residual against
    the rank's own quantization error; compress_grads_tree over two calls
    of a float32 and a bfloat16 leaf, its residuals carried."""
    import torch.distributed as dist
    from repro_torch._tree import flatten
    from repro_torch.distributed.compression import (compress_grads_tree, compressed_psum,
                                                     init_residuals, quantize_int8)
    from repro_torch.launch.mesh import axis_group, make_mesh
    rank = dist.get_rank()

    def dense(t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    def against(approx, x, group, rows):
        """(|approx - deq| max, |approx - dense| max / |dense| max, the
        residual's error) of one compressed sum of x."""
        q, s = quantize_int8(x)
        qs = [torch.empty_like(q) for _ in range(dist.get_world_size(group))]
        ss = [torch.empty_like(s.reshape(1)) for _ in qs]
        dist.all_gather(qs, q, group=group)
        dist.all_gather(ss, s.reshape(1), group=group)
        deq = sum(ss[i].double() * qs[i].double() for i in rows)
        d = dense(x, group)
        return (float((approx.double() - deq).abs().max()),
                float((approx - d).abs().max() / d.abs().max()))

    out = []
    for shape, names, axes in C["meshes"]:
        mesh = make_mesh(shape, names, device=dev.type)
        group, rows = axis_group(mesh, axes)
        x = torch.as_tensor(np.random.default_rng(10 + rank).normal(size=(C["n"],)) * 3,
                            dtype=torch.float32, device=dev)
        approx, resid = compressed_psum(x, mesh, axes)
        q, s = quantize_int8(x)
        deq_err, rel = against(approx, x, group, rows)
        rec = {"mesh": f"{shape} over {'/'.join(axes)}", "deq_err": deq_err, "rel": rel,
               "resid_err": float((resid - (x - s * q.float())).abs().max()),
               "resid_nonzero": bool((resid != 0).any()), "tree": []}
        rng = np.random.default_rng(30 + rank)
        calls = [{"a": torch.as_tensor(rng.normal(size=(6,)) * 2, dtype=torch.float32, device=dev),
                  "b": {"c": torch.as_tensor(rng.normal(size=(2, 3)), dtype=torch.bfloat16,
                                             device=dev)}} for _ in range(2)]
        carried = init_residuals(calls[0])
        for g in calls:
            inputs = {p: t.float() + flatten(carried)[p] for p, t in flatten(g).items()}
            sums, carried = compress_grads_tree(g, carried, mesh, axes)
            for p, t in flatten(sums).items():
                deq_err, rel = against(t, inputs[p], group, rows)
                q, s = quantize_int8(inputs[p])
                rec["tree"].append({
                    "leaf": p, "deq_err": deq_err, "rel": rel,
                    "dtypes": [str(t.dtype), str(flatten(carried)[p].dtype)],
                    "resid_err": float((flatten(carried)[p] - (inputs[p] - s * q.float()))
                                       .abs().max())})
        out.append(rec)
    return out


def four_cards_paths_rank(out_path, device, sizes=None, init_method=None):
    """One rank of the four-card paths (FOUR_CARDS_PATHS, or ``sizes``)
    under ``torchrun``: ``device`` "cuda" binds the rank to its card
    (LOCAL_RANK) before the NCCL group and any mesh exist; "cpu" runs the
    same over gloo (tests/test_torch_four_cards.py, with ``init_method`` a
    ``file://`` rendezvous and RANK and WORLD_SIZE in the environment).
    The cases run in order; after each one rank 0 rewrites ``out_path``
    with {case: every rank's record}, so a failed launch keeps what ran.
    Case 5's checkpoint goes to ``ckpt`` beside ``out_path``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.kernels import _build
    P = FOUR_CARDS_PATHS if sizes is None else sizes
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=300))
    cases = (("sa", paths_sa), ("ep", paths_ep), ("tp", paths_tp),
             ("ckpt", lambda C, d: paths_ckpt(C, d, Path(out_path).with_name("ckpt"))),
             ("pipe", paths_pipe), ("compress", paths_compress))
    rec = {}
    try:
        for name, fn in cases:
            t0 = time.perf_counter()
            r = fn(P[name], dev)
            sync(dev)
            rec[name] = gather_ranks({"device": str(dev), "wall_s": time.perf_counter() - t0,
                                      "kernel_library_builds_and_loads": _build.builds_and_loads,
                                      **(r if isinstance(r, dict) else {"runs": r})})
            if dist.get_rank() == 0:
                Path(out_path).write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def check_paths_sa(recs, smi=""):
    """Case 1's checks on every rank's record (FOUR_CARDS_PATHS)."""
    for r, rec in enumerate(recs):
        for m in rec["meshes"] + rec["variants"]:
            what = m.get("mesh", m.get("label"))
            check(m["same"], f"four cards sa, rank {r}, {what}: f_best or x_best differ from the "
                  f"unsharded run on one card")
            check(m["history"], f"four cards sa, rank {r}, {what}: history_f is not the first "
                  f"shard's best-so-far")
            check(m["gathers"] == m["want_gathers"], f"four cards sa, rank {r}, {what}: "
                  f"{m['gathers']} all-gathers, expected {m['want_gathers']}")
            check(m["launches"] == m["want_launches"], f"four cards sa, rank {r}, {what}: "
                  f"launches {m['launches']}, unsharded {m['want_launches']}")
        check(rec["unsharded_gathers"] == 0, f"four cards sa, rank {r}: the unsharded run "
              f"gathered")
    rec = recs[0]
    log(f"  sa: schwefel f_best {rec['f_best']:.6f}, {rec['levels']} levels; on every rank of "
        f"{', '.join(m['mesh'] for m in rec['meshes'])}: f_best and x_best bit-equal to the "
        f"unsharded run on the rank's card, history_f the first shard's best-so-far, "
        f"{rec['levels'] + 2} all-gathers; B1/B2 launches per rank "
        f"{[[m['launches'] for m in x['meshes']] for x in recs]}; kernel library builds and "
        f"loads per rank {[x['kernel_library_builds_and_loads'] for x in recs]}; {smi}")
    for label, w in rec["walls"].items():
        busy = "not measured" if w["busy"] is None else f"{100 * w['busy']:.1f}%"
        log(f"  sa wall per level, {label}: {w['ms_per_level']:.4f} ms (rank 0; ranks "
            f"{', '.join(format(x['walls'][label]['ms_per_level'], '.4f') for x in recs)}), "
            f"device busy "
            f"{busy} of the first levels' span, device ms per level "
            f"{ {k: round(v, 5) for k, v in w['device_ms_per_level'].items()} }; launches "
            f"{w['launches']}")
    for m in rec["variants"]:
        log(f"  sa {m['label']}: bit-equal to the unsharded run on every rank, "
            f"{m['gathers']} all-gathers, launches {m['launches']}, wall {m['wall_s']:.3f} s")


def check_paths_ep(recs, smi=""):
    """Case 3's checks: see FOUR_CARDS_PATHS and :func:`paths_ep`."""
    for r, rec in enumerate(recs):
        check(all(v <= EP_REL for v in rec["layer"].values()), f"four cards ep, rank {r}: the "
              f"MoE layer with moe_ep against the local form: {rec['layer']} beyond {EP_REL}")
        for pair, part in rec["parting"].items():
            a, b = pair.split(" | ")
            n = len(rec[a]["losses"]) if part is None else part["step"]
            check(part is None or part["margin"] <= ROUTER_NEAR_TIE, f"four cards ep, rank "
                  f"{r}: {pair}: the picks part beyond a near-tie: {part}")
            check(np.allclose(rec[a]["losses"][:n], rec[b]["losses"][:n], **ORDER_TOL),
                  f"four cards ep, rank {r}: {pair}: losses {rec[a]['losses'][:n]} against "
                  f"{rec[b]['losses'][:n]} beyond {ORDER_TOL}, before the picks part ({part})")
            check(np.all(np.isfinite(rec[a]["losses"] + rec[b]["losses"])),
                  f"four cards ep, rank {r}: a loss is not finite")
        check(rec["(1, 4) moe_ep"]["all_to_all"] > 0, f"four cards ep, rank {r}: no all_to_all")
        check(rec["(1, 4) without moe_ep"]["all_to_all"] == 0 == rec["one card"]["all_to_all"],
              f"four cards ep, rank {r}: an all_to_all without moe_ep")
        check(rec["(1, 4) moe_ep"]["losses"] == recs[0]["(1, 4) moe_ep"]["losses"],
              f"four cards ep: rank {r}'s moe_ep losses differ from rank 0's")
    rec = recs[0]
    base = np.asarray(rec["one card"]["losses"])
    worst = {k: max(x["layer"][k] for x in recs) for k in rec["layer"]}
    log(f"  ep: {rec['layers']} layers, {rec['experts']} experts, top {rec['top_k']}, capacity "
        f"factor {rec['capacity_factor']}; one MoE layer with moe_ep against the local form, "
        f"largest relative difference over the ranks {worst} (limit {EP_REL}); the router's "
        f"smallest margin in the one-card run (neighbours among the top {rec['top_k'] + 1} "
        f"probabilities) {rec['margin']['min']:.3e} (dispatch {rec['margin']['dispatch']} of "
        f"{rec['margin']['dispatches']}); {smi}")
    for pair in rec["parting"]:
        log(f"  ep {pair}: the picks part first (per rank) {[x['parting'][pair] for x in recs]}")
    for label in ("one card", "(1, 4) moe_ep", "(1, 4) without moe_ep"):
        x = rec[label]
        rel = np.abs(np.asarray(x["losses"]) - base) / np.abs(base)
        peaks = [y[label]["peak_mib"] for y in recs]
        log(f"  ep {label}: losses {', '.join(f'{v:.6f}' for v in x['losses'])}; relative "
            f"difference from one card by step {', '.join(f'{v:.1e}' for v in rel)}; step "
            f"{x['step_ms']:.3f} ms (median, host clock; ranks "
            f"{', '.join(format(y[label]['step_ms'], '.3f') for y in recs)}); peak per rank "
            f"{', '.join('not measured' if p is None else f'{p:.1f}' for p in peaks)} MiB; "
            f"all_to_all calls {x['all_to_all']}")


def check_paths_tp(recs, smi=""):
    """Case 4's checks: see FOUR_CARDS_PATHS."""
    for r, rec in enumerate(recs):
        for m in rec["meshes"]:
            check(all(p["near_tie"] for p in m["parts"]),
                  f"four cards tp, rank {r}, mesh {m['mesh']}: tokens part beyond a near-tie: "
                  f"{m['parts']}")
    rec = recs[0]
    log(f"  tp: unsharded tokens on one card {rec['unsharded']['tokens']}, tick "
        f"{rec['unsharded']['tick_ms']:.3f} ms (median); the smallest gap between the two "
        f"largest logits {rec['unsharded']['margin']:.3e}; {smi}")
    for i, m in enumerate(rec["meshes"]):
        parts = [x["meshes"][i]["parts"] for x in recs if x["meshes"][i]["parts"]]
        log(f"  tp mesh {m['mesh']}: rows per rank {[x['meshes'][i]['rows'] for x in recs]}, "
            f"tokens {f'part at near-ties {parts}' if parts else 'equal'}; tick "
            f"{', '.join(format(x['meshes'][i]['tick_ms'], '.3f') for x in recs)} ms per rank "
            f"(median) against {rec['unsharded']['tick_ms']:.3f} on one card")


def check_paths_ckpt(recs, one_card=None, smi=""):
    """Case 5's checks: see FOUR_CARDS_PATHS; ``one_card`` the losses of
    four_cards_resume_one."""
    for r, rec in enumerate(recs):
        whole, n = np.asarray(rec["whole"]), len(rec["first"])
        b = rec["blocks"]
        check(b["equal"] == b["leaves"] and b["cut"] > 0 and b["step"] == b["data_step"] == n,
              f"four cards ckpt, rank {r}: restored blocks {b}")
        check(np.allclose(rec["first"], whole[:n], **ORDER_TOL),
              f"four cards ckpt, rank {r}: the run that saved gave {rec['first']}")
        for label, got in (("(1, 4)", rec["resumed"]), ("one card", one_card)):
            if got is not None:
                check(len(got) == len(whole) - n and np.allclose(got, whole[n:], **ORDER_TOL),
                      f"four cards ckpt, rank {r}: resumed on {label} {got} against the "
                      f"uninterrupted {whole[n:].tolist()}")
    rec = recs[0]
    n = len(rec["first"])
    log(f"  ckpt: saved over (2, 2) at step {n}; every rank restored its (1, 4) blocks of "
        f"{rec['blocks']['leaves']} leaves bit for bit ({rec['blocks']['cut']} cut); the "
        f"uninterrupted losses {', '.join(f'{x:.6f}' for x in rec['whole'])}; {smi}")
    for label, got in (("(1, 4)", rec["resumed"]), ("one card, no group", one_card)):
        if got is not None:
            rel = np.abs(np.asarray(got) - rec["whole"][n:]) / np.abs(rec["whole"][n:])
            log(f"  ckpt resumed on {label}: {', '.join(f'{x:.6f}' for x in got)}; largest "
                f"relative difference {rel.max():.3e}")


def check_paths_pipe(recs, smi=""):
    for r, rec in enumerate(recs):
        for m in rec["runs"]:
            check(m["err"] < PIPE_TOL and abs(m["bubble"] - m["want_bubble"]) < 1e-12,
                  f"four cards pipe, rank {r}: {m}")
    log("  pipe: " + "; ".join(
        f"{m['mesh']}, {m['stages']} stages: largest |difference| from the layers in order "
        f"{max(x['runs'][i]['err'] for x in recs):.3e} over the ranks, bubble {m['bubble']:.3f}"
        for i, m in enumerate(recs[0]["runs"])) + f"; {smi}")


def check_paths_compress(recs, smi=""):
    for r, rec in enumerate(recs):
        for m in rec["runs"]:
            for x in [m] + m["tree"]:
                check(x["deq_err"] <= COMPRESS_ATOL and x["rel"] < COMPRESS_REL
                      and x["resid_err"] <= COMPRESS_ATOL,
                      f"four cards compress, rank {r}, {m['mesh']}: {x}")
            check(m["resid_nonzero"], f"four cards compress, rank {r}: a zero residual")
            check(all(x["dtypes"] == ["torch.float32"] * 2 for x in m["tree"]),
                  f"four cards compress, rank {r}: {m['tree']}")
    log("  compress: " + "; ".join(
        f"{m['mesh']}: largest relative difference from the dense all_reduce "
        f"{max(y['rel'] for x in recs for y in [x['runs'][i]] + x['runs'][i]['tree']):.3e}, "
        f"from the dequantized shards "
        f"{max(y['deq_err'] for x in recs for y in [x['runs'][i]] + x['runs'][i]['tree']):.1e}"
        for i, m in enumerate(recs[0]["runs"])) + f"; {smi}")


#: Case -> its checks, in FOUR_CARDS_PATHS' order.
PATH_CHECKS = {"sa": check_paths_sa, "ep": check_paths_ep, "tp": check_paths_tp,
               "ckpt": check_paths_ckpt, "pipe": check_paths_pipe,
               "compress": check_paths_compress}


def four_cards_paths(env, smi, device="cuda", sizes=None):
    """The torchrun launch of :func:`four_cards_paths_rank` over the four
    cards, each case's record checked and logged (those that ran, when it
    failed), then case 5's resume on one card in this process.  ``device``
    "cpu" with small ``sizes`` rehearses it over gloo."""
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        path = Path(out) / "paths.json"
        log(f"four cards: the multi-rank paths (FOUR_CARDS_PATHS: {', '.join(PATH_CHECKS)}) "
            f"under torchrun, {'NCCL, one card' if device == 'cuda' else 'gloo, one process'} "
            f"per rank; {smi}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "4", "--no-python", sys.executable, "-c",
             f"import chip_smoke as cs; cs.four_cards_paths_rank({str(path)!r}, {device!r}, "
             f"{sizes!r})"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=1200)
        rec = json.loads(path.read_text()) if path.exists() else {}
        log(f"  launch wall {time.perf_counter() - t0:.1f} s; case walls (rank 0) "
            f"{ {k: round(v[0]['wall_s'], 1) for k, v in rec.items()} }")
        for name, fn in PATH_CHECKS.items():
            if name in rec and name != "ckpt":
                fn(rec[name], smi)
        check(proc.returncode == 0 and rec.keys() == PATH_CHECKS.keys(),
              f"four cards: the paths' launch exited {proc.returncode} after "
              f"{list(rec)}: {proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        t0 = time.perf_counter()
        one = four_cards_resume_one((sizes or FOUR_CARDS_PATHS)["ckpt"], Path(out) / "ckpt",
                                    device)
        log(f"  the one-card resume: {time.perf_counter() - t0:.1f} s")
        check_paths_ckpt(rec["ckpt"], one, smi)


@contextlib.contextmanager
def launches_by_card():
    """B1's and B3's launches counted by (kernel, device) while inside."""
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import qap_sweep as qs
    counts = collections.Counter()
    real = {ms: ms._launch, qs: qs._launch}

    def counted(mod, key):
        def launch(x, *a, **kw):
            counts[f"{key} {x.device}"] += 1
            return real[mod](x, *a, **kw)
        return launch

    ms._launch, qs._launch = counted(ms, "b1"), counted(qs, "b3")
    try:
        yield counts
    finally:
        ms._launch, qs._launch = real[ms], real[qs]


def four_cards_engine(smi, device="cuda"):
    """Case 2 (ENGINE_FOUR), in this process: phase 10's load on four
    shards, on the four cards and all on cuda:0 in turns (four, one, one,
    four), every run's champions equal bit for bit, every completed
    request against its standalone replay, no request lost, shard
    ``drain`` retired, migrations, B1's and B3's launches on every card;
    then the reference's serve_sa commands with --check on the cards.
    ``device`` "cpu" rehearses it (both fleets on the CPU)."""
    import io
    from repro_torch.service import (ArrivalProcess, EngineConfig, SAServeEngine,
                                     SchedulerConfig, serve_sa)
    on_card = torch.device(device).type == "cuda"
    n = ENGINE_FOUR["n_devices"]
    fleets = {"four cards": device, "all on cuda:0": "cuda:0" if on_card else device}
    reqs = elastic_requests()
    cfgs = {k: EngineConfig(**{**ELASTIC_CFG, "n_devices": n}, device=d,
                            scheduler=SchedulerConfig(**ELASTIC_SCHED)) for k, d in fleets.items()}
    log(f"four cards: the engine's shards, phase 10's load ({len(reqs)} requests, bursty "
        f"{ELASTIC_ARRIVALS}) on {n} shards of {ELASTIC_CFG['n_slots']} x "
        f"{ELASTIC_CFG['chains_per_slot']}, drain({ENGINE_FOUR['drain']}) at tick {DRAIN_AT}, "
        f"on the four cards and all on cuda:0 in turns; {smi}")

    def run(label, reqs, drain=True):
        engine = SAServeEngine(cfgs[label])
        devices = [str(s.device) for s in engine.shards]
        if drain:
            engine.schedule_op(DRAIN_AT, lambda: engine.drain(ENGINE_FOUR["drain"]))
        with launches_by_card() as per:
            for i in range(torch.cuda.device_count() if on_card else 0):
                torch.cuda.synchronize(i)
            t0 = time.perf_counter()
            results = engine.run_stream(ArrivalProcess.bursty(reqs, **ELASTIC_ARRIVALS))
            for i in range(torch.cuda.device_count() if on_card else 0):
                torch.cuda.synchronize(i)
            wall = time.perf_counter() - t0
        return engine, devices, results, wall, dict(per)

    for label in fleets:   # first launches on every card
        run(label, reqs[:8], drain=False)
    runs = [(label, run(label, reqs)) for label in
            ("four cards", "all on cuda:0", "all on cuda:0", "four cards")]
    ref = {r.req_id: r for r in runs[0][1][2]}
    for label, (engine, devices, results, wall, per) in runs:
        st = engine.stats()
        got = {r.req_id: r for r in results}
        check(len(got) == len(results) == len(reqs) and st["completed"] == len(reqs),
              f"four cards engine, {label}: a request was lost, finished twice or not completed")
        check(all(got[i].f_best == r.f_best and np.array_equal(got[i].x_best, r.x_best)
                  for i, r in ref.items()), f"four cards engine, {label}: champions differ")
        check(ENGINE_FOUR["drain"] in [i for i, _ in engine.retired_shards]
              and st["migrations"] > 0, f"four cards engine, {label}: retired "
              f"{engine.retired_shards}, {st['migrations']} migrations")
        want = ([f"cuda:{i}" for i in range(n)] if label == "four cards" else ["cuda:0"] * n) \
            if on_card else [device] * n
        check(devices == want, f"four cards engine, {label}: shards on {devices}")
        cards = sorted({k.split()[1] for k in per})
        check(not on_card or cards == sorted(set(want)) and all(
            per.get(f"{k} {c}", 0) > 0 for k in ("b1", "b3") for c in cards),
            f"four cards engine, {label}: launches {per}")
        log(f"  {label}: wall {wall:.3f} s, {len(results) / wall:.2f} requests/s, "
            f"{engine.tick_count} ticks, {st['migrations']} migrations, {st['preemptions']} "
            f"preemptions, retired {engine.retired_shards}; shards on {devices}; launches by "
            f"card {dict(sorted(per.items()))}")
    for label in fleets:
        walls = [r[3] for lab, r in runs if lab == label]
        log(f"  {label}: {len(reqs) / statistics.median(walls):.2f} requests/s (median wall "
            f"{statistics.median(walls):.3f} s of {len(walls)})")
    from repro_torch.service.serve_sa import replay_check
    t0 = time.perf_counter()
    reqs_by = {r.req_id: r for r in reqs}
    for rid, res in ref.items():
        check(replay_check(reqs_by[rid], res, cfgs["four cards"]),
              f"four cards engine: req {rid} differs from its standalone replay")
    log(f"  all {len(ref)} champions of the four-card run bit-exact against run_standalone "
        f"({time.perf_counter() - t0:.1f} s)")
    for argv in ENGINE_FOUR["cli"]:
        argv = [*argv, "--json"] + ([] if on_card else ["--device", device])
        buf = io.StringIO()
        with launches_by_card() as per, contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            rc = serve_sa.main(argv)
            wall = time.perf_counter() - t0
        doc = json.loads(buf.getvalue())
        c, st = doc["check"], doc["stats"]
        check(rc == 0 and c["bit_exact"] == c["served"] and not c["unserved_req_ids"],
              f"four cards engine: serve_sa {' '.join(argv)} exited {rc}: {c}")
        cards = sorted({k.split()[1] for k in per})
        check(not on_card or len(cards) > 1, f"four cards engine: serve_sa on {cards} only")
        auto = doc.get("autoscaler")
        log(f"  serve_sa {' '.join(argv)}: {c['bit_exact']}/{c['served']} champions bit-exact "
            f"against standalone; {st['completed']} completed in {st['ticks']} ticks, "
            f"{st['requests_per_s']:.2f} requests/s, {st['migrations']} migrations, "
            f"{st['shards_retired']} shards retired"
            + (f", {len(auto['decisions'])} fleet changes" if auto else "")
            + f"; launches by card {dict(sorted(per.items()))}; {wall:.1f} s with the check")


def four_cards() -> int:
    """The four-card record (FOUR_CARDS), run on its own:
    ``python -c "import chip_smoke as cs; raise SystemExit(cs.four_cards())"``.
    For each --model-parallel, ``torchrun --standalone`` of
    launch/train.py over the four cards, each rank's record
    (``--record``) read back: its losses against the --model-parallel 1
    run's at ORDER_TOL, the step (median of every rank's host step times
    from `timed_from`), tokens/s and the largest peak per rank.  Then
    FOUR_CARDS_SEQ's batch-1 decodes under ``torchrun``
    (:func:`four_cards_seq_rank`): each run's tokens, and those of the MoE
    without expert parallelism over (1, 4), against the unsharded
    steps'.  Then FOUR_CARDS' cell with seq_parallel at each
    ``SEQ_PAR["four_cards_mp"]`` (:func:`four_cards_sp_rank`): its losses
    against the --model-parallel 1 run's at ORDER_TOL, its step and peak
    beside the same mesh's run without it.  Then the multi-rank paths
    (:func:`four_cards_paths`, FOUR_CARDS_PATHS) and the serving engine's
    shards on the four cards (:func:`four_cards_engine`, ENGINE_FOUR).
    The kernel library is built here first, so no rank builds it.
    Returns 0 when every check held."""
    import tempfile
    F = FOUR_CARDS
    if torch.cuda.device_count() < 4:
        print(f"four_cards: {torch.cuda.device_count()} CUDA devices, not 4", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    smi = "; ".join(smi.splitlines())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()    # here, so the ranks of every launch load it and none builds
    log(f"four cards: kernel library {lib.name} ready in {time.perf_counter() - t0:.1f} s")

    def train_argv(mp):
        return ["--arch", F["arch"], "--seq", str(F["seq"]), "--batch", str(F["batch"]),
                "--steps", str(F["steps"]), "--log-every", str(F["steps"]),
                "--model-parallel", str(mp)]

    try:
        with tempfile.TemporaryDirectory() as out:
            for mp in F["model_parallel"]:
                log(f"four cards: {F['arch']} float32, AdamW, {F['batch']} x {F['seq']} tokens, "
                    f"{F['steps']} steps, --model-parallel {mp} (mesh ({4 // mp}, {mp})); {smi}")
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *train_argv(mp),
                     "--record", f"{out}/mp{mp}_{{rank}}.json"],
                    env=env, capture_output=True, text=True, timeout=600)
                log(proc.stdout[-3000:])
                check(proc.returncode == 0, f"four cards: --model-parallel {mp} exited "
                      f"{proc.returncode}: {proc.stderr[-3000:]}")
                recs = [json.loads(Path(out, f"mp{mp}_{r}.json").read_text()) for r in range(4)]
                check(all(r["losses"] == recs[0]["losses"] for r in recs),
                      f"four cards: --model-parallel {mp}: the ranks' losses differ")
                steps = [t for r in recs for t in r["step_ms"][F["timed_from"]:]]
                step = statistics.median(steps)
                runs[mp] = dict(losses=recs[0]["losses"], step=step,
                                peak=max(r["peak_mib"] or 0.0 for r in recs), mesh=recs[0]["mesh"])
                log(f"  mesh {recs[0]['mesh']}: losses "
                    f"{', '.join(f'{x:.6f}' for x in recs[0]['losses'])}; step {step:.3f} ms "
                    f"(median of {len(steps)}: steps {F['timed_from']}-{F['steps'] - 1} of 4 ranks, "
                    f"host clock; min {min(steps):.3f}, max {max(steps):.3f}), "
                    f"{F['batch'] * F['seq'] / step * 1e3:.1f} tokens/s; peak per rank "
                    f"{runs[mp]['peak']:.1f} MiB; wall {time.perf_counter() - t0:.1f} s")
        base = np.asarray(runs[1]["losses"])
        for mp in F["model_parallel"][1:]:
            got = np.asarray(runs[mp]["losses"])
            rel = np.abs(got - base) / np.abs(base)
            log(f"  --model-parallel {mp} against 1: largest relative loss difference "
                f"{rel.max():.3e} (step {int(rel.argmax())}), by step "
                f"{', '.join(f'{x:.1e}' for x in rel)}")
            check(np.allclose(got, base, **ORDER_TOL), f"four cards: --model-parallel {mp} "
                  f"losses {got.tolist()} against {base.tolist()} beyond {ORDER_TOL}")
        with tempfile.TemporaryDirectory() as out:
            S = FOUR_CARDS_SEQ
            log(f"four cards: shrink({S['arch']}) float32, batch 1, prompt {S['prompt']}, "
                f"{S['ticks']} ticks, caches of {S['s_max']}: the sequence-cut decode over "
                f"{', '.join(f'{m} seq_shard_kv={k}' for m, k in S['runs'])} (NCCL) against "
                f"each rank's unsharded steps; {smi}")
            t0 = time.perf_counter()
            seq_env = dict(env, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "4", "--no-python", sys.executable, "-c",
                 f"import chip_smoke as cs; cs.four_cards_seq_rank({str(Path(out) / 'seq.json')!r})"],
                env=seq_env, cwd=ROOT, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"four cards: the sequence-cut decode exited "
                  f"{proc.returncode}: {proc.stderr[-3000:]}")
            seq = json.loads(Path(out, "seq.json").read_text())
            for run, r in seq["runs"].items():
                log(f"  {run}: tokens {r['got']} against unsharded {r['want']}; tick "
                    f"{r['tick_ms']:.3f} ms (median, CUDA events); cuts {r['cuts']}; wall "
                    f"{time.perf_counter() - t0:.1f} s")
                check(r["got"] == r["want"], f"four cards: {run}: tokens differ")
                check(any(r["cuts"]), f"four cards: {run}: no layer's sequence is cut")
            r = seq["repair"]
            log(f"  {r['run']}: tokens {r['got']} against unsharded {r['want']}; tick "
                f"{r['tick_ms']:.3f} ms (median, CUDA events); expert stacks kept cut over "
                f"'model': {r['stacks_kept_cut']}")
            check(r["got"] == r["want"], f"four cards: {r['run']}: tokens differ")
            check(r["stacks_kept_cut"], f"four cards: {r['run']}: expert stacks gathered whole")
        with tempfile.TemporaryDirectory() as out:
            sp_env = dict(env, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
            for mp in SEQ_PAR["four_cards_mp"]:
                log(f"four cards: {F['arch']} float32, AdamW, {F['batch']} x {F['seq']} tokens, "
                    f"{F['steps']} steps, seq_parallel over mesh ({4 // mp}, {mp}); {smi}")
                t0 = time.perf_counter()
                argv = train_argv(mp) + ["--record", f"{out}/sp{mp}_{{rank}}.json"]
                proc = subprocess.run(
                    [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "4", "--no-python", sys.executable, "-c",
                     f"import chip_smoke as cs; cs.four_cards_sp_rank({argv!r})"],
                    env=sp_env, cwd=ROOT, capture_output=True, text=True, timeout=600)
                log(proc.stdout[-3000:])
                check(proc.returncode == 0, f"four cards: seq_parallel at --model-parallel {mp} "
                      f"exited {proc.returncode}: {proc.stderr[-3000:]}")
                recs = [json.loads(Path(out, f"sp{mp}_{r}.json").read_text()) for r in range(4)]
                check(all(r["losses"] == recs[0]["losses"] for r in recs),
                      f"four cards: seq_parallel at --model-parallel {mp}: the ranks' losses "
                      f"differ")
                steps = [t for r in recs for t in r["step_ms"][F["timed_from"]:]]
                step, peak = statistics.median(steps), max(r["peak_mib"] or 0.0 for r in recs)
                got = np.asarray(recs[0]["losses"])
                rel = np.abs(got - base) / np.abs(base)
                log(f"  mesh {recs[0]['mesh']} seq_parallel: losses "
                    f"{', '.join(f'{x:.6f}' for x in got)}; largest relative difference from "
                    f"--model-parallel 1 {rel.max():.3e}; step {step:.3f} ms (median of "
                    f"{len(steps)}, host clock) against {runs[mp]['step']:.3f} ms without it; "
                    f"peak per rank {peak:.1f} MiB against {runs[mp]['peak']:.1f} MiB; wall "
                    f"{time.perf_counter() - t0:.1f} s")
                check(np.allclose(got, base, **ORDER_TOL), f"four cards: seq_parallel at "
                      f"--model-parallel {mp} losses {got.tolist()} against {base.tolist()}")
        four_cards_paths(dict(env, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}"), smi)
        four_cards_engine(smi)
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    log(smi)
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not (args == [] or (len(args) == 2 and args[0] == "--against")):
        print("usage: chip_smoke.py [--against DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    smi = phase0_device()

    def elapsed(name):
        log(f"  [{name} done, {time.perf_counter() - t_start:.1f} s into the script]")

    if args:                      # --against DIR: two trees on one card
        against(Path(args[1]), gen)
        serve_against(Path(args[1]))
        log(smi)
        return 0
    b1_err = phase1_sweep(gen)
    elapsed("phase1_sweep")
    b2_err = phase2_argmin(gen)
    elapsed("phase2_argmin")
    launches, p3 = phase3_main_path()
    elapsed("phase3_main_path")
    p4, _ = phase4_main_path()
    elapsed("phase4_main_path")
    full_launches = p4["b1"]
    phase5_v0_v1()
    elapsed("phase5_v0_v1")
    t = phase6_times(gen)
    elapsed("phase6_times")
    b2_route_times(gen)
    elapsed("b2_route_times")
    b3_err = phase7_qap_sweep()
    elapsed("phase7_qap_sweep")
    b3_launches, _ = phase8_serving()
    elapsed("phase8_serving")
    phase9_mixed()
    elapsed("phase9_mixed")
    b3 = phase_b3_times(gen)
    elapsed("phase_b3_times")
    elastic_b1, elastic_b3 = phase10_elastic()
    elapsed("phase10_elastic")
    suite = phase11_suite()
    elapsed("phase11_suite")
    table7, _ = phase12_precision(gen)
    elapsed("phase12_precision")
    temper = phase13_tempering()
    elapsed("phase13_tempering")
    tel_launches = phase14a_telemetry()
    elapsed("phase14a_telemetry")
    auto_b1 = phase14b_autoscaler(smi)
    elapsed("phase14b_autoscaler")
    p15 = phase15_sharded(smi, dict(p3, launches=launches))
    elapsed("phase15_sharded")
    p16 = phase16_llm(smi)
    elapsed("phase16_llm")
    p17 = phase17_moe(smi)
    elapsed("phase17_moe")
    p18 = phase18_mamba_encdec(smi)
    elapsed("phase18_mamba_encdec")
    p19 = phase19_train(smi)
    elapsed("phase19_train")
    p20 = phase20_dryrun(smi)
    elapsed("phase20_dryrun")
    p21 = phase21_sharded_state(smi, p19["p19a"])
    elapsed("phase21_sharded_state")
    p22 = phase22_tensor_parallel(smi)
    elapsed("phase22_tensor_parallel")
    p23 = phase23_sequence(smi)
    elapsed("phase23_sequence")
    p24 = phase24_seq_parallel(smi)
    elapsed("phase24_seq_parallel")
    b1 = dict(route="cuda", source="src/repro_torch/kernels/csrc/metropolis_sweep.cu",
              replaces="src/repro/kernels/metropolis_sweep.py:81", library_ms=None)
    kernels = [
        {"name": "metropolis_sweep_delta", **b1,
         "launches": launches["metropolis_sweep"],
         "launches_by_path": {"phase 3": launches["metropolis_sweep"],
                              "phase 10": elastic_b1, "phase 13": temper["b1"],
                              "phase 14a": tel_launches["b1"], "phase 14b": auto_b1,
                              "phase 15": p15["b1_delta"], "phase 16": p16["b1"],
                              "phase 17": p17["b1"], "phase 18": p18["b1"],
                              "phase 19": p19["b1"], "phase 20": p20["b1"],
                              "phase 21": p21["b1"], "phase 22": p22["b1"],
                              "phase 23": p23["b1"], "phase 24": p24["b1"]},
         "max_abs_err": max(b1_err["delta"], temper["max_abs_err"]),
         "ms": t["delta"][0], "wrapper_ms": t["delta"][1], "plain_ms": t["delta"][2],
         "bound_ms": t["delta"][3], "bound_by": t["delta"][4]},
        {"name": "metropolis_sweep_full", **b1,
         "launches": full_launches,
         "launches_by_path": {"phase 4": full_launches, "phase 11": suite["b1"],
                              "phase 12": table7["b1"], "phase 15": p15["b1_full"],
                              "phase 16": p16["b1"], "phase 17": p17["b1"],
                              "phase 18": p18["b1"], "phase 19": p19["b1"],
                              "phase 20": p20["b1"], "phase 21": p21["b1"], "phase 22": p22["b1"],
                              "phase 23": p23["b1"], "phase 24": p24["b1"]},
         "max_abs_err": max(b1_err["full"], suite["max_abs_err"], table7["max_abs_err"]),
         "ms": t["full"][0], "wrapper_ms": t["full"][1], "plain_ms": t["full"][2],
         "bound_ms": t["full"][3], "bound_by": t["full"][4]},
        {"name": "argmin_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/reduce_min.cu",
         "replaces": "src/repro/kernels/reduce_min.py:24",
         "launches": launches["argmin_reduce"],
         "launches_by_path": {"phase 3": launches["argmin_reduce"], "phase 4": p4["b2"],
                              "phase 11": suite["b2"], "phase 12": table7["b2"],
                              "phase 15": p15["b2"], "phase 16": p16["b2"],
                              "phase 17": p17["b2"], "phase 18": p18["b2"],
                              "phase 19": p19["b2"], "phase 20": p20["b2"],
                              "phase 21": p21["b2"], "phase 22": p22["b2"],
                              "phase 23": p23["b2"], "phase 24": p24["b2"]},
         "max_abs_err": b2_err,
         "ms": t["b2"][0], "wrapper_ms": t["b2"][1], "plain_ms": t["b2"][2],
         "bound_ms": t["b2"][3], "bound_by": "bytes", "library_ms": t["b2"][4]},
        {"name": "qap_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qap_sweep.cu",
         "replaces": "src/repro/kernels/qap_sweep.py:165",
         "launches": b3_launches,
         "launches_by_path": {"phase 8": b3_launches, "phase 10": elastic_b3,
                              "phase 13": temper["b3"], "phase 14a": tel_launches["b3"],
                              "phase 16": p16["b3"], "phase 17": p17["b3"],
                              "phase 18": p18["b3"], "phase 19": p19["b3"],
                              "phase 20": p20["b3"], "phase 21": p21["b3"],
                              "phase 22": p22["b3"], "phase 23": p23["b3"], "phase 24": p24["b3"]},
         "max_abs_err": b3_err,
         "ms": b3[0], "wrapper_ms": b3[1], "plain_ms": b3[2], "bound_ms": b3[3],
         "bound_by": b3[4], "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
