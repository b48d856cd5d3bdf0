"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --against DIR    # phase 0, then B1 full and B3
                                           # against the kernels of the tree
                                           # DIR (bits, then times in turns)

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
   all 688 levels, with B1 full's launches, the device time per level of
   the first 100 levels, and the quality gate of phase 3;
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
   and 4, every champion bit-exact against its standalone run.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import json
import math
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

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# Hopper has 64 INT32 lanes per SM beside its 128 FP32 ones:
# 132 SMs x 64 lanes x 1.98 GHz boost clock.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# One float32 instruction per lane and cycle (an FMA counts two of the
# 67 TFLOP/s): the rate at which the SMs issue lane-instructions.
LANE_INSTR_PER_S = FP32_OPS_PER_S / 2
# Integer ops of one threefry2x32: 2 key adds, 20 rounds of add, rotate and
# xor, 5 key injections of 3 adds (csrc/rng.cuh).
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3
# Lane-instructions of one full-variant step beyond its new term: the
# changed lane's re-fold (ceil(dim / 32) adds, counted apart), five tree
# adds, f, the accept test's subtraction, division, clip and exp.
FULL_STEP_INSTR = 5 + 10

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
# float32 operations of one move's O(n) delta: per location k, two
# products of two differences and their sums.
QAP_DELTA_OPS_PER_N = 10


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


def device_ms(fn, n=50):
    """Device time per fn() call from a torch.profiler (CUPTI) trace of n
    calls: the kernels and memory operations it holds, summed.  Returns
    (ms or None when the trace holds no device activity, device ops per
    call, their names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None, 0, []
    total_us = sum(e.time_range.elapsed_us() for e in dev)
    return total_us / n / 1e3, len(dev) / n, sorted({e.name[:60] for e in dev})


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
                          sa_f=h.sa.f_best, nm_f=h.nm.f_best)


def sa_device_share(obj, cfg_kw, wall_per_level, b1_kernel, levels=100):
    """The SA ladder of ``cfg_kw`` cut to its first ``levels`` levels under a
    torch.profiler trace: device time per level by kernel (B1 is the
    kernel named ``b1_kernel``), against the wall time per level of the
    unprofiled run.  Returns the busy share, or None when the trace holds
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import SAConfig, sa_minimize
    cfg = SAConfig(**{**cfg_kw, "T_min": cfg_kw["T0"] * cfg_kw["rho"] ** (levels - 0.5)})
    check(cfg.n_levels == levels, "profiled ladder cut")
    sa_minimize(obj, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sa_minimize(obj, cfg)
        torch.cuda.synchronize()
    per = {"B1": 0.0, "B2": 0.0, "other": 0.0}
    n_ops = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("B1" if b1_kernel in e.name else
               "B2" if "argmin_kernel" in e.name else "other")
        per[key] += e.time_range.elapsed_us() / 1e3 / levels
        n_ops += 1
    busy = sum(per.values())
    if n_ops == 0:
        log("  SA device time per level: not measured (no device activity in the trace)")
        return None
    log(f"  SA device time per level (profiled, first {levels} levels): {busy:.4f} ms "
        f"(B1 {per['B1']:.4f}, B2 {per['B2']:.4f}, other {per['other']:.4f} ms in "
        f"{n_ops / levels:.1f} device ops), against {wall_per_level * 1e3:.4f} ms of "
        f"wall per level unprofiled: the device is busy {100 * busy / (wall_per_level * 1e3):.1f}% "
        "of the SA wall")
    return busy / (wall_per_level * 1e3)


def phase4_main_path():
    """The F0_g row as the reference's Table 10 bench runs it: sa_minimize
    with the default full variant, every level."""
    from repro_torch.core import SAConfig, sa_minimize
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.objectives import functions as F
    cfg = SAConfig(**MAIN_CFG)
    obj = F.schwefel(MAIN_DIM)
    log(f"phase 4: main path sa_minimize(schwefel({MAIN_DIM}), {MAIN_CFG}), full "
        f"variant, {cfg.n_levels} levels")
    torch.cuda.synchronize()
    ms.counter.launches = 0
    t0 = time.perf_counter()
    r = sa_minimize(obj, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ms.counter.launches
    err = abs(r.f_best - SCHWEFEL_F_OPT)
    rate = cfg.n_evals / wall
    log(f"  SA f_best {r.f_best:.6f} (|f - f_opt| {err:.3e}), wall {wall:.3f} s, "
        f"{cfg.n_evals} proposals, {rate:.4e} proposals/s, B1 full launches {launches}")
    check(launches == cfg.n_levels,
          f"B1 full launched {launches} times, expected {cfg.n_levels}")
    check(math.isfinite(r.f_best) and r.x_best.shape == (MAIN_DIM,), "phase 4 output")
    f_x = float(obj(torch.from_numpy(r.x_best).to(DEV)))
    check(abs(f_x - r.f_best) <= 1e-4 * abs(f_x), "phase 4 (x, f) not coherent")
    check(err < 0.5 * abs(SCHWEFEL_F_OPT), f"phase 4: SA error {err}")
    busy = sa_device_share(obj, MAIN_CFG, wall / cfg.n_levels, "sweep_full_kernel")
    return launches, dict(wall_s=wall, rate=rate, f_best=r.f_best, busy=busy)


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


def b1_bounds(n, dim, N):
    """The least time of B1 at n chains of dim coordinates and N steps, by
    variant: (ms, what bounds it).  Bytes: x read once, x and f written
    once.  Operations: two threefry2x32 per proposal (integer lanes); for
    full also the initial evaluation (one term per coordinate) and per
    step one term, the changed lane's re-fold and the accept test (float
    lanes), with a term's SASS instructions counted in phase 0."""
    xbytes = 2 * n * dim * 4 + n * 4
    t_bytes = xbytes / HBM_BYTES_PER_S
    t_rng = n * N * 2 * THREEFRY_OPS / INT32_OPS_PER_S
    term = TERM_INSTR
    t_full = (n * dim * term + n * N * (term + -(-dim // 32) + FULL_STEP_INSTR)) \
        / LANE_INSTR_PER_S
    out = {}
    for v, t_ops in (("delta", t_rng), ("full", max(t_rng, t_full))):
        out[v] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


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
    bounds = b1_bounds(n, dim, N)
    b2_bound = (n + 1) * 4 / HBM_BYTES_PER_S * 1e3
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
        f"bound {b2_bound:.6f} ms (bytes)")
    for name, fn in (("B1 delta", lambda: ms.metropolis_sweep_kernel(
                         x, T, 0, 0, variant="delta", **sweep)),
                     ("B1 full", lambda: ms.metropolis_sweep_kernel(
                         x, T, 0, 0, variant="full", **sweep)),
                     ("B2", lambda: rm.argmin_reduce(f)),
                     ("torch.min(f, 0)", lambda: torch.min(f, 0)),
                     ("torch.argmin", lambda: torch.argmin(f))):
        dev_ms, per_call, names = device_ms(fn)
        shown = "not measured (no device activity in the trace)" if dev_ms is None \
            else f"{dev_ms:.4f} ms"
        log(f"  {name}: device time per call {shown}, {per_call:g} device op(s) per "
            f"call ({', '.join(names)})")
    # Where B1's time goes: the copy and the initial evaluation alone
    # (N = 0), then more steps.
    for variant in ("delta", "full"):
        shown = []
        for steps in (0, 1, 16, N):
            dev_ms, _, _ = device_ms(lambda: ms.metropolis_sweep_kernel(
                x, T, 0, 0, variant=variant, kid=0, n_steps=steps, blk=256), n=20)
            shown.append(f"N={steps} {dev_ms:.4f} ms" if dev_ms is not None
                         else f"N={steps} not measured")
        log(f"  B1 {variant} device time by steps: " + ", ".join(shown))
    return dict(delta=(*times["delta"], *bounds["delta"]),
                full=(*times["full"], *bounds["full"]),
                b2=(b2, b2w, b2p, b2_bound, lib_min))


def b2_route_times(gen):
    """B2's device time through one CTA and through the grid at lengths
    around ONE_CTA_MAX, the measurement behind that threshold."""
    from repro_torch.kernels import reduce_min as rm
    for n in B2_ROUTE_SIZES:
        g = torch.randn(n, generator=gen, device=DEV)
        shown = []
        for route in ("one CTA", "grid"):
            dev_ms, per_call, _ = device_ms(lambda: argmin_route(g, route))
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
    steps = {}
    for name in HOST_STEPS:
        def step(*a, _fn=getattr(engine, name), _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                steps[_name] = steps.get(_name, 0.0) + time.perf_counter() - t
        setattr(engine, name, step)
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


def b3_bound(chains, n, n_slots, n_steps=QAP_STEPS):
    """The least time of B3: p read and written once, f and the blocks' F
    and D; two threefry2x32 per move on the integer lanes plus the
    delta's 10 n float32 operations.  Returns (ms, what bounds it)."""
    proposals = chains * n_steps
    qbytes = 2 * chains * n * 4 + chains * 4 + 2 * n_slots * n * n * 4
    t_bytes = qbytes / HBM_BYTES_PER_S
    t_ops = (proposals * 2 * THREEFRY_OPS / INT32_OPS_PER_S
             + proposals * QAP_DELTA_OPS_PER_N * n / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    bound, by = b3_bound(chains, n, n_slots)
    log(f"  B3 at phase 8's group shape ({chains} chains, n={n}, N={QAP_STEPS}): "
        f"kernel {k:.4f} ms (the call with its wrapper {call:.4f} ms), plain {p:.4f} ms, "
        f"bound {bound:.4f} ms ({by}), {proposals / (k * 1e-3):.4e} proposals/s")
    # Where the time goes: loads, tables and initial costs alone (N = 0),
    # then more moves.
    shown = []
    for steps in (0, 1, 16, QAP_STEPS):
        dev_ms, _, _ = device_ms(lambda: qs.qap_sweep_kernel(*args, **{**kw, "n_steps": steps}),
                                 n=20)
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
    bounds = {"B1 full": b1_bounds(n, dim, N)["full"], "B1 delta": b1_bounds(n, dim, N)["delta"],
              "B3": b3_bound(*host["p"].shape, SERVE_CFG["n_slots"] // 2)}
    log(f"  C entry (CUDA events) and device (profiler) ms at {n} x {dim}, N={N} (B1) "
        f"and {host['p'].shape[0]} chains of n=12, N={QAP_STEPS} (B3)")
    for label, lib in (("that", other), ("this", this), ("this", this), ("that", other)):
        with use_lib(lib):
            for name, (fn, entry) in calls.items():
                k = kernel_ms(fn, entry)
                dev_ms, _, _ = device_ms(fn, n=20)
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
    if args:                      # --against DIR: two trees on one card
        against(Path(args[1]), gen)
        log(smi)
        return 0
    b1_err = phase1_sweep(gen)
    b2_err = phase2_argmin(gen)
    launches, _ = phase3_main_path()
    full_launches, _ = phase4_main_path()
    phase5_v0_v1()
    t = phase6_times(gen)
    b2_route_times(gen)
    b3_err = phase7_qap_sweep()
    b3_launches, _ = phase8_serving()
    phase9_mixed()
    b3 = phase_b3_times(gen)
    b1 = dict(route="cuda", source="src/repro_torch/kernels/csrc/metropolis_sweep.cu",
              replaces="src/repro/kernels/metropolis_sweep.py:81", library_ms=None)
    kernels = [
        {"name": "metropolis_sweep_delta", **b1,
         "launches": launches["metropolis_sweep"], "max_abs_err": b1_err["delta"],
         "ms": t["delta"][0], "wrapper_ms": t["delta"][1], "plain_ms": t["delta"][2],
         "bound_ms": t["delta"][3], "bound_by": t["delta"][4]},
        {"name": "metropolis_sweep_full", **b1,
         "launches": full_launches, "max_abs_err": b1_err["full"],
         "ms": t["full"][0], "wrapper_ms": t["full"][1], "plain_ms": t["full"][2],
         "bound_ms": t["full"][3], "bound_by": t["full"][4]},
        {"name": "argmin_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/reduce_min.cu",
         "replaces": "src/repro/kernels/reduce_min.py:24",
         "launches": launches["argmin_reduce"], "max_abs_err": b2_err,
         "ms": t["b2"][0], "wrapper_ms": t["b2"][1], "plain_ms": t["b2"][2],
         "bound_ms": t["b2"][3], "bound_by": "bytes", "library_ms": t["b2"][4]},
        {"name": "qap_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qap_sweep.cu",
         "replaces": "src/repro/kernels/qap_sweep.py:165",
         "launches": b3_launches, "max_abs_err": b3_err,
         "ms": b3[0], "wrapper_ms": b3[1], "plain_ms": b3[2], "bound_ms": b3[3],
         "bound_by": b3[4], "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
