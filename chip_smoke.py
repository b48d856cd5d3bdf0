"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a)
and runs, in order, failing on the first phase that fails:

0. device: the card's name and power limit, torch/CUDA versions, build time;
1. kernel B1 (Metropolis sweep) vs its plain version at 16384 chains, dim 32
   and 512, full and delta, in the 64-slot layout of the serving engine;
2. kernel B2 (block argmin) vs its plain version, fp32 and bf16, with ties;
3. the main path: hybrid SA -> Nelder-Mead on Schwefel-512 at 16384 chains
   (the F0_g row of the paper's Table 10), delta variant, with the kernels'
   launch counts over that run;
4. the paper-faithful full variant at the same width, first 20 levels;
5. V0 and V1 (async) and SOS on Schwefel-32, and a small run held against
   the plain CPU path;
6. kernel times at the main path's shapes (CUDA events, median).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

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
# Integer ops of one threefry2x32: 2 key adds, 20 rounds of add, rotate and
# xor, 5 key injections of 3 adds (csrc/rng.cuh).
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3
# float32 ops per Schwefel coordinate evaluated: abs, sqrt, sin, mul, add.
SCHWEFEL_COORD_OPS = 5

MAIN_CFG = dict(T0=1000.0, T_min=1.0, rho=0.99, N=33, n_chains=16384,
                exchange="sync", use_delta_eval=True)
MAIN_DIM = 512
SCHWEFEL_F_OPT = -418.982887
# Phase sizes: the serving layout of phase 1, the argmin lengths of phase
# 2 and the chain count of phase 5.
SWEEP_DIMS = (32, 512)
N_SLOTS, SLOT_BLK = 64, 256
ARGMIN_SIZES = (16384, 16385, 2**20)
V1_CHAINS = 16384


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- helpers
def slot_layout(dim, gen, *, seed=0):
    """The serving engine's layout: one slot per block of ``blk`` chains,
    mixed kids, seeds, step0 near 2^31, shuffled chain bases, half the
    slots dead."""
    from repro_torch.kernels import objective_math as om
    n_slots, blk = N_SLOTS, SLOT_BLK
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
        step0=(2**31 - 8 + rs.integers(0, 16, n_slots)).astype(np.uint64),
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


# ---------------------------------------------------------------- phases
def phase0_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    from repro_torch.kernels import _build
    _build.lib()
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, kernel build {_build.build_seconds:.2f} s")
    return smi.stdout.strip().splitlines()[0]


def phase1_sweep(gen):
    from repro_torch.kernels.metropolis_sweep import (metropolis_sweep_kernel,
                                                      metropolis_sweep_plain)
    log(f"phase 1: kernel B1 vs plain version, {N_SLOTS} slots x {SLOT_BLK} "
        "chains, n_steps=16")
    worst = 0.0
    cases = [(d, v, False) for d in SWEEP_DIMS for v in ("delta", "full")]
    cases.append((SWEEP_DIMS[0], "delta", True))
    for dim, variant, with_t_chain in cases:
        lay = slot_layout(dim, gen, seed=dim + len(variant))
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
        name = f"dim {dim} {variant}" + (" t_chain" if with_t_chain else "")
        worst = max(worst, compare_sweep(name, lay["x"], run, ctl, 16, variant,
                                         dead_rows=dead))
    return worst


def phase2_argmin(gen):
    from repro_torch.kernels.reduce_min import argmin_reduce, argmin_reduce_plain
    log("phase 2: kernel B2 vs plain version")
    for n in ARGMIN_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            f = torch.randn(n, generator=gen, device=DEV).to(dtype)
            low = f.min() - 1
            f[[n // 3, n // 3 + 1, n - 1]] = low    # ties inside and across tiles
            m, i = argmin_reduce(f)
            mp, ip = argmin_reduce_plain(f)
            check(int(i) == int(ip) == n // 3 and float(m) == float(mp),
                  f"B2 n={n} {dtype}: kernel ({float(m)}, {int(i)}) vs plain "
                  f"({float(mp)}, {int(ip)})")
            log(f"  n={n} {dtype}: ({float(m)}, {int(i)}) exact")
    return 0.0


def phase3_main_path():
    from repro_torch.core import SAConfig, annealing, hybrid, hybrid_minimize
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce_min as rm
    from repro_torch.objectives import functions as F
    cfg = SAConfig(**MAIN_CFG)
    obj = F.schwefel(MAIN_DIM)
    log(f"phase 3: main path hybrid_minimize(schwefel({MAIN_DIM}), {MAIN_CFG}), "
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


def phase4_full_variant():
    from repro_torch.core import SAConfig, sa_minimize
    from repro_torch.objectives import functions as F
    cfg = SAConfig(**{**MAIN_CFG, "use_delta_eval": False,
                      "T_min": MAIN_CFG["T0"] * MAIN_CFG["rho"] ** 19.5})
    check(cfg.n_levels == 20, "phase 4 ladder cut")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = sa_minimize(F.schwefel(MAIN_DIM), cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(math.isfinite(r.f_best), "phase 4 f_best")
    full_levels = SAConfig(**MAIN_CFG).n_levels
    log(f"phase 4: full variant, {cfg.n_chains} x {MAIN_DIM}, cut to the first 20 "
        f"of {full_levels} levels: f_best {r.f_best:.4f}, {wall:.3f} s, {cfg.n_evals / wall:.4e} proposals/s")
    return cfg.n_evals / wall


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
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import reduce_min as rm
    from repro_torch.kernels import ref
    n, dim, N = MAIN_CFG["n_chains"], MAIN_DIM, MAIN_CFG["N"]
    x = ((torch.rand(n, dim, generator=gen, device=DEV) - 0.5) * 1024).contiguous()
    T = 5.0
    sweep = dict(kid=0, n_steps=N, blk=256)
    times = {}
    for variant in ("delta", "full"):
        k = cuda_ms(lambda: ms.metropolis_sweep_kernel(x, T, 0, 0, variant=variant, **sweep))
        p = cuda_ms(lambda: ref.metropolis_sweep_ref(x, T, 0, 0, kid=0, n_steps=N,
                                                     variant=variant), n=20, warmup=2)
        times[variant] = (k, p)
    f = torch.randn(n + 1, generator=gen, device=DEV)
    b2 = cuda_ms(lambda: rm.argmin_reduce(f), n=50)
    b2p = cuda_ms(lambda: rm.argmin_reduce_plain(f), n=50)
    lib = cuda_ms(lambda: torch.argmin(f), n=50)
    proposals = n * N
    xbytes = 2 * n * dim * 4 + n * 4          # x read once, x and f written once
    bounds = {
        "delta": max(xbytes / HBM_BYTES_PER_S,
                     proposals * 2 * THREEFRY_OPS / INT32_OPS_PER_S) * 1e3,
        "full": max(xbytes / HBM_BYTES_PER_S,
                    proposals * dim * SCHWEFEL_COORD_OPS / FP32_OPS_PER_S) * 1e3,
    }
    by = {"delta": "bytes" if xbytes / HBM_BYTES_PER_S
          >= proposals * 2 * THREEFRY_OPS / INT32_OPS_PER_S else "operations",
          "full": "bytes" if xbytes / HBM_BYTES_PER_S
          >= proposals * dim * SCHWEFEL_COORD_OPS / FP32_OPS_PER_S else "operations"}
    b2_bound = (n + 1) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"phase 6: at the main path's shapes ({n} x {dim}, N={N}; argmin over {n + 1})")
    for v in ("delta", "full"):
        k, p = times[v]
        log(f"  B1 {v}: kernel {k:.4f} ms, plain {p:.4f} ms, bound {bounds[v]:.4f} ms "
            f"({by[v]}), {proposals / (k * 1e-3):.4e} proposals/s")
    log(f"  B2: kernel {b2:.4f} ms, plain {b2p:.4f} ms, torch.argmin {lib:.4f} ms, "
        f"bound {b2_bound:.6f} ms (bytes)")
    return dict(b1=(times["delta"][0], times["delta"][1], bounds["delta"], by["delta"]),
                b2=(b2, b2p, b2_bound, lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    smi = phase0_device()
    b1_err = phase1_sweep(gen)
    b2_err = phase2_argmin(gen)
    launches, _ = phase3_main_path()
    phase4_full_variant()
    phase5_v0_v1()
    t = phase6_times(gen)
    kernels = [
        {"name": "metropolis_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/metropolis_sweep.cu",
         "replaces": "src/repro/kernels/metropolis_sweep.py:81",
         "launches": launches["metropolis_sweep"], "max_abs_err": b1_err,
         "ms": t["b1"][0], "plain_ms": t["b1"][1], "bound_ms": t["b1"][2],
         "bound_by": t["b1"][3], "library_ms": None},
        {"name": "argmin_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/reduce_min.cu",
         "replaces": "src/repro/kernels/reduce_min.py:24",
         "launches": launches["argmin_reduce"], "max_abs_err": b2_err,
         "ms": t["b2"][0], "plain_ms": t["b2"][1], "bound_ms": t["b2"][2],
         "bound_by": "bytes", "library_ms": t["b2"][3]},
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
