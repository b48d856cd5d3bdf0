"""Command line of the PyTorch serving engine, the counterpart of
``repro.service.serve_sa`` for closed-loop plain-SA load.

Generates a deterministic heterogeneous request mix (the six registry
objectives over several dims and cooling schedules, QAP instances, or
both alternating) and serves it through the continuous-batching engine.
With ``--check`` (the default) every champion is compared with its
standalone single-tenant run, which placement invariance makes bit-exact;
with ``--json`` the run is reported as one JSON document.

Usage::

  python -m repro_torch.service.serve_sa --family qap --requests 16 \\
      --slots 8 --chains-per-slot 512 --macro-k 4        # on the card
  python -m repro_torch.service.serve_sa --device cpu --family mixed \\
      --requests 8 --slots 4 --chains-per-slot 16        # plain versions

The reference's other flags (open-loop arrivals, several shards, overload
policies, telemetry sinks, pt/pa methods, ...) are not ported yet and are
refused.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.service.engine import (EngineConfig, SAServeEngine,
                                        run_standalone)
from repro_torch.service.request import SARequest

#: The synthetic-load mix, as the reference's: (objective, dim) pairs
#: cycled over, crossed with a few cooling schedules.
MIX_PROBLEMS = [
    ("rastrigin", 8), ("ackley", 16), ("schwefel", 8), ("griewank", 32),
    ("exponential", 16), ("salomon", 8),
    ("rastrigin", 32), ("ackley", 8), ("schwefel", 16), ("griewank", 16),
]
MIX_SCHEDULES = [
    dict(T0=100.0, T_min=0.5, rho=0.85, N=40),
    dict(T0=50.0, T_min=0.2, rho=0.90, N=25),
    dict(T0=200.0, T_min=1.0, rho=0.80, N=60),
]
#: Permutation-family (QAP) load: built-in instances with their sizes, and
#: schedules scaled to swap-move deltas (tens, not thousands).
MIX_QAP_PROBLEMS = [("grid12", 12), ("syn10", 10)]
MIX_QAP_SCHEDULES = [
    dict(T0=50.0, T_min=0.5, rho=0.90, N=25),
    dict(T0=30.0, T_min=0.3, rho=0.88, N=20),
]


def make_mix(n_requests: int, chains_per_slot: int, seed: int = 0,
             max_slots_per_req: int = 2,
             family: str = "continuous") -> list:
    """Deterministic heterogeneous plain-SA request list, the same as the
    reference's ``make_mix(..., method="sa")``.

    ``family`` is 'continuous' (the six registry objectives), 'qap' (the
    built-in QAP instances) or 'mixed': continuous and QAP requests
    alternating in one slot pool."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        is_qap = family == "qap" or (family == "mixed" and i % 2 == 1)
        n_slots_i = 1 + int(rng.integers(0, max_slots_per_req))
        if is_qap:
            obj, dim = MIX_QAP_PROBLEMS[(i // 2) % len(MIX_QAP_PROBLEMS)] \
                if family == "mixed" else \
                MIX_QAP_PROBLEMS[i % len(MIX_QAP_PROBLEMS)]
            sched = MIX_QAP_SCHEDULES[i % len(MIX_QAP_SCHEDULES)]
            fam = "permutation"
        else:
            obj, dim = MIX_PROBLEMS[i % len(MIX_PROBLEMS)]
            sched = MIX_SCHEDULES[i % len(MIX_SCHEDULES)]
            fam = "continuous"
        reqs.append(SARequest(
            req_id=i, objective=obj, dim=dim,
            n_chains=n_slots_i * chains_per_slot,
            seed=seed * 1000 + i, priority=int(rng.integers(0, 3)),
            family=fam, **sched))
    return reqs


def _jsonable(obj):
    """Non-finite floats -> None, so --json is strict JSON."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    """Serve the mix; returns 0, or 1 when ``--check`` finds a champion
    that differs from its standalone run or a request left unserved."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=32,
                    help="number of requests in the synthetic mix")
    ap.add_argument("--slots", type=int, default=8,
                    help="slot-pool size (concurrent chain blocks)")
    ap.add_argument("--chains-per-slot", type=int, default=32,
                    help="chains per slot == kernel block size")
    ap.add_argument("--macro-k", type=int, default=1,
                    help="temperature levels per tick (1 = one level per "
                         "launch; bit-exact at any value)")
    ap.add_argument("--family", default="continuous",
                    choices=["continuous", "qap", "mixed"],
                    help="problem family of the mix: continuous, qap, or "
                         "mixed (alternating, co-batched in one pool)")
    ap.add_argument("--seed", type=int, default=0,
                    help="request-mix generator seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="emit one JSON document instead of the text report")
    ap.add_argument("--check", dest="check", action="store_true",
                    default=True,
                    help="compare every champion with a standalone run "
                         "(default)")
    ap.add_argument("--no-check", dest="check", action="store_false")
    args, rest = ap.parse_known_args(argv)
    if rest:
        ap.error(f"not ported to the PyTorch engine yet: {' '.join(rest)} "
                 "(see python -m repro.service.serve_sa --help)")

    cfg = EngineConfig(n_slots=args.slots,
                       chains_per_slot=args.chains_per_slot,
                       macro_k=args.macro_k, device=args.device)
    engine = SAServeEngine(cfg)
    reqs = make_mix(args.requests, args.chains_per_slot, seed=args.seed,
                    max_slots_per_req=min(2, args.slots), family=args.family)
    for req in reqs:
        engine.submit(req)
    results = engine.run()
    stats = engine.stats()

    by_id = {r.req_id: r for r in results}
    served = [req for req in reqs
              if req.req_id in by_id and by_id[req.req_id].completed]
    unserved = [req.req_id for req in reqs if req.req_id not in by_id]
    n_exact = 0
    mismatched = {}
    if args.check:
        for req in served:
            res = by_id[req.req_id]
            solo = run_standalone(req, cfg)
            if res.f_best == solo.f_best and np.array_equal(res.x_best,
                                                            solo.x_best):
                n_exact += 1
            else:
                mismatched[req.req_id] = (
                    f"req{req.req_id}: packed {res.f_best:+.5f}"
                    f" != standalone {solo.f_best:+.5f}")
    check_failed = args.check and (n_exact != len(served) or bool(unserved))

    if args.as_json:
        doc = {
            "config": {
                "requests": args.requests, "slots": args.slots,
                "chains_per_slot": args.chains_per_slot,
                "macro_k": args.macro_k, "family": args.family,
                "seed": args.seed, "device": str(engine.device),
            },
            "stats": stats,
            "results": [r.to_dict()
                        for r in sorted(results, key=lambda r: r.req_id)],
        }
        if args.check:
            doc["check"] = {"bit_exact": n_exact, "served": len(served),
                            "unserved_req_ids": unserved,
                            "mismatches": sorted(mismatched.values())}
        print(json.dumps(_jsonable(doc), indent=2, sort_keys=True,
                         allow_nan=False))
    else:
        print(f"[serve_sa] {stats['completed']}/{args.requests} requests in "
              f"{stats['ticks']} ticks, {stats['wall_s']:.2f}s on "
              f"{engine.device} | {stats['requests_per_s']:.2f} req/s, "
              f"{stats['sweeps_per_s']:.1f} sweeps/s, "
              f"{stats['chain_steps_per_s']:.3g} chain-steps/s | "
              f"occupancy {stats['occupancy']:.1%}")
        for req in served:
            res = by_id[req.req_id]
            line = (f"  req{req.req_id:>3} {req.objective:<10} d={req.dim:<3} "
                    f"f_best={res.f_best:+.5f} levels={res.levels_run} "
                    f"wait={res.queue_delay_ticks:.1f}t "
                    f"[{res.finish_reason}]")
            if args.check:
                line += ("  != standalone" if req.req_id in mismatched
                         else "  == standalone")
            print(line)
        if args.check:
            tail = f" ({len(unserved)} never served)" if unserved else ""
            print(f"[serve_sa] {n_exact}/{len(served)} champions bit-exact "
                  f"vs standalone{tail}")
            for rid in sorted(mismatched):
                print("  " + mismatched[rid])
    return 1 if check_failed else 0


if __name__ == "__main__":
    sys.exit(main())
