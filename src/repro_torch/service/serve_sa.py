"""Command line of the PyTorch serving engine, the counterpart of
``repro.service.serve_sa``.

Generates a deterministic heterogeneous request mix (the six registry
objectives over several dims and cooling schedules, QAP instances, or
both alternating) and serves it through the continuous-batching engine,
closed-loop (``--arrivals batch``, the whole queue at t=0) or open-loop
(``--arrivals poisson|bursty|diurnal`` at ``--rate`` requests per tick),
on one or several engine shards with the reference's overload policies,
migration, drain, resize, proactive degrade and completion deadlines.
With ``--check`` (the default) every champion is compared with its
standalone single-tenant run, replaying the request's recorded width
(``shrink_events``) and ladder (``truncate_events``) schedules, which
placement invariance makes bit-exact; with ``--json`` the run is reported
as one JSON document.

Usage::

  python -m repro_torch.service.serve_sa --family qap --requests 16 \\
      --slots 8 --chains-per-slot 512 --macro-k 4        # on the card
  python -m repro_torch.service.serve_sa --device cpu --family mixed \\
      --requests 8 --slots 4 --chains-per-slot 16        # plain versions
  python -m repro_torch.service.serve_sa --device cpu --devices 2 \\
      --slots 2 --chains-per-slot 8 --arrivals poisson --rate 1.0 \\
      --overload-policy preempt --finish-deadline-factor 1.5 --drain-at 6

Not ported yet, and refused with "not ported": the autoscaler
(``--autoscale`` and its ``--min-shards``/``--max-shards``/``--scale-*``
flags), ``--method pt|pa|mixed`` and the telemetry sinks (``--trace``,
``--events``, ``--metrics``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from repro_torch.service.arrivals import ArrivalProcess, latency_summary
from repro_torch.service.engine import (EngineConfig, SAServeEngine,
                                        run_standalone)
from repro_torch.service.request import SARequest
from repro_torch.service.scheduler import SchedulerConfig

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
             family: str = "continuous",
             finish_deadline_factor: float = None,
             min_levels_frac: float = 0.5) -> list:
    """Deterministic heterogeneous plain-SA request list, the same as the
    reference's ``make_mix(..., method="sa")``.

    ``family`` is 'continuous' (the six registry objectives), 'qap' (the
    built-in QAP instances) or 'mixed': continuous and QAP requests
    alternating in one slot pool.  ``finish_deadline_factor``, when set,
    gives every request a completion SLO of that many times its ladder
    length in ticks, with ``min_levels = max(1, min_levels_frac x
    n_levels)`` as the truncation floor."""
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
        req = SARequest(
            req_id=i, objective=obj, dim=dim,
            n_chains=n_slots_i * chains_per_slot,
            seed=seed * 1000 + i, priority=int(rng.integers(0, 3)),
            family=fam, **sched)
        if finish_deadline_factor is not None:
            req = dataclasses.replace(
                req,
                finish_deadline=finish_deadline_factor * req.n_levels,
                min_levels=max(1, int(min_levels_frac * req.n_levels)))
        reqs.append(req)
    return reqs


def make_arrivals(reqs, kind: str, rate: float, seed: int,
                  burst: int = 4, period: float = 200.0,
                  amplitude: float = 0.8) -> ArrivalProcess:
    """The arrival process ``kind`` ('batch', 'poisson', 'bursty' or
    'diurnal') over ``reqs``."""
    if kind == "poisson":
        return ArrivalProcess.poisson(reqs, rate=rate, seed=seed)
    if kind == "bursty":
        return ArrivalProcess.bursty(reqs, rate=rate, burst=burst, seed=seed)
    if kind == "diurnal":
        return ArrivalProcess.diurnal(reqs, rate=rate, period=period,
                                      amplitude=amplitude, seed=seed)
    return ArrivalProcess.batch(reqs)


def replay_check(req, res, cfg) -> bool:
    """Whether the completed ``res`` equals its standalone run bit for bit
    (``f_best``, ``x_best``, champion history and levels), replaying the
    admitted width and the recorded shrink and truncation schedules."""
    solo_req = req if res.admitted_chains >= req.n_chains else \
        dataclasses.replace(req, n_chains=res.admitted_chains)
    solo = run_standalone(
        solo_req, cfg,
        shrink_schedule=[(lvl, to) for lvl, _frm, to in res.shrink_events],
        truncate_schedule=[(lvl, to) for lvl, _frm, to
                           in res.truncate_events])
    return (res.f_best == solo.f_best
            and np.array_equal(res.x_best, solo.x_best)
            and res.champion_history == solo.champion_history
            and res.levels_run == solo.levels_run)


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
                    help="slot-pool size per shard (concurrent chain blocks)")
    ap.add_argument("--chains-per-slot", type=int, default=32,
                    help="chains per slot == kernel block size")
    ap.add_argument("--devices", type=int, default=1,
                    help="engine shards, each owning --slots slots; shards "
                         "share the cards round-robin")
    ap.add_argument("--macro-k", type=int, default=1,
                    help="temperature levels per tick (1 = one level per "
                         "launch; bit-exact at any value)")
    ap.add_argument("--migration-budget", type=int, default=1,
                    help="max cross-shard moves per tick: drain evacuation, "
                         "head defrag and watermark rebalancing share it")
    ap.add_argument("--drain-at", type=int, default=None,
                    help="tick at which to drain one shard (evacuate and "
                         "retire it mid-stream)")
    ap.add_argument("--drain-shard", type=int, default=None,
                    help="shard index for --drain-at (default: the "
                         "highest-index live shard at that tick)")
    ap.add_argument("--resize", action="append", default=None,
                    metavar="TICK:N",
                    help="resize the fleet to N live shards at TICK "
                         "(repeatable; composes drain/add)")
    ap.add_argument("--high-watermark", type=float, default=1.0,
                    help="shard utilization above which the background "
                         "rebalancer moves work off (1.0 disables)")
    ap.add_argument("--low-watermark", type=float, default=0.0,
                    help="shard utilization below which a shard may "
                         "receive rebalanced work (0.0 disables)")
    ap.add_argument("--proactive-degrade", action="store_true",
                    help="shrink running degrade-class jobs (down to "
                         "min_chains) when the queue head fits nowhere")
    ap.add_argument("--shrink-budget", type=int, default=1,
                    help="max proactive shrinks per tick")
    ap.add_argument("--finish-deadline-factor", type=float, default=None,
                    metavar="F",
                    help="completion SLO of every request: finish within F "
                         "x its ladder length in ticks (the ladder is "
                         "truncated, never below --min-levels-frac of it)")
    ap.add_argument("--min-levels-frac", type=float, default=0.5,
                    help="ladder-truncation floor as a fraction of each "
                         "request's ladder length")
    ap.add_argument("--method", default="sa",
                    choices=["sa", "pt", "pa", "mixed"],
                    help="workload class of the mix; only sa is ported")
    ap.add_argument("--family", default="continuous",
                    choices=["continuous", "qap", "mixed"],
                    help="problem family of the mix: continuous, qap, or "
                         "mixed (alternating, co-batched in one pool)")
    ap.add_argument("--variant", default="delta", choices=["delta", "full"],
                    help="continuous sweep: O(1) delta or O(dim) full")
    ap.add_argument("--seed", type=int, default=0,
                    help="request-mix generator seed")
    ap.add_argument("--policy", default="priority",
                    choices=["priority", "fifo"],
                    help="admission policy (priority is aged)")
    ap.add_argument("--max-slots-per-req", type=int, default=2,
                    help="largest request footprint in the mix, in slots")
    ap.add_argument("--overload-policy", default="none",
                    choices=["none", "reject", "degrade", "preempt"],
                    help="scheduler-wide overload policy; per-request "
                         "on_overload overrides it")
    ap.add_argument("--deadline", type=float, default=None,
                    help="queueing-delay SLO in ticks for reject/degrade")
    ap.add_argument("--preemption-budget", type=int, default=1,
                    help="max preemptions (swap-outs) per tick")
    ap.add_argument("--arrivals", default="batch",
                    choices=["batch", "poisson", "bursty", "diurnal"],
                    help="closed-loop batch, or an open-loop Poisson, "
                         "bursty or diurnal stream at --rate")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="offered load of open-loop arrivals, requests/tick")
    ap.add_argument("--burst", type=int, default=4,
                    help="burst size for --arrivals bursty")
    ap.add_argument("--period", type=float, default=200.0,
                    help="diurnal cycle length in ticks")
    ap.add_argument("--amplitude", type=float, default=0.8,
                    help="diurnal intensity swing in [0, 1]")
    ap.add_argument("--arrival-seed", type=int, default=0,
                    help="seed of the arrival timeline")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="hard tick budget (default: run to drain)")
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
    if rest or args.method != "sa":
        what = " ".join(rest) if rest else f"--method {args.method}"
        ap.error(f"not ported to the PyTorch engine yet: {what} "
                 "(see python -m repro.service.serve_sa --help)")
    if args.overload_policy in ("reject", "degrade") and args.deadline is None:
        ap.error(f"--overload-policy {args.overload_policy} requires "
                 "--deadline (the queueing-delay SLO it enforces)")
    if args.drain_at is not None and args.devices < 2:
        ap.error("--drain-at needs --devices >= 2 (the survivors absorb "
                 "the drained shard's work)")
    resizes = []
    for spec in args.resize or []:
        try:
            t_str, n_str = spec.split(":")
            resizes.append((int(t_str), int(n_str)))
        except ValueError:
            ap.error(f"--resize expects TICK:N, got {spec!r}")
        if resizes[-1][1] < 1:
            ap.error(f"--resize target must be >= 1 shard, got {spec!r}")

    cfg = EngineConfig(
        n_slots=args.slots, chains_per_slot=args.chains_per_slot,
        n_devices=args.devices, variant=args.variant, macro_k=args.macro_k,
        migration_budget=args.migration_budget, device=args.device,
        scheduler=SchedulerConfig(policy=args.policy,
                                  overload=args.overload_policy,
                                  default_deadline=args.deadline,
                                  preemption_budget=args.preemption_budget,
                                  high_watermark=args.high_watermark,
                                  low_watermark=args.low_watermark,
                                  proactive_degrade=args.proactive_degrade,
                                  shrink_budget=args.shrink_budget))
    engine = SAServeEngine(cfg)
    # Scripted fleet changes land on the deterministic tick axis.
    for t, n in sorted(resizes):
        engine.schedule_op(t, lambda n=n: engine.resize(n))
    if args.drain_at is not None:
        def _drain():
            target = args.drain_shard if args.drain_shard is not None \
                else max(s.index for s in engine.live_shards)
            engine.drain(target)
        engine.schedule_op(args.drain_at, _drain)
    reqs = make_mix(args.requests, args.chains_per_slot, seed=args.seed,
                    max_slots_per_req=min(args.max_slots_per_req, args.slots),
                    family=args.family,
                    finish_deadline_factor=args.finish_deadline_factor,
                    min_levels_frac=args.min_levels_frac)
    arrivals = make_arrivals(reqs, args.arrivals, args.rate,
                             args.arrival_seed, burst=args.burst,
                             period=args.period, amplitude=args.amplitude)
    results = engine.run_stream(arrivals, max_ticks=args.max_ticks)
    stats = engine.stats()
    lat = latency_summary(results, ticks=engine.tick_count,
                          n_submitted=engine.n_submitted)

    by_id = {r.req_id: r for r in results}
    served = [req for req in reqs
              if req.req_id in by_id and by_id[req.req_id].completed]
    rejected_ids = sorted(r.req_id for r in results if not r.completed)
    unserved = [req.req_id for req in reqs if req.req_id not in by_id]
    n_exact = 0
    mismatched = {}
    if args.check:
        for req in served:
            res = by_id[req.req_id]
            if replay_check(req, res, cfg):
                n_exact += 1
            else:
                mismatched[req.req_id] = (
                    f"req{req.req_id}: packed {res.f_best:+.5f} differs "
                    "from its standalone replay")
    # A run that left requests unserved (--max-ticks) fails the check:
    # rejection is a terminal status, a coverage hole is not.
    check_failed = args.check and (n_exact != len(served) or bool(unserved))

    if args.as_json:
        doc = {
            "config": {
                "requests": args.requests, "slots": args.slots,
                "chains_per_slot": args.chains_per_slot,
                "devices": args.devices, "macro_k": args.macro_k,
                "migration_budget": args.migration_budget,
                "drain_at": args.drain_at, "drain_shard": args.drain_shard,
                "resize": sorted(resizes),
                "high_watermark": args.high_watermark,
                "low_watermark": args.low_watermark,
                "proactive_degrade": args.proactive_degrade,
                "shrink_budget": args.shrink_budget,
                "method": args.method, "family": args.family,
                "variant": args.variant, "policy": args.policy,
                "overload_policy": args.overload_policy,
                "deadline": args.deadline,
                "preemption_budget": args.preemption_budget,
                "seed": args.seed, "arrivals": args.arrivals,
                "rate": args.rate, "burst": args.burst,
                "period": args.period, "amplitude": args.amplitude,
                "arrival_seed": args.arrival_seed,
                "finish_deadline_factor": args.finish_deadline_factor,
                "min_levels_frac": args.min_levels_frac,
                "device": str(engine.device),
            },
            "stats": stats,
            "latency": lat,
            "results": [r.to_dict()
                        for r in sorted(results, key=lambda r: r.req_id)],
        }
        if args.check:
            doc["check"] = {"bit_exact": n_exact, "served": len(served),
                            "rejected_req_ids": rejected_ids,
                            "unserved_req_ids": unserved,
                            "mismatches": sorted(mismatched.values())}
        print(json.dumps(_jsonable(doc), indent=2, sort_keys=True,
                         allow_nan=False))
        return 1 if check_failed else 0
    print(f"[serve_sa] {stats['completed']}/{args.requests} requests in "
          f"{stats['ticks']} ticks, {stats['wall_s']:.2f}s on "
          f"{engine.device} | {stats['requests_per_s']:.2f} req/s, "
          f"{stats['sweeps_per_s']:.1f} sweeps/s, "
          f"{stats['chain_steps_per_s']:.3g} chain-steps/s | "
          f"occupancy {stats['occupancy']:.1%}")
    if args.devices > 1 or stats["shards_retired"]:
        shard_util = " ".join(f"{u:.0%}" for u in stats["shard_occupancy"])
        print(f"[serve_sa] {stats['devices']} shards x {args.slots} slots "
              f"(started with {args.devices}): per-shard utilization "
              f"[{shard_util}], {stats['migrations']} migrations")
    if stats["shards_retired"] or stats["draining"] or stats["shrinks"]:
        retired = ", ".join(f"shard {i} at tick {t}"
                            for i, t in engine.retired_shards)
        print(f"[serve_sa] elastic fleet: {stats['shards_retired']} retired "
              f"({retired or 'none'}), {stats['draining']} still draining, "
              f"{stats['shrinks']} shrinks")
    if stats["truncations"]:
        print(f"[serve_sa] completion SLO: {stats['truncations']} ladder "
              f"truncations across "
              f"{sum(1 for r in results if r.truncated)} requests")
    if lat["incomplete"]:
        print(f"[serve_sa] {lat['incomplete']} requests still in flight or "
              "queued at the --max-ticks horizon (not rejected)")
    if args.arrivals != "batch":
        print(f"[serve_sa] open loop @ {args.rate} req/tick: queue delay "
              f"p50/p99 = {lat['queue_delay_p50']:.1f}/"
              f"{lat['queue_delay_p99']:.1f} ticks, ttft p50/p99 = "
              f"{lat['ttft_p50']:.1f}/{lat['ttft_p99']:.1f} ticks, goodput "
              f"{lat['goodput_req_per_tick']:.3f} req/tick")
    if args.overload_policy != "none" or stats["rejected"] \
            or stats["preemptions"]:
        print(f"[serve_sa] overload policy '{args.overload_policy}': "
              f"{stats['rejected']} rejected, "
              f"{stats['preemptions']} preemptions")
    for req in served:
        res = by_id[req.req_id]
        line = (f"  req{req.req_id:>3} {req.objective:<10} d={req.dim:<3} "
                f"f_best={res.f_best:+.5f} levels={res.levels_run} "
                f"wait={res.queue_delay_ticks:.1f}t [{res.finish_reason}]")
        if res.n_preemptions:
            line += f" preempted x{res.n_preemptions}"
        if res.n_migrations:
            line += f" migrated x{res.n_migrations}"
        if res.n_shrinks:
            line += (f" shrunk x{res.n_shrinks} ({res.admitted_chains}->"
                     f"{res.granted_chains} chains)")
        if res.truncated:
            line += (f" truncated x{res.n_truncations} "
                     f"({res.truncate_events[0][1]}->"
                     f"{res.truncate_events[-1][2]} levels)")
        elif res.degraded:
            line += (f" degraded {res.granted_chains}/"
                     f"{res.requested_chains} chains")
        if args.check:
            line += ("  != standalone" if req.req_id in mismatched
                     else "  == standalone")
        print(line)
    for rid in rejected_ids:
        res = by_id[rid]
        print(f"  req{rid:>3} {res.objective:<10} d={res.dim:<3} REJECTED at "
              f"tick {res.finish_tick} (queued "
              f"{res.finish_tick - res.submit_tick}t)")
    if args.check:
        tail = f" ({len(unserved)} never served)" if unserved else ""
        print(f"[serve_sa] {n_exact}/{len(served)} champions bit-exact vs "
              f"standalone{tail}")
        for rid in sorted(mismatched):
            print("  " + mismatched[rid])
    return 1 if check_failed else 0


if __name__ == "__main__":
    sys.exit(main())
