"""Open-loop serving in the port: the arrival processes and latency
summaries against ``repro.service.arrivals``, ``run_stream``'s tick clock
and lifecycle stamps, scripted operations, and the ``serve_sa`` CLI with
the flags of the elastic slice, on the CPU."""
import json
import math
import types
import time as _time

import numpy as np
import pytest

from repro.service import arrivals as jarr
from repro.service import request as jrequest
from repro_torch.service import arrivals as tarr
from repro_torch.service import engine as tengine
from repro_torch.service import serve_sa
from repro_torch.service.engine import EngineConfig, SAServeEngine
from repro_torch.service.request import SARequest

CPS = 8


def _req(req_id, **kw):
    kw.setdefault("objective", "rastrigin")
    kw.setdefault("dim", 4)
    kw.setdefault("n_chains", CPS)
    kw.setdefault("T0", 50.0)
    kw.setdefault("T_min", 1.0)
    kw.setdefault("rho", 0.8)
    kw.setdefault("N", 10)
    return SARequest(req_id=req_id, seed=100 + req_id, **kw)


def _cfg(n_slots=4, **kw):
    return EngineConfig(n_slots=n_slots, chains_per_slot=CPS, device="cpu",
                        **kw)


# ------------------------------------------------------- arrival processes
_KINDS = {
    "poisson": lambda mod, reqs, seed: mod.ArrivalProcess.poisson(
        reqs, rate=0.7, seed=seed),
    "bursty": lambda mod, reqs, seed: mod.ArrivalProcess.bursty(
        reqs, rate=1.5, burst=3, seed=seed),
    "diurnal": lambda mod, reqs, seed: mod.ArrivalProcess.diurnal(
        reqs, rate=0.4, period=30.0, amplitude=0.9, seed=seed),
    "trace": lambda mod, reqs, seed: mod.ArrivalProcess.trace(
        reqs, np.random.default_rng(seed).uniform(0, 20, len(reqs))),
    "batch": lambda mod, reqs, seed: mod.ArrivalProcess.batch(reqs),
}


def _drain(arrivals, horizon):
    """Pop the stream tick by tick: [(tick, [(time, req_id), ...])]."""
    out = []
    for tick in range(horizon):
        got = arrivals.due(tick)
        if got:
            out.append((tick, [(t, r.req_id) for t, r in got]))
        out.append(("next", arrivals.next_time, arrivals.exhausted))
    return out


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_arrivals_match_reference(kind, seed):
    reqs = [_req(i) for i in range(13)]
    port = _KINDS[kind](tarr, reqs, seed)
    ref = _KINDS[kind](jarr, reqs, seed)
    assert len(port) == len(ref) == 13
    assert _drain(port, 60) == _drain(ref, 60)
    assert port.exhausted and ref.exhausted


@pytest.mark.parametrize("ctor", [
    lambda m: m.ArrivalProcess([_req(0)], [0.0, 1.0]),
    lambda m: m.ArrivalProcess.poisson([_req(0)], rate=0.0),
    lambda m: m.ArrivalProcess.bursty([_req(0)], rate=-1.0),
    lambda m: m.ArrivalProcess.bursty([_req(0)], rate=1.0, burst=0),
    lambda m: m.ArrivalProcess.diurnal([_req(0)], rate=0.0),
    lambda m: m.ArrivalProcess.diurnal([_req(0)], rate=1.0, period=0.0),
    lambda m: m.ArrivalProcess.diurnal([_req(0)], rate=1.0, amplitude=1.5),
])
def test_arrival_validation_matches_reference(ctor):
    with pytest.raises(ValueError) as ref_err:
        ctor(jarr)
    with pytest.raises(ValueError) as port_err:
        ctor(tarr)
    assert str(port_err.value) == str(ref_err.value)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


def test_latency_summary_and_percentile_match_reference():
    reqs = [_req(i, rho=0.6, priority=i % 3) for i in range(7)]
    engine = SAServeEngine(_cfg(n_slots=2, scheduler=tengine.SchedulerConfig(
        overload="reject", default_deadline=6.0)))
    results = engine.run_stream(tarr.ArrivalProcess.poisson(reqs, rate=1.2,
                                                            seed=2))
    assert any(r.status == "rejected" for r in results)
    for kw in ({}, {"ticks": engine.tick_count},
               {"ticks": engine.tick_count, "n_submitted": 9}):
        _same(tarr.latency_summary(results, **kw),
              jarr.latency_summary(results, **kw))
    _same(tarr.latency_summary([], ticks=3), jarr.latency_summary([], ticks=3))
    vals = [3.0, float("nan"), 1.0, float("inf"), 2.5]
    for q in (0, 50, 99, 100):
        assert tarr.percentile(vals, q) == jarr.percentile(vals, q)
    assert math.isnan(tarr.percentile([], 50))


# ---------------------------------------------------------- run_stream
def test_run_stream_serves_all_and_stamps_lifecycle():
    reqs = [_req(i) for i in range(6)]
    engine = SAServeEngine(_cfg(n_slots=2))
    results = engine.run_stream(
        tarr.ArrivalProcess.poisson(reqs, rate=0.3, seed=1), max_ticks=2000)
    assert {r.req_id for r in results} == set(range(6))
    for r in results:
        assert r.arrival_time > 0.0
        assert r.start_tick >= r.arrival_time - 1
        assert r.first_tick == r.start_tick
        assert r.finish_tick > r.first_tick
        assert r.latency_ticks >= r.ttft_ticks >= r.queue_delay_ticks >= 0.0
        assert 0.0 <= r.submit_wall <= r.admit_wall
        assert r.admit_wall <= r.first_tick_wall <= r.finish_wall


def test_run_stream_idles_until_late_arrival():
    engine = SAServeEngine(_cfg(n_slots=2))
    results = engine.run_stream(tarr.ArrivalProcess.trace([_req(0)], [10.0]),
                                max_ticks=500)
    assert len(results) == 1
    assert results[0].start_tick >= 10
    assert results[0].queue_delay_ticks < 2.0


@pytest.mark.parametrize("k", [1, 4])
def test_run_stream_tick_metrics_deterministic(k):
    def one_run():
        reqs = serve_sa.make_mix(6, CPS, seed=0, family="qap")
        engine = SAServeEngine(_cfg(n_slots=4, macro_k=k))
        engine.run_stream(tarr.ArrivalProcess.poisson(reqs, rate=0.5, seed=3),
                          max_ticks=3000)
        summary = tarr.latency_summary(engine.results, ticks=engine.tick_count)
        return summary, sorted((r.req_id, r.arrival_time, r.start_tick,
                                r.first_tick, r.finish_tick, r.f_best)
                               for r in engine.results)

    (s1, p1), (s2, p2) = one_run(), one_run()
    assert p1 == p2 and len(p1) == 6
    _same(*({k: v for k, v in s.items() if "wall" not in k}
            for s in (s1, s2)))


def test_run_stream_never_reads_the_wall_clock(monkeypatch):
    """Every wall stamp comes from the monotonic epoch; a decision that
    read ``time.time`` would raise."""
    def bomb():
        raise AssertionError("engine consulted the adjustable wall clock")

    monkeypatch.setattr(
        tengine, "time",
        types.SimpleNamespace(perf_counter=_time.perf_counter, time=bomb))
    engine = SAServeEngine(_cfg(n_slots=2, n_devices=2, migration_budget=2))
    engine.schedule_op(3, lambda: engine.drain(1))
    results = engine.run_stream(tarr.ArrivalProcess.poisson(
        [_req(i, T0=8.0, rho=0.5) for i in range(4)], rate=1.0, seed=0))
    assert len(results) == 4 and all(r.completed for r in results)
    assert 0.0 <= engine.wall_s < 600.0
    assert engine.wall_s >= max(r.finish_wall - r.submit_wall
                                for r in results)
    assert engine.stats()["sweeps_per_s"] > 0.0


def test_max_ticks_cutoff_reports_incomplete_not_rejected():
    engine = SAServeEngine(_cfg(n_slots=1))
    engine.run_stream(tarr.ArrivalProcess.batch(
        [_req(i, T0=8.0, rho=0.9) for i in range(6)]), max_ticks=5)
    s = tarr.latency_summary(engine.results, ticks=engine.tick_count,
                             n_submitted=engine.n_submitted)
    assert s["completed"] == s["rejected"] == 0 and s["incomplete"] == 6


def test_scheduled_ops_fire_on_their_tick_across_idle_jumps():
    """An op lands on its exact tick even when run_stream fast-forwards
    through idle time, and several ops of one tick run in order."""
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=3))
    seen = []
    engine.schedule_op(5, lambda: seen.append(("a", engine.tick_count)))
    engine.schedule_op(5, lambda: engine.resize(2))
    engine.schedule_op(9, lambda: seen.append(("b", engine.tick_count)))
    engine.schedule_op(2, lambda: seen.append(("c", engine.tick_count)))
    results = engine.run_stream(
        tarr.ArrivalProcess.trace([_req(0, T0=8.0, rho=0.5)], [12.0]),
        max_ticks=100)
    assert seen == [("c", 2), ("a", 5), ("b", 9)]
    assert len(engine.shards) == 2
    assert results[0].completed and results[0].start_tick >= 12


# ------------------------------------------------------------------- CLI
_ELASTIC_ARGV = ["--device", "cpu", "--devices", "2", "--arrivals", "poisson",
                 "--rate", "1.0", "--overload-policy", "preempt",
                 "--finish-deadline-factor", "1.5", "--drain-at", "6",
                 "--macro-k", "2", "--check", "--requests", "6",
                 "--slots", "2", "--chains-per-slot", str(CPS),
                 "--family", "qap"]


def test_serve_sa_elastic_cli_check_passes(capsys):
    assert serve_sa.main(_ELASTIC_ARGV) == 0
    out = capsys.readouterr().out
    assert "6/6 champions bit-exact vs standalone" in out
    assert "elastic fleet: 1 retired (shard 1 at tick" in out
    assert "ladder truncations" in out


def test_serve_sa_json_tick_clock_fields_repeat(capsys):
    def strip_wall(doc):
        doc["stats"] = {k: v for k, v in doc["stats"].items()
                        if "wall" not in k and not k.endswith("_per_s")}
        doc["latency"] = {k: v for k, v in doc["latency"].items()
                          if "wall" not in k}
        for r in doc["results"]:
            for k in [k for k in r if k.endswith("_wall_s")]:
                del r[k]
        return doc

    docs = []
    for _ in range(2):
        assert serve_sa.main(_ELASTIC_ARGV + ["--json", "--resize", "10:2"]) == 0
        docs.append(strip_wall(json.loads(capsys.readouterr().out)))
    assert docs[0] == docs[1]
    doc = docs[0]
    assert doc["check"]["bit_exact"] == doc["check"]["served"] == 6
    assert doc["stats"]["shards_retired"] == 1 and doc["config"]["devices"] == 2
    assert doc["latency"]["completed"] == 6
    assert [r["req_id"] for r in doc["results"]] == list(range(6))


def test_make_mix_and_arrivals_match_reference():
    from repro.service.serve_sa import make_arrivals as jarrivals
    from repro.service.serve_sa import make_mix as jmix
    kw = dict(seed=4, family="mixed", finish_deadline_factor=1.5,
              min_levels_frac=0.5)
    mix = serve_sa.make_mix(10, CPS, **kw)
    jm = jmix(10, CPS, **kw)
    assert [r.finish_deadline for r in mix] == [r.finish_deadline for r in jm]
    assert [r.min_levels for r in mix] == [r.min_levels for r in jm]
    for kind in ("batch", "poisson", "bursty", "diurnal"):
        a = serve_sa.make_arrivals(mix, kind, 0.8, 3, burst=3, period=40.0,
                                   amplitude=0.5)
        b = jarrivals(jm, kind, 0.8, 3, burst=3, period=40.0, amplitude=0.5)
        assert _drain(a, 40) == _drain(b, 40)
    assert isinstance(jm[0], jrequest.SARequest)


@pytest.mark.parametrize("flags", [
    ["--autoscale"], ["--min-shards", "1"], ["--scale-cooldown", "8"],
    ["--method", "pt"], ["--method", "mixed"], ["--trace", "t.json"],
    ["--events", "e.jsonl"], ["--metrics", "m.prom"],
])
def test_serve_sa_refuses_flags_not_ported(flags, capsys):
    with pytest.raises(SystemExit) as err:
        serve_sa.main(["--device", "cpu", "--requests", "1"] + flags)
    assert err.value.code == 2
    assert "not ported" in capsys.readouterr().err
