"""The port's telemetry (metrics, phase spans, event log, Perfetto trace)
against the reference's and against itself, on the CPU.

* Off: no span entered, no CUDA event recorded, nothing synchronised, no
  kernel build.  On: the same launches and no build, and every champion,
  ``champion_history`` and lifecycle stamp equal to the off run's, at
  K = 1 and 4, under preemption, migration, drain and resize on two
  shards.
* The event log is byte-equal to the reference engine's on the same
  seeded ``make_mix`` load with scripted preempt, drain and resize: the
  QAP mix as it stands, the continuous SA mix apart from the ``best_f`` of
  retire records (continuous f meets the parity contract of
  torch_parity.py, not bit equality).  The counters of plans, decisions,
  ticks, launches and tenant slot-ticks equal the reference's series.
* The trace validates against the port's ``trace_schema.json``, a byte
  copy of the reference's; the scenarios of the reference's
  ``tests/test_telemetry.py`` hold on the port.
"""
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.service import ArrivalProcess as JArrivals
from repro.service import EngineConfig as JConfig
from repro.service import EventLog as JEventLog
from repro.service import SAServeEngine as JEngine
from repro.service import Telemetry as JTelemetry
from repro.service import serve_sa as jserve_sa
from repro.service.telemetry import MetricsRegistry as JRegistry
from repro_torch.kernels import _build
from repro_torch.kernels import metropolis_sweep as ms
from repro_torch.kernels import qap_sweep as qs
from repro_torch.service import (ArrivalProcess, EngineConfig, EventLog,
                                 PhaseTimer, SARequest, SAServeEngine,
                                 SchedulerConfig, Telemetry, TICK_PHASES,
                                 TraceBuilder, kernel_builds, run_standalone,
                                 serve_sa, validate_trace)
from repro_torch.service.telemetry import Histogram, MetricsRegistry

CPS = 8
ROOT = Path(__file__).resolve().parents[1]


def _cfg(n_slots=4, n_devices=1, **kw):
    return EngineConfig(n_slots=n_slots, chains_per_slot=CPS,
                        n_devices=n_devices, device="cpu", **kw)


def _req(req_id, objective="rastrigin", dim=4, n_chains=CPS, seed=None,
         **kw):
    kw.setdefault("T0", 10.0)
    kw.setdefault("T_min", 1.0)
    kw.setdefault("rho", 0.7)
    kw.setdefault("N", 10)
    return SARequest(req_id=req_id, objective=objective, dim=dim,
                     n_chains=n_chains,
                     seed=100 + req_id if seed is None else seed, **kw)


def _mix(n=4):
    objs = ["rastrigin", "ackley", "griewank", "schwefel"]
    return [_req(i, objective=objs[i % len(objs)], priority=i % 2)
            for i in range(n)]


def _serve(telemetry=None, n=4, n_devices=1, **cfg_kw):
    engine = SAServeEngine(_cfg(n_devices=n_devices, **cfg_kw),
                           telemetry=telemetry)
    for r in _mix(n):
        engine.submit(r)
    results = engine.run(max_ticks=400)
    return engine, {r.req_id: r for r in results}


def _on():
    return Telemetry(trace=TraceBuilder(), events=EventLog())


def _assert_same_run(plain, traced):
    assert plain.keys() == traced.keys()
    for rid in plain:
        a, b = plain[rid], traced[rid]
        assert a.champion_history == b.champion_history
        assert a.f_best == b.f_best
        np.testing.assert_array_equal(a.x_best, b.x_best)
        assert (a.finish_tick, a.finish_reason, a.levels_run,
                a.preempted_ticks, a.resumed_ticks, a.migrated_ticks,
                a.shrink_events, a.home_shard) == \
            (b.finish_tick, b.finish_reason, b.levels_run,
             b.preempted_ticks, b.resumed_ticks, b.migrated_ticks,
             b.shrink_events, b.home_shard)


class _CudaSpy:
    """Counts CUDA events made and device-wide synchronisations."""

    def __init__(self, monkeypatch):
        self.events = self.syncs = 0
        spy = self

        class Event:
            def __init__(self, *a, **kw):
                spy.events += 1

            def record(self, *a):
                pass

            def synchronize(self):
                spy.syncs += 1

        def synchronize(*a):
            spy.syncs += 1

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "synchronize", synchronize)


class _SweepSpy:
    """Counts the sweeps of B1 and B3 (their plain versions on the CPU)."""

    def __init__(self, monkeypatch):
        self.calls = {"b1": 0, "b3": 0}
        for key, mod, name in (("b1", ms, "metropolis_sweep_plain"),
                               ("b3", qs, "qap_sweep_plain")):
            real = getattr(mod, name)

            def counted(*a, _real=real, _key=key, **kw):
                self.calls[_key] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(mod, name, counted)


def _mixed_load():
    """Continuous and QAP requests in one pool: both kernels run."""
    qap = [SARequest(req_id=10 + i, objective=inst, dim=n, n_chains=CPS,
                     seed=200 + i, family="permutation", T0=30.0, T_min=3.0,
                     rho=0.7, N=8)
           for i, (inst, n) in enumerate((("syn10", 10), ("grid12", 12)))]
    return _mix(4) + qap


def _serve_reqs(reqs, telemetry=None, **cfg_kw):
    engine = SAServeEngine(_cfg(**cfg_kw), telemetry=telemetry)
    for r in reqs:
        engine.submit(r)
    return engine, {r.req_id: r for r in engine.run()}


# ------------------------------------------------------------ disabled path
@pytest.mark.parametrize("k", [1, 4])
def test_disabled_enters_no_span_records_no_event_builds_nothing(
        monkeypatch, k):
    cuda = _CudaSpy(monkeypatch)
    spans, builds = PhaseTimer.spans_entered, kernel_builds()
    engine, results = _serve_reqs(_mixed_load(), macro_k=k)
    assert len(results) == 6
    assert PhaseTimer.spans_entered == spans
    assert (cuda.events, cuda.syncs) == (0, 0)
    assert kernel_builds() == builds
    assert engine.telemetry.enabled is False
    assert engine.telemetry.registry is None
    assert engine.stats()["phases"] == {}
    assert all(not s.phase_seconds for s in engine.shards)


@pytest.mark.parametrize("k", [1, 4])
def test_enabled_adds_no_launch_and_no_build(monkeypatch, k):
    sweeps = _SweepSpy(monkeypatch)
    b1, b3 = ms.counter.launches, qs.counter.launches
    _, plain = _serve_reqs(_mixed_load(), macro_k=k)
    off = dict(sweeps.calls)
    builds = kernel_builds()
    tel = _on()
    engine, traced = _serve_reqs(_mixed_load(), telemetry=tel, macro_k=k)
    on = {key: sweeps.calls[key] - off[key] for key in off}
    assert on == off and off["b1"] > 0 and off["b3"] > 0
    assert (ms.counter.launches, qs.counter.launches) == (b1, b3)
    assert kernel_builds() == builds
    assert tel.registry["sa_kernel_builds_total"].value() == 0
    assert tel.registry["sa_group_launches_total"].value() \
        == engine.group_launches
    _assert_same_run(plain, traced)


def test_kernel_builds_counts_library_loads(monkeypatch):
    """A load of the library moves the count once; a loaded one, never."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: Path("libsa.so"))

    class Handle:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Handle())
    before = kernel_builds()
    _build.lib()
    _build.lib()
    assert kernel_builds() == before + 1


# ------------------------------------------------------------- bit-exactness
@pytest.mark.parametrize("k", [1, 4])
def test_enabled_is_bit_exact_at_every_level(k):
    _, plain = _serve(macro_k=k)
    _, traced = _serve(_on(), macro_k=k)
    _assert_same_run(plain, traced)
    cfg = _cfg(macro_k=k)
    for req in _mix(4):
        solo = run_standalone(req, cfg)
        assert traced[req.req_id].f_best == solo.f_best
        assert traced[req.req_id].champion_history == solo.champion_history


def _elastic_serve(tel, k):
    """Two shards, preempt overload, a scripted preempt, migrate, drain and
    resize."""
    cfg = _cfg(n_slots=3, n_devices=2, macro_k=k, migration_budget=2,
               scheduler=SchedulerConfig(policy="priority",
                                         overload="preempt",
                                         preemption_budget=1))
    engine = SAServeEngine(cfg, telemetry=tel)
    reqs = [_req(i, priority=i % 3, on_overload="preempt", rho=0.8)
            for i in range(8)]

    def first_active(e):
        return min((j.req.req_id for _, j in e._iter_jobs()), default=None)

    def migrate():
        # Retried each tick until a move finds room.
        if not any(engine.migrate(j.req.req_id, s.index)
                   for _, j in engine._iter_jobs() for s in engine.live_shards):
            engine.schedule_op(engine.tick_count + 1, migrate)

    engine.schedule_op(4, lambda: engine.preempt(first_active(engine)))
    engine.schedule_op(8, migrate)
    engine.schedule_op(12, lambda: engine.drain(1))
    engine.schedule_op(20, lambda: engine.resize(3))
    arrivals = ArrivalProcess.poisson(reqs, rate=0.7, seed=7)
    res = {r.req_id: r for r in engine.run_stream(arrivals, max_ticks=400)}
    return engine, res


@pytest.mark.parametrize("k", [1, 4])
def test_enabled_is_bit_exact_under_preemption_migration_drain_resize(k):
    eng_off, plain = _elastic_serve(None, k)
    engine, traced = _elastic_serve(_on(), k)
    _assert_same_run(plain, traced)
    st = engine.stats()
    assert st["preemptions"] and st["migrations"] and st["shards_retired"]
    assert engine.retired_shards == eng_off.retired_shards
    assert len(engine.shards) == 3
    kinds = {r["event"] for r in engine.telemetry.events.records}
    assert {"admit", "preempt", "resume", "migrate", "drain",
            "shard_retired", "shard_added", "retire"} <= kinds
    for req_id, res in traced.items():
        assert res.completed
        solo = run_standalone(
            _req(req_id, priority=req_id % 3, on_overload="preempt",
                 rho=0.8), engine.cfg)
        assert res.champion_history == solo.champion_history


# ------------------------------------------------------------------ tracing
def test_trace_validates_against_the_schema():
    tel = Telemetry(trace=TraceBuilder())
    engine, results = _serve(tel, n_devices=2)
    doc = tel.trace.to_json()
    assert validate_trace(doc) == []
    phs = {e["ph"] for e in doc["traceEvents"]}
    assert {"X", "M", "b", "e"} <= phs
    tick_spans = [e for e in doc["traceEvents"] if e.get("cat") == "tick"]
    assert {e["name"] for e in tick_spans} <= set(TICK_PHASES)
    assert {e["tid"] for e in tick_spans} >= {0, 1, 2}
    for rid in results:
        evs = [e for e in doc["traceEvents"]
               if e.get("cat") == "request" and e.get("id") == rid]
        assert [e["ph"] for e in evs][0] == "b"
        assert [e["ph"] for e in evs][-1] == "e"
    assert validate_trace(json.loads(tel.trace.dumps())) == []


def test_trace_schema_rejects_malformed_events():
    assert validate_trace({"traceEvents": "nope"}) != []
    bad_ph = {"traceEvents": [
        {"ph": "Z", "name": "x", "pid": 0, "tid": 0}],
        "displayTimeUnit": "ms"}
    assert any("not in" in e for e in validate_trace(bad_ph))
    bad_phase = {"traceEvents": [
        {"ph": "X", "name": "warp", "cat": "tick", "pid": 0, "tid": 0,
         "ts": 0, "dur": 1}], "displayTimeUnit": "ms"}
    assert any("unknown tick phase" in e for e in validate_trace(bad_phase))


def test_trace_schema_is_the_reference_file():
    port = ROOT / "src/repro_torch/service/trace_schema.json"
    ref = ROOT / "src/repro/service/trace_schema.json"
    assert port.read_bytes() == ref.read_bytes()


# -------------------------------------------------------------- metrics
def test_phase_metrics_cover_the_taxonomy():
    tel = Telemetry()
    engine, _ = _serve(tel)
    snap = tel.registry.snapshot()
    phases = {k.split("=", 1)[1]
              for k in snap["sa_tick_phase_seconds"]["series"]}
    assert phases == set(TICK_PHASES)
    for summary in snap["sa_tick_phase_seconds"]["series"].values():
        assert summary["count"] > 0
        assert summary["p50"] <= summary["p90"] <= summary["p99"]
    assert snap["sa_ticks_total"]["series"][""] == engine.tick_count
    assert "sa_jax_compile_events_total" not in snap
    assert snap["sa_kernel_builds_total"]["series"][""] == 0
    st = engine.stats()
    assert set(st["phases"]["aggregate"]) == set(TICK_PHASES)
    assert st["phases"]["per_shard"]["0"]["dispatch"] > 0
    assert set(st["phases"]["per_shard"]["0"]) == \
        {"dispatch", "device_wait", "materialize"}


def test_phase_timer_tracks_host_cpu_alongside_wall():
    t = PhaseTimer(time.perf_counter)
    with t("dispatch", shard=0):
        sum(range(50_000))
    acc, shard_acc, raw, cpu = t.drain()
    assert set(cpu) == {"dispatch"} and set(shard_acc) == {(0, "dispatch")}
    assert 0.0 <= cpu["dispatch"] <= acc["dispatch"] + 1e-3
    assert raw == []
    assert t.drain() == ({}, {}, [], {})


def test_phase_cpu_metric_covers_host_phases_and_stats():
    tel = Telemetry()
    engine, _ = _serve(tel)
    cpu = engine.stats()["phases"]["cpu_seconds"]
    wall = {p: s["sum"]
            for p, s in engine.stats()["phases"]["aggregate"].items()}
    assert cpu["dispatch"] > 0
    assert cpu == {p: secs for (p,), secs
                   in tel.registry["sa_tick_phase_cpu_seconds_total"]
                   .series.items()}
    for phase, secs in cpu.items():
        assert secs <= wall[phase] + 1e-2


def test_metrics_survive_drain_and_resize():
    tel = Telemetry(events=EventLog())
    engine = SAServeEngine(_cfg(n_slots=2, n_devices=3, migration_budget=2),
                           telemetry=tel)
    for r in _mix(6):
        engine.submit(r)
    for _ in range(3):
        engine.tick()
    victim = max(s.index for s in engine.live_shards)
    engine.drain(victim)
    engine.run(max_ticks=400)
    assert any(i == victim for i, _ in engine.retired_shards)
    assert (str(victim),) in tel.registry["sa_shard_slots_used"].series
    assert {k for k in tel.registry["sa_shard_phase_seconds_total"].series
            if k[0] == str(victim)}
    decisions = tel.registry["sa_scheduler_decisions_total"]
    assert decisions.value("drain") == 1
    assert decisions.value("shard_retired") == 1
    assert {"admit", "drain", "shard_retired"} <= \
        {r["event"] for r in tel.events.records}
    engine.add_shards(1)
    assert decisions.value("shard_added") == 1


def _registry_ops(reg):
    c = reg.counter("requests_total", "Requests", ("status",))
    c.inc(3, "ok")
    c.inc(1, "err")
    g = reg.gauge("depth", "Queue depth", ("shard",))
    g.set(4, "0")
    g.inc(-1.5, "0")
    h = reg.histogram("latency_seconds", "Latency")
    for ms_ in range(1, 101):
        h.observe(ms_ / 1000.0)
    h.observe(2e-7)
    h.observe(5e3)
    return c, h


def test_prometheus_exposition_and_histogram_quantiles():
    reg = MetricsRegistry()
    c, h = _registry_ops(reg)
    assert h.quantile(0.5) == pytest.approx(0.050, rel=0.15)
    assert h.quantile(0.99) == pytest.approx(0.099, rel=0.15)
    assert h.summary()["count"] == 102
    assert math.isnan(Histogram("x", "").quantile(0.5))
    text = reg.exposition()
    assert '# TYPE requests_total counter' in text
    assert 'requests_total{status="ok"} 3' in text
    assert 'latency_seconds{quantile="0.5"}' in text
    assert 'latency_seconds_count 102' in text
    assert reg.counter("requests_total", labels=("status",)) is c
    with pytest.raises(ValueError):
        reg.gauge("requests_total")
    with pytest.raises(ValueError):
        c.inc(-1, "ok")
    # The same operations give the reference's exposition and snapshot.
    jreg = JRegistry()
    _registry_ops(jreg)
    assert text == jreg.exposition()
    assert json.dumps(reg.snapshot(), sort_keys=True) == \
        json.dumps(jreg.snapshot(), sort_keys=True)


# ------------------------------------------------------------- event log
def test_event_log_is_deterministic_and_replayable():
    def serve():
        tel = Telemetry(events=EventLog())
        cfg = _cfg(n_slots=2, n_devices=2, scheduler=SchedulerConfig(
            policy="priority", overload="preempt"))
        engine = SAServeEngine(cfg, telemetry=tel)
        reqs = [_req(i, priority=i % 3, on_overload="preempt")
                for i in range(5)]
        engine.run_stream(ArrivalProcess.poisson(reqs, rate=0.8, seed=3),
                          max_ticks=400)
        return tel.events

    log_a, log_b = serve(), serve()
    assert log_a.dumps() == log_b.dumps()
    records = EventLog.loads(log_a.dumps())
    assert records == log_a.records
    for rec in records:
        assert "wall" not in json.dumps(rec)
        assert rec["tick"] >= 0
    kinds = {r["event"] for r in records}
    assert "admit" in kinds and "retire" in kinds


# ------------------------------------------------ against the reference
_COUNTERS = ("sa_scheduler_plans_total", "sa_scheduler_decisions_total",
             "sa_ticks_total", "sa_group_launches_total",
             "sa_tenant_slot_ticks_total")


def _serve_with_events(pkg, family, k):
    """The seeded make_mix load on two shards of three slots, with a
    scripted preempt at tick 8, drain(1) at 12 and resize(3) at 20."""
    mix = (serve_sa if pkg == "port" else jserve_sa).make_mix(
        6, CPS, seed=1, family=family)
    if pkg == "port":
        tel = Telemetry(events=EventLog())
        eng = SAServeEngine(_cfg(n_slots=3, n_devices=2, macro_k=k,
                                 migration_budget=2), telemetry=tel)
    else:
        tel = JTelemetry(events=JEventLog())
        eng = JEngine(JConfig(n_slots=3, chains_per_slot=CPS, n_devices=2,
                              macro_k=k, migration_budget=2,
                              use_pallas=False), telemetry=tel)

    def preempt_first():
        rids = sorted(j.req.req_id for _, j in eng._iter_jobs())
        return bool(rids) and eng.preempt(rids[0])

    eng.schedule_op(8, preempt_first)
    eng.schedule_op(12, lambda: eng.drain(1))
    eng.schedule_op(20, lambda: eng.resize(3))
    arrivals = (ArrivalProcess if pkg == "port" else JArrivals).bursty(
        mix, rate=1.0, burst=4, seed=5)
    results = {r.req_id: r for r in eng.run_stream(arrivals)}
    return eng, tel, results


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("family", ["qap", "continuous"])
def test_event_log_and_counters_match_reference(family, k):
    eng, tel, got = _serve_with_events("port", family, k)
    jeng, jtel, ref = _serve_with_events("ref", family, k)
    kinds = {r["event"] for r in tel.events.records}
    assert {"admit", "preempt", "resume", "drain", "shard_retired",
            "shard_added", "retire"} <= kinds
    if family == "qap":
        assert tel.events.dumps() == jtel.events.dumps()
    else:
        # f is continuous: retire records carry best_f at parity tolerance.
        lines, jlines = tel.events.lines(), jtel.events.lines()
        assert len(lines) == len(jlines)
        for a, b in zip(EventLog.loads("\n".join(lines)),
                        EventLog.loads("\n".join(jlines))):
            fa, fb = a.pop("best_f", None), b.pop("best_f", None)
            assert json.dumps(a, sort_keys=True) == json.dumps(b,
                                                               sort_keys=True)
            if fa is not None:
                np.testing.assert_allclose(fa, fb, rtol=2e-3, atol=2e-3)
    for name in _COUNTERS:
        assert tel.registry[name].series == jtel.registry[name].series, name
    assert eng.tick_count == jeng.tick_count
    assert sorted(got) == sorted(ref)


# ----------------------------------------------------- macro-tick fusion
def test_macro_tick_disabled_telemetry_allocates_zero_spans():
    spans_before = PhaseTimer.spans_entered
    engine, results = _serve(macro_k=4)
    assert len(results) == 4
    assert PhaseTimer.spans_entered == spans_before
    assert engine.telemetry.enabled is False


def test_macro_tick_phases_cover_taxonomy_and_level_clock():
    tel = Telemetry()
    engine, _ = _serve(tel, macro_k=4)
    snap = tel.registry.snapshot()
    phases = {k.split("=", 1)[1]
              for k in snap["sa_tick_phase_seconds"]["series"]}
    assert phases == set(TICK_PHASES)
    for summary in snap["sa_tick_phase_seconds"]["series"].values():
        assert summary["count"] > 0
    assert snap["sa_ticks_total"]["series"][""] == engine.tick_count
    assert engine.group_launches < engine.tick_count


def test_macro_tick_event_log_deterministic_and_boundary_stamped():
    def serve():
        tel = Telemetry(events=EventLog())
        _serve(tel, macro_k=4)
        return tel.events

    log_a, log_b = serve(), serve()
    assert log_a.dumps() == log_b.dumps()
    records = EventLog.loads(log_a.dumps())
    assert {r["event"] for r in records} >= {"admit", "retire"}
    for rec in records:
        assert rec["tick"] % 4 == 0, "decision stamped off a boundary"


def test_macro_tick_trace_validates_and_is_bit_exact():
    tel = _on()
    _, plain = _serve(macro_k=4)
    _, traced = _serve(tel, macro_k=4)
    _assert_same_run(plain, traced)
    doc = tel.trace.to_json()
    assert validate_trace(doc) == []
    tick_spans = [e for e in doc["traceEvents"] if e.get("cat") == "tick"]
    assert {e["name"] for e in tick_spans} <= set(TICK_PHASES)


# ------------------------------------------------------------------ card
def test_cuda_device_wait_fences_each_launch(card):
    """On the card, telemetry on records one CUDA event per group launch
    and waits on each inside its shard's device_wait span; off records
    none."""
    real = torch.cuda.Event
    made = []

    def counting_event(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    torch.cuda.Event = counting_event
    try:
        cfg = EngineConfig(n_slots=4, chains_per_slot=64, n_devices=2)
        off = SAServeEngine(cfg)
        for r in _mix(4):
            off.submit(r)
        off.run()
        assert made == []
        tel = Telemetry()
        on = SAServeEngine(cfg, telemetry=tel)
        for r in _mix(4):
            on.submit(r)
        on.run()
    finally:
        torch.cuda.Event = real
    assert len(made) == on.group_launches > 0
    assert all(ev.query() for ev in made)
    assert {s for s, p in tel.registry["sa_shard_phase_seconds_total"].series
            if p == "device_wait"} == {"0", "1"}


@pytest.fixture
def card():
    """Decided here, not at import: the CUDA path runs only where there is
    a card (chip_smoke.py phase 14 drives it at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ------------------------------------------------------------------ CLI
def test_serve_sa_cli_trace_events_metrics(tmp_path, capsys):
    trace_p = tmp_path / "trace.json"
    events_p = tmp_path / "events.jsonl"
    metrics_p = tmp_path / "metrics.prom"
    rc = serve_sa.main([
        "--device", "cpu", "--requests", "3", "--slots", "2",
        "--chains-per-slot", "8", "--max-ticks", "200", "--json",
        "--trace", str(trace_p), "--events", str(events_p),
        "--metrics", str(metrics_p)])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["check"]["bit_exact"] == doc["check"]["served"] == 3
    assert "sa_tick_phase_seconds" in doc["metrics"]
    assert validate_trace(json.loads(trace_p.read_text())) == []
    assert len(EventLog.loads(events_p.read_text())) > 0
    assert "# TYPE sa_ticks_total counter" in metrics_p.read_text()
