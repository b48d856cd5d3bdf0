"""The port's elastic engine: preemption, migration, drain, resize,
proactive degrade and ladder truncation, on the CPU.

* QAP-only open-loop streams give ``RequestResult``s equal to the
  reference engine's in every field but the wall-clock ones, and equal
  ``stats()`` counters (QAP costs are exact in any order).  Mixed streams
  without a ``target_error`` make the same decisions; continuous champions
  meet the parity contract of torch_parity.py.
* Against its own ``run_standalone`` with replayed width and ladder
  schedules the port is bit-exact: preempt, migrate, drain, degrade and
  truncate at every level, the drain that shrinks a wide job into the
  survivor, and operator actions at macro-tick boundaries for K in
  {2, 4, 8} against K = 1.  The reference's own runs of the last two
  differ (ROADMAP, faults C); the port's must not.
* Guards and invariants: refusals, the last-live-shard guard, stable
  shard indices, no leaked slot or rid, one terminal result per request.
"""
import dataclasses

import numpy as np
import pytest

from repro.service import ArrivalProcess as JArrivals
from repro.service import EngineConfig as JConfig
from repro.service import SAServeEngine as JEngine
from repro.service import request as jrequest
from repro.service import scheduler as jsched
from repro_torch.service import SchedulerConfig
from repro_torch.service.arrivals import ArrivalProcess
from repro_torch.service.engine import EngineConfig, SAServeEngine, run_standalone
from repro_torch.service.request import SARequest

CPS = 8
_WALL = {"submit_wall", "admit_wall", "first_tick_wall", "finish_wall"}


def _req(req_id, **kw):
    kw.setdefault("objective", "rastrigin")
    kw.setdefault("dim", 4)
    kw.setdefault("n_chains", CPS)
    kw.setdefault("T0", 50.0)
    kw.setdefault("T_min", 1.0)
    kw.setdefault("rho", 0.55)  # 7-level ladder
    kw.setdefault("N", 10)
    return SARequest(req_id=req_id, seed=100 + req_id, **kw)


def _cfg(n_slots=2, n_devices=2, **kw):
    return EngineConfig(n_slots=n_slots, chains_per_slot=CPS,
                        n_devices=n_devices, device="cpu", **kw)


def _assert_bit_exact(res, solo):
    assert res.f_best == solo.f_best
    np.testing.assert_array_equal(res.x_best, solo.x_best)
    assert res.levels_run == solo.levels_run
    assert res.champion_history == solo.champion_history


def _assert_no_leaks(engine):
    for shard in engine.shards:
        assert shard.pool.n_free == shard.pool.n_slots
        assert np.all(shard.pool.owner == -1)
        assert not shard.rids.jobs


def _home_of(engine, req_id):
    return {j.req.req_id: j for _, j in engine._iter_jobs()}[req_id].home_shard


def _replay(res, req, cfg):
    if res.admitted_chains < req.n_chains:
        req = dataclasses.replace(req, n_chains=res.admitted_chains)
    return run_standalone(
        req, cfg,
        shrink_schedule=[(lvl, to) for lvl, _, to in res.shrink_events],
        truncate_schedule=[(lvl, to) for lvl, _, to in res.truncate_events])


# ------------------------------------------- against the reference engine
def _stream_reqs(family):
    """14 seeded requests of one or two slots, some degrade-class, some
    with a completion deadline tight enough to truncate."""
    rs = np.random.default_rng(0)
    out = []
    for i in range(14):
        w = int(rs.integers(1, 3))
        common = dict(
            req_id=i, n_chains=w * CPS, seed=100 + i,
            priority=int(rs.integers(0, 3)),
            min_chains=CPS if i % 3 else None,
            on_overload="degrade" if i % 4 == 0 else None,
            finish_deadline=14.0 if i % 3 == 0 else None,
            min_levels=5 if i % 3 == 0 else 1)
        if family == "qap" or i % 2:
            inst = ("syn10", "grid12")[i % 2]
            out.append(dict(common, objective=inst, dim=10 + 2 * (i % 2),
                            family="permutation", T0=30.0, T_min=0.5,
                            rho=0.7, N=8))
        else:
            out.append(dict(common, objective=("rastrigin", "ackley")[i % 4 // 2],
                            dim=4, T0=20.0, T_min=1.0, rho=0.7, N=4))
    return out


def _serve_both(family, k, policy):
    sc = dict(overload=policy, preemption_budget=2, proactive_degrade=True,
              high_watermark=0.75, low_watermark=0.3,
              default_deadline=6.0 if policy in ("reject", "degrade") else None)
    kw = _stream_reqs(family)
    runs = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            eng = SAServeEngine(EngineConfig(
                n_slots=3, chains_per_slot=CPS, n_devices=2, macro_k=k,
                migration_budget=2, device="cpu",
                scheduler=SchedulerConfig(**sc)))
            arr = ArrivalProcess.poisson([SARequest(**r) for r in kw],
                                         rate=0.8, seed=1)
        else:
            eng = JEngine(JConfig(
                n_slots=3, chains_per_slot=CPS, n_devices=2, macro_k=k,
                migration_budget=2, use_pallas=False,
                scheduler=jsched.SchedulerConfig(**sc)))
            arr = JArrivals.poisson([jrequest.SARequest(**r) for r in kw],
                                    rate=0.8, seed=1)
        eng.schedule_op(8, lambda e=eng: e.drain(1))
        eng.schedule_op(16, lambda e=eng: e.resize(3))
        runs.append((eng, {r.req_id: r for r in eng.run_stream(arr)}))
    return runs


_COUNTERS = ("ticks", "devices", "draining", "shards_retired",
             "group_launches", "submitted", "completed", "rejected",
             "preemptions", "migrations", "shrinks", "truncations", "sweeps",
             "occupancy", "shard_occupancy")


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("policy", ["preempt", "degrade", "reject"])
def test_qap_stream_matches_reference_engine(k, policy):
    (eng, got), (jeng, ref) = _serve_both("qap", k, policy)
    assert sorted(got) == sorted(ref) == list(range(14))
    for rid in ref:
        a, b = dataclasses.asdict(got[rid]), dataclasses.asdict(ref[rid])
        for field in a.keys() - _WALL:
            if a[field] is None or isinstance(a[field], np.ndarray):
                np.testing.assert_array_equal(a[field], b[field])
                if a[field] is not None:
                    assert a[field].dtype == b[field].dtype
            else:
                assert a[field] == b[field], (rid, field)
    st, sj = eng.stats(), jeng.stats()
    assert {c: st[c] for c in _COUNTERS} == {c: sj[c] for c in _COUNTERS}
    assert eng.retired_shards == jeng.retired_shards
    assert st["migrations"] and st["shards_retired"] == 1
    assert st["preemptions" if policy == "preempt" else "rejected"]
    assert st["shrinks"] or policy != "degrade"
    assert st["truncations"] or policy == "reject"


@pytest.mark.parametrize("k", [1, 4])
def test_mixed_stream_decisions_match_reference_engine(k):
    """Continuous requests without a target_error: no decision reads f, so
    every stamp and event list equals the reference's; QAP champions are
    exact and continuous ones meet the parity contract."""
    (eng, got), (jeng, ref) = _serve_both("mixed", k, "preempt")
    stamps = ("submit_tick", "start_tick", "first_tick", "finish_tick",
              "finish_reason", "levels_run", "n_evals", "granted_chains",
              "requested_chains", "home_shard", "preempted_ticks",
              "resumed_ticks", "migrated_ticks", "shrunk_ticks",
              "shrink_events", "truncated_ticks", "truncate_events",
              "arrival_time")
    for rid in ref:
        a, b = got[rid], ref[rid]
        assert [getattr(a, s) for s in stamps] == \
            [getattr(b, s) for s in stamps], rid
        if a.x_best.dtype == np.int32:
            _assert_bit_exact(a, b)
        else:
            np.testing.assert_allclose(a.x_best, b.x_best, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(a.champion_history, b.champion_history,
                                       rtol=2e-3, atol=2e-3)
    st, sj = eng.stats(), jeng.stats()
    assert {c: st[c] for c in _COUNTERS} == {c: sj[c] for c in _COUNTERS}
    assert st["preemptions"] and st["migrations"] and st["truncations"]


# ------------------------------------------ against run_standalone, per level
def test_preempt_resume_bit_exact_at_every_level():
    cfg = _cfg(n_slots=1, n_devices=1)
    victim = _req(0)
    solo = run_standalone(victim, cfg)
    filler = _req(1, priority=50, rho=0.5, T0=8.0)
    for level in range(1, victim.n_levels):
        engine = SAServeEngine(cfg)
        engine.submit(victim)
        for _ in range(level):
            engine.tick()
        assert engine.preempt(0)
        engine.submit(filler)
        results = {r.req_id: r for r in engine.run(max_ticks=200)}
        res = results[0]
        assert res.preempted_ticks == [level]
        assert len(res.resumed_ticks) == 1 and res.resumed_ticks[0] > level
        _assert_bit_exact(res, solo)
        _assert_bit_exact(results[1], run_standalone(filler, cfg))


def test_migration_bit_exact_at_every_level():
    cfg = _cfg(n_slots=1, n_devices=2)
    victim = _req(0)
    solo = run_standalone(victim, cfg)
    for level in range(1, victim.n_levels):
        engine = SAServeEngine(cfg)
        engine.submit(victim)
        for _ in range(level):
            engine.tick()
        assert engine.migrate(0, to_shard=1)
        res = engine.run(max_ticks=200)[0]
        assert res.migrated_ticks == [level] and res.home_shard == 1
        assert res.preempted_ticks == []
        _assert_bit_exact(res, solo)


def test_drain_bit_exact_at_every_level():
    cfg = _cfg(n_slots=1, n_devices=2, migration_budget=2)
    victim = _req(0)
    solo = run_standalone(victim, cfg)
    for level in range(1, victim.n_levels):
        engine = SAServeEngine(cfg)
        engine.submit(victim)
        for _ in range(level):
            engine.tick()
        home = _home_of(engine, 0)
        engine.drain(home)
        res = engine.run(max_ticks=200)[0]
        assert res.migrated_ticks == [level] and res.home_shard != home
        _assert_bit_exact(res, solo)
        assert engine.retired_shards == [(home, level)]
        _assert_no_leaks(engine)


@pytest.mark.parametrize("k", [1, 2])
def test_proactive_degrade_bit_exact_at_every_level(k):
    cfg = _cfg(n_slots=3, n_devices=1, macro_k=k)
    wide = _req(0, n_chains=3 * CPS, min_chains=CPS)
    for level in range(k, wide.n_levels, k):
        engine = SAServeEngine(cfg)
        engine.submit(wide)
        while engine.tick_count < level:
            engine.tick()
        assert engine.degrade_active(0, CPS)
        res = engine.run(max_ticks=200)[0]
        assert res.shrink_events == [(level, 3 * CPS, CPS)]
        assert res.shrunk_ticks == [level]
        assert (res.granted_chains, res.admitted_chains) == (CPS, 3 * CPS)
        _assert_bit_exact(res, run_standalone(wide, cfg,
                                              shrink_schedule=[(level, CPS)]))


@pytest.mark.parametrize("k", [1, 2])
def test_truncation_bit_exact_at_every_level(k):
    """Cut the ladder at every boundary; the result is 'truncated' and
    replays bit for bit, and its history is a prefix of the uncut run."""
    cfg = _cfg(n_slots=1, n_devices=1, macro_k=k)
    req = _req(0, rho=0.7, min_levels=2)      # 11-level ladder
    full = run_standalone(req, cfg)
    for level in range(k, req.n_levels - 1, k):
        engine = SAServeEngine(cfg)
        engine.submit(req)
        while engine.tick_count < level:
            engine.tick()
        to = max(level + 1, 3)
        assert engine.truncate_active(0, to)
        assert not engine.truncate_active(0, to)      # nothing left to cut
        res = engine.run(max_ticks=200)[0]
        assert res.finish_reason == "truncated"
        assert res.truncate_events == [(level, req.n_levels, to)]
        assert res.levels_run == to
        assert res.champion_history == full.champion_history[:to]
        _assert_bit_exact(res, run_standalone(req, cfg,
                                              truncate_schedule=[(level, to)]))


def test_truncation_respects_min_levels_floor():
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=1))
    engine.submit(_req(0, rho=0.7, min_levels=6))
    engine.tick()
    assert engine.truncate_active(0, 2)
    res = engine.run()[0]
    assert res.truncate_events == [(1, 11, 6)] and res.levels_run == 6
    assert not engine.truncate_active(0, 2)           # no longer active


def test_finish_deadline_truncates_and_replays():
    """The scheduler's plan: a request queued behind a long one misses its
    deadline unless cut, is cut at a boundary, and replays exactly."""
    cfg = _cfg(n_slots=1, n_devices=1, macro_k=2)
    long = _req(0, rho=0.8)
    late = _req(1, rho=0.7, finish_deadline=20.0, min_levels=3)
    engine = SAServeEngine(cfg)
    engine.submit(long)
    engine.submit(late)
    got = {r.req_id: r for r in engine.run()}
    res = got[1]
    assert res.finish_reason == "truncated" and engine.truncations == 1
    assert res.truncate_events[0][0] % 2 == 0
    _assert_bit_exact(res, _replay(res, late, cfg))
    _assert_bit_exact(got[0], run_standalone(long, cfg))


def test_drain_shrinks_wide_job_into_survivor():
    """A degrade-class job too wide for any survivor is shrunk into the
    roomiest one and replays bit for bit (the reference's run of this
    scenario differs from its own replay)."""
    cfg = _cfg(n_slots=3, n_devices=2, migration_budget=2)
    wide = _req(0, n_chains=3 * CPS, min_chains=CPS, on_overload="degrade",
                rho=0.8)
    narrow = _req(1, T0=8.0, rho=0.9, n_chains=2 * CPS)
    engine = SAServeEngine(cfg)
    engine.submit(wide)
    engine.tick()
    engine.submit(narrow)
    engine.tick()
    engine.drain(0)
    results = {r.req_id: r for r in engine.run(max_ticks=300)}
    res = results[0]
    assert res.n_shrinks == 1 and res.n_migrations == 1
    level, frm, to = res.shrink_events[0]
    assert (frm, to) == (3 * CPS, CPS) and res.granted_chains == CPS
    _assert_bit_exact(res, run_standalone(wide, cfg,
                                          shrink_schedule=[(level, to)]))
    _assert_bit_exact(results[1], run_standalone(narrow, cfg))
    _assert_no_leaks(engine)


# ----------------------------------------------- macro-tick boundaries
_MIX = [dict(objective="rastrigin"), dict(objective="ackley", dim=8),
        dict(objective="griewank", n_chains=2 * CPS), dict(objective="schwefel")]


def _boundary_run(k, budget):
    """The reference's K-boundary scenario: preempt request 0 and grow to
    three shards at tick 8, drain shard 1 at tick 16."""
    cfg = _cfg(n_slots=4, n_devices=2, macro_k=k, migration_budget=budget)
    reqs = [_req(i, rho=0.8, **kw) for i, kw in enumerate(_MIX)]
    engine = SAServeEngine(cfg)
    for r in reqs:
        engine.submit(r)
    engine.schedule_op(8, lambda: engine.preempt(0))
    engine.schedule_op(8, lambda: engine.resize(3))
    engine.schedule_op(16, lambda: engine.drain(1))
    return {r.req_id: r for r in engine.run(max_ticks=2000)}, reqs, cfg


_STAMPS = ("champion_history", "f_best", "finish_reason", "levels_run",
           "n_evals", "finish_tick", "first_tick", "preempted_ticks",
           "resumed_ticks", "migrated_ticks", "home_shard", "shrink_events")


@pytest.mark.parametrize("k", [2, 4, 8])
def test_preempt_resize_drain_at_macro_boundaries(k):
    """With a move budget that evacuates the drained shard within the
    boundary tick, every K gives the K = 1 champions bit for bit and the
    same lifecycle stamps, and each result replays standalone."""
    base, reqs, _ = _boundary_run(1, budget=4)
    fused, _, cfg = _boundary_run(k, budget=4)
    assert base[0].preempted_ticks == [8]
    assert any(r.migrated_ticks for r in base.values())
    for rid in base:
        for s in _STAMPS:
            assert getattr(fused[rid], s) == getattr(base[rid], s), (rid, s)
        np.testing.assert_array_equal(fused[rid].x_best, base[rid].x_best)
        for t in fused[rid].preempted_ticks + fused[rid].migrated_ticks:
            assert t % k == 0
    for req in reqs:
        _assert_bit_exact(fused[req.req_id], _replay(fused[req.req_id], req, cfg))


def test_budget_limited_evacuation_spans_ticks_that_are_not_boundaries():
    """With one move per boundary the drain of shard 1 takes two ticks at
    K = 1 (request 3 leaves at tick 17); at K = 2, tick 17 is no boundary
    and request 3 finishes on shard 1.  The stamps differ, the champions
    do not."""
    base, _, _ = _boundary_run(1, budget=1)
    fused, _, _ = _boundary_run(2, budget=1)
    assert (base[3].migrated_ticks, base[3].home_shard) == ([17], 0)
    assert (fused[3].migrated_ticks, fused[3].home_shard) == ([], 1)
    for rid in base:
        assert fused[rid].champion_history == base[rid].champion_history
        assert fused[rid].f_best == base[rid].f_best


def test_restored_slot_misses_the_state_cache_at_k4():
    """A checkpoint materializes the slots from the buffer that holds the
    last macro-tick; the restored slot holds host arrays, so its group is
    repacked and the result stays bit-exact."""
    cfg = _cfg(n_slots=2, n_devices=2, macro_k=4)
    reqs = [_req(0, rho=0.8), _req(1, objective="griewank", rho=0.8)]
    engine = SAServeEngine(cfg)
    for r in reqs:
        engine.submit(r)
    engine.tick()
    shard = engine.shards[0]
    (key,) = shard.group_cache
    buf = shard.group_cache[key]["x"]
    assert all(shard.pool.device_ref(s).buf is buf
               for s in range(cfg.n_slots) if shard.pool.owner[s] >= 0)
    src = _home_of(engine, 0)
    assert engine.migrate(0, 1 - src)
    dst = engine._shard(1 - src)
    slot = dst.pool.slots_of(next(j.rid for j in dst.rids.jobs.values()
                                  if j.req.req_id == 0))[0]
    assert dst.pool.device_ref(slot) is None
    assert engine.preempt(1)
    engine.tick()                         # resumes request 1, repacks both
    for s in engine.shards:
        for slot in range(cfg.n_slots):
            if s.pool.owner[slot] >= 0:
                ref = s.pool.device_ref(slot)
                assert ref is not None and ref.buf is s.group_cache[key]["x"]
    results = {r.req_id: r for r in engine.run()}
    for req in reqs:
        _assert_bit_exact(results[req.req_id], run_standalone(req, cfg))


# ----------------------------------------------------- guards, invariants
def test_preempt_noop_for_unknown_or_queued_request():
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=1))
    assert not engine.preempt(123)
    engine.submit(_req(0))
    assert not engine.preempt(0)
    engine.tick()
    assert engine.preempt(0)
    assert not engine.preempt(0)
    assert engine.preemptions == 1


def test_migrate_refuses_bad_targets():
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=2))
    assert not engine.migrate(123, 1)
    engine.submit(_req(0))
    assert not engine.migrate(0, 1)
    engine.tick()
    assert not engine.migrate(0, 0)
    with pytest.raises(ValueError):
        engine.migrate(0, 7)
    engine.submit(_req(1, priority=9))
    engine.tick()
    assert not engine.migrate(0, 1)
    assert engine.migrations == 0


def test_degrade_active_refuses_bad_targets():
    engine = SAServeEngine(_cfg(n_slots=2, n_devices=1))
    assert not engine.degrade_active(0, CPS)
    engine.submit(_req(0, n_chains=2 * CPS))
    engine.tick()
    assert not engine.degrade_active(0, 2 * CPS)
    assert not engine.degrade_active(0, 3 * CPS)
    assert engine.degrade_active(0, CPS)
    assert engine.shrinks == 1


def test_drain_guards_and_idempotence():
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=2, migration_budget=0))
    engine.submit(_req(0, rho=0.9))
    engine.submit(_req(1, rho=0.9))
    engine.tick()
    engine.drain(1)
    engine.drain(1)
    assert sum(s.draining for s in engine.shards) == 1
    assert not engine.migrate(0, 1)           # draining target refused
    with pytest.raises(ValueError):
        engine.drain(0)                       # the last live shard
    with pytest.raises(ValueError):
        engine.drain(7)
    idle = SAServeEngine(_cfg(n_slots=1, n_devices=3))
    idle.drain(2)
    assert idle.retired_shards == [(2, 0)]
    with pytest.raises(ValueError):
        idle.drain(2)


def test_resize_never_reuses_indices_and_grow_cancels_drain():
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=3))
    engine.resize(1)
    assert [s.index for s in engine.shards] == [0]
    engine.resize(3)
    assert [s.index for s in engine.shards] == [0, 3, 4]
    with pytest.raises(ValueError):
        engine.resize(0)
    busy = SAServeEngine(_cfg(n_slots=1, n_devices=2))
    busy.submit(_req(0, rho=0.9))
    busy.submit(_req(1, rho=0.9))
    busy.tick()
    busy.drain(1)
    busy.resize(2)
    assert not busy.shards[1].draining and len(busy.shards) == 2
    assert all(r.completed for r in busy.run(max_ticks=300))
    assert busy.retired_shards == []


def test_retired_shard_frees_its_state_buffers():
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=2, macro_k=2,
                                migration_budget=2))
    engine.submit(_req(0, rho=0.8))
    engine.tick()
    home = engine._shard(_home_of(engine, 0))
    assert home.group_cache
    engine.drain(home.index)
    engine.tick()
    assert home not in engine.shards and not home.group_cache


def test_random_drain_resize_fuzz_no_leaks_one_terminal():
    rng = np.random.default_rng(3)
    for trial in range(4):
        sched = SchedulerConfig(
            overload="degrade", default_deadline=40.0,
            proactive_degrade=bool(rng.integers(0, 2)),
            high_watermark=0.75, low_watermark=0.25)
        cfg = _cfg(n_slots=2, n_devices=int(rng.integers(2, 4)),
                   migration_budget=int(rng.integers(1, 3)),
                   macro_k=int(rng.choice([1, 2])), scheduler=sched)
        engine = SAServeEngine(cfg)
        n_reqs = int(rng.integers(3, 8))
        reqs = [_req(i, rho=0.7, n_chains=int(rng.integers(1, 3)) * CPS,
                     min_chains=CPS, priority=int(rng.integers(0, 3)))
                for i in range(n_reqs)]
        arrivals = ArrivalProcess.trace(
            reqs, [float(rng.uniform(0, 10)) for _ in reqs])
        guard = 0
        while not (engine.done and arrivals.exhausted):
            guard += 1
            assert guard < 500, "engine failed to drain"
            for t, r in arrivals.due(engine.tick_count):
                engine.submit(r, t)
            roll = rng.random()
            live = engine.live_shards
            if roll < 0.15 and len(live) > 1:
                engine.drain(live[int(rng.integers(0, len(live)))].index)
            elif roll < 0.3:
                engine.resize(int(rng.integers(1, 5)))
            elif roll < 0.4:
                active = [j.req.req_id for _, j in engine._iter_jobs()]
                if active:
                    engine.degrade_active(int(rng.choice(active)), CPS)
            engine.tick()
            resident = [j.req.req_id for _, j in engine._iter_jobs()]
            assert len(resident) == len(set(resident)), "double placement"
            for shard in engine.shards:
                assert len(shard.rids.jobs) + len(shard.rids._free) == \
                    cfg.n_slots, "leaked rid"
        _assert_no_leaks(engine)
        assert sorted(r.req_id for r in engine.results) == list(range(n_reqs))
        retired = [i for i, _ in engine.retired_shards]
        assert len(retired) == len(set(retired))
        for res in engine.results:
            if res.completed:
                _assert_bit_exact(res, _replay(res, reqs[res.req_id], cfg))


def test_occupancy_accounting_with_elastic_fleet():
    engine = SAServeEngine(_cfg(n_slots=1, n_devices=3, migration_budget=2))
    for i in range(3):
        engine.submit(_req(i, rho=0.8))
    engine.tick()
    engine.drain(2)
    engine.run(max_ticks=300)
    stats = engine.stats()
    assert 0.0 < stats["occupancy"] <= 1.0
    assert all(0.0 <= u <= 1.0 for u in stats["shard_occupancy"])
    assert stats["shards_retired"] == 1 and stats["draining"] == 0
    assert engine.shards[0].occupancy(ticks=10 ** 6) < stats["occupancy"]


def test_engine_config_carries_the_elastic_fields_across():
    from repro_torch import interop
    jcfg = JConfig(n_slots=3, chains_per_slot=CPS, n_devices=3, macro_k=2,
                   migration_budget=4, variant="full", use_pallas=False,
                   scheduler=jsched.SchedulerConfig(
                       policy="fifo", aging=0.1, hol_patience=3,
                       overload="preempt", default_deadline=7.0,
                       preemption_budget=3, high_watermark=0.8,
                       low_watermark=0.2, proactive_degrade=True,
                       shrink_budget=2))
    cfg = interop.engine_config_from_dict(dataclasses.asdict(jcfg),
                                          device="cpu")
    want = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k not in ("use_pallas", "interpret")}
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "device"} == want
    engine = SAServeEngine(cfg)
    assert [s.index for s in engine.shards] == [0, 1, 2]
    assert all(s.device.type == "cpu" for s in engine.shards)
