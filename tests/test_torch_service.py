"""The port's serving engine against the JAX package and against itself.

* The segmented exchange, request validation and scheduler plans match
  ``repro`` exactly on the same seeded inputs.
* The port's engine is bit-exact against its own ``run_standalone`` at
  macro-K 1, 2, 4 and 8, for QAP and for co-batched families.
* Port and reference engines serve the same requests: QAP results match
  bit for bit (champions, histories, lifecycle ticks); continuous results
  meet the parity contract of torch_parity.py (states at rtol 2e-4, f at
  rtol 2e-3).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro.service import EngineConfig as JConfig
from repro.service import SAServeEngine as JEngine
from repro.service import request as jrequest
from repro.service import scheduler as jsched
from repro.service import slots as jslots
from repro_torch import interop
from repro_torch.core import exchange as tex
from repro_torch.service import engine as tengine
from repro_torch.service import request as trequest
from repro_torch.service import scheduler as tsched
from repro_torch.service import serve_sa
from repro_torch.service import slots as tslots
from repro_torch.service.engine import EngineConfig, SAServeEngine, run_standalone

CPS = 8


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


# ------------------------------------------------------------- exchange
def _batch(dtype, seed=0):
    """40 chains in 6 segments, the last one empty; values with ties."""
    rs = np.random.default_rng(seed)
    n, S = 40, 6
    x = rs.integers(0, 10, (n, 5)).astype(dtype)
    fx = rs.integers(0, 5, n).astype(np.float32)
    seg = rs.integers(0, S - 1, n).astype(np.int32)
    return rs, x, fx, seg, S


def _assert_same(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_champion_and_sync_match_reference(dtype):
    rs, x, fx, seg, S = _batch(dtype)
    xb, fb, ib = tex.segment_champion(_t(x), _t(fx), _t(seg), S)
    _assert_same((xb, fb, ib), jex.segment_champion(x, fx, seg, S))
    assert xb.dtype == _t(x).dtype and float(fb[S - 1]) == float("inf")
    assert int(ib[S - 1]) == len(fx)
    adopt = rs.random(len(fx)) < 0.5
    for mask in (None, adopt):
        _assert_same(
            tex.exchange_sync_segmented(_t(x), _t(fx), _t(seg), S,
                                        None if mask is None else _t(mask)),
            jex.exchange_sync_segmented(x, fx, seg, S, mask))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_serving_exchange_matches_reference(dtype):
    """Plain and SOS chains, sync adoption, a live mask; the reference's
    PT/PA stages get identity inputs."""
    rs, x, fx, seg, S = _batch(dtype, seed=1)
    n = len(fx)
    adopt = rs.random(n) < 0.5
    mcode = rs.integers(0, 2, n).astype(np.int8)
    T = rs.uniform(0.5, 3, n).astype(np.float32)
    seed_c = rs.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    cidx = np.arange(n, dtype=np.uint32)
    lvl = np.full(n, 7, np.uint32)
    live = rs.random(n) < 0.8
    rows = np.arange(n, dtype=np.int32)
    ref = jex.serving_exchange(x, fx, seg, S, adopt, mcode,
                               np.ones(n, np.float32), T, rows,
                               np.zeros(n, np.uint32), rows, rows + 1,
                               np.zeros(n, np.float32), seed_c, cidx, lvl, live)
    port = tex.serving_exchange(_t(x), _t(fx), _t(seg), S, _t(adopt), _t(mcode),
                                _t(T), _t(seed_c), _t(cidx), _t(lvl), _t(live))
    _assert_same(port, ref)
    sos = mcode == tex.MCODE_SOS
    assert (port[1].numpy() != fx)[sos].any()    # the SOS stage adopted


def test_serving_exchange_refuses_pt_and_pa():
    _, x, fx, seg, S = _batch(np.float32)
    n = len(fx)
    for code in (tex.MCODE_PT, tex.MCODE_PA):
        mcode = torch.zeros(n, dtype=torch.int8)
        mcode[3] = code
        with pytest.raises(NotImplementedError):
            tex.serving_exchange(_t(x), _t(fx), _t(seg), S,
                                 torch.ones(n, dtype=torch.bool), mcode,
                                 torch.ones(n), 0, torch.arange(n), 0,
                                 torch.ones(n, dtype=torch.bool))
    assert (tex.MCODE_PLAIN, tex.MCODE_SOS, tex.MCODE_PT, tex.MCODE_PA) == \
        (jex.MCODE_PLAIN, jex.MCODE_SOS, jex.MCODE_PT, jex.MCODE_PA)
    assert (tex.SOS_SALT, tex.PT_SALT, tex.PA_SALT) == \
        (jex.SOS_SALT, jex.PT_SALT, jex.PA_SALT)


# -------------------------------------------------------------- requests
@pytest.mark.parametrize("bad", [
    dict(family="tensor"), dict(dim=0), dict(n_chains=0), dict(N=0),
    dict(rho=1.0), dict(T0=0.05), dict(exchange="ring"), dict(method="ga"),
    dict(pa_ess_ratio=0.5), dict(deadline=-1.0), dict(min_chains=100),
    dict(on_overload="drop"), dict(finish_deadline=0.0), dict(min_levels=999),
    dict(objective="branin"), dict(objective="syn10", family="permutation"),
    dict(objective="grid12", dim=12, family="permutation", method="pt"),
    dict(objective="grid12", dim=12, family="permutation", pa_ess_ratio=0.2,
         method="pa"),
])
def test_request_validation_matches_reference(bad):
    kw = dict(req_id=0, objective="rastrigin", dim=4, n_chains=16)
    kw.update(bad)
    with pytest.raises(ValueError) as ref_err:
        jrequest.SARequest(**kw)
    with pytest.raises(ValueError) as port_err:
        trequest.SARequest(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_requests_and_configs_carry_across():
    mix = serve_sa.make_mix(12, CPS, seed=3, family="mixed")
    from repro.service.serve_sa import make_mix as jmix
    for req, jreq in zip(mix, jmix(12, CPS, seed=3, family="mixed")):
        assert dataclasses.asdict(req) == dataclasses.asdict(jreq)
        back = interop.sa_request_from_dict(dataclasses.asdict(jreq))
        assert back == req and (back.kid, back.n_levels, back.f_opt) == \
            (jreq.kid, jreq.n_levels, jreq.f_opt)
        np.testing.assert_array_equal(back.sample_x0(CPS), jreq.sample_x0(CPS))
    with pytest.raises(ValueError, match="unknown SARequest fields"):
        interop.sa_request_from_dict({**dataclasses.asdict(mix[0]), "gpu": 1})
    jcfg = JConfig(n_slots=5, chains_per_slot=CPS, macro_k=4, use_pallas=False,
                   scheduler=jsched.SchedulerConfig(overload="reject",
                                                    default_deadline=3.0))
    cfg = interop.engine_config_from_dict(dataclasses.asdict(jcfg), device="cpu")
    assert (cfg.n_slots, cfg.chains_per_slot, cfg.macro_k, cfg.device) == \
        (5, CPS, 4, "cpu")
    assert dataclasses.asdict(cfg.scheduler) == dataclasses.asdict(jcfg.scheduler)
    with pytest.raises(ValueError, match="unknown EngineConfig fields"):
        interop.engine_config_from_dict({"n_slots": 2, "mesh": None})


# ------------------------------------------------------------- scheduler
def _simulate(sched_mod, slots_mod, request_mod, policy, ticks=14):
    """Drive one package's scheduler through a seeded closed loop on two
    shards and log its decisions: admissions, evictions and rejections
    planned each tick; jobs run a fixed number of ticks."""
    cfg = sched_mod.SchedulerConfig(
        overload=policy, default_deadline=2.0 if policy in ("reject", "degrade")
        else None, preemption_budget=2)
    sched = sched_mod.AdmissionScheduler(cfg)
    rs = np.random.default_rng(5)
    for i in range(18):
        sched.submit(request_mod.SARequest(
            req_id=i, objective=("rastrigin", "ackley")[i % 2], dim=4 + i % 3,
            n_chains=CPS * int(rs.integers(1, 4)), priority=int(rs.integers(0, 3)),
            min_chains=CPS if i % 3 else None), tick=int(rs.integers(0, 4)))
    shards = {0: {}, 1: {}}          # shard -> rid -> (job, end tick)
    free = {0: 4, 1: 3}
    log, next_rid = [], 0
    for tick in range(ticks):
        for si in shards:
            for rid in [r for r, (_, end) in shards[si].items() if end <= tick]:
                free[si] += len(shards[si].pop(rid)[0].slots)
        views = [sched_mod.ShardView(
            index=si, free_slots=free[si],
            active=tuple(j for j, _ in shards[si].values()),
            shapes=frozenset((j.req.family, j.req.dim, j.req.N)
                             for j, _ in shards[si].values()))
            for si in shards]
        plan = sched.admit_sharded(views, CPS, tick)
        log.append((tick,
                    [(e.req.req_id, g, si) for e, g, si in plan.admitted],
                    sorted(plan.evict), [e.req.req_id for e in plan.rejected]))
        for rid, si in plan.evict:
            job, _ = shards[si].pop(rid)
            free[si] += len(job.slots)
            sched.requeue(slots_mod.SwappedJob(job=job, blocks=[None] * len(job.slots)))
        for entry, granted, si in plan.admitted:
            if entry.swapped is not None:
                job = entry.swapped.job
            else:
                job = slots_mod.ActiveJob(req=entry.req, rid=next_rid,
                                          slots=list(range(granted)),
                                          submit_tick=entry.submit_tick,
                                          start_tick=tick)
                next_rid += 1
            shards[si][job.rid] = (job, tick + 2 + job.req.req_id % 4)
            free[si] -= granted
    return log


@pytest.mark.parametrize("policy", ["none", "reject", "degrade", "preempt"])
def test_scheduler_plans_match_reference(policy):
    port = _simulate(tsched, tslots, trequest, policy)
    ref = _simulate(jsched, jslots, jrequest, policy)
    assert port == ref
    assert any(adm for _, adm, _, _ in port)


# ---------------------------------------------------------------- engine
def _qreq(i, inst="syn10", **kw):
    n = {"syn10": 10, "grid12": 12}[inst]
    base = dict(n_chains=CPS, T0=30.0, T_min=0.5, rho=0.55, N=10, seed=100 + i)
    base.update(kw)
    return trequest.SARequest(req_id=i, objective=inst, dim=n,
                              family="permutation", **base)


def _creq(i, **kw):
    base = dict(objective="rastrigin", dim=4, n_chains=CPS, T0=50.0,
                T_min=1.0, rho=0.55, N=10, seed=100 + i)
    base.update(kw)
    return trequest.SARequest(req_id=i, **base)


def _workload(family):
    """Requests that queue behind each other in a 4-slot pool, with sync,
    async and SOS exchange, two-slot requests, a budget and a target."""
    qap = [_qreq(0, n_chains=2 * CPS), _qreq(1, "grid12"),
           _qreq(2, "grid12", exchange="sos"), _qreq(3, exchange="async"),
           _qreq(4, "grid12", max_evals=3 * 10 * CPS),
           _qreq(5, target_error=400.0, priority=2)]
    if family == "qap":
        return qap
    cont = [_creq(10, n_chains=2 * CPS), _creq(11, objective="ackley", dim=6,
                                               exchange="sos"),
            _creq(12, objective="schwefel", dim=4, N=12),
            _creq(13, exchange="async", max_evals=2 * 10 * CPS)]
    return [r for pair in zip(qap, cont) for r in pair] + qap[len(cont):]


def _serve(reqs, cfg):
    eng = SAServeEngine(cfg)
    for r in reqs:
        eng.submit(r)
    return eng, {r.req_id: r for r in eng.run()}


def _assert_exact(a, b):
    assert a.f_best == b.f_best
    np.testing.assert_array_equal(a.x_best, b.x_best)
    assert a.x_best.dtype == b.x_best.dtype
    assert a.champion_history == b.champion_history
    assert (a.levels_run, a.n_evals, a.finish_reason) == \
        (b.levels_run, b.n_evals, b.finish_reason)


@pytest.mark.parametrize("family", ["qap", "mixed"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_engine_matches_standalone(family, k):
    cfg = EngineConfig(n_slots=4, chains_per_slot=CPS, macro_k=k, device="cpu")
    reqs = _workload(family)
    eng, got = _serve(reqs, cfg)
    assert eng.done and sorted(got) == sorted(r.req_id for r in reqs)
    for req in reqs:
        res = got[req.req_id]
        _assert_exact(res, run_standalone(req, cfg))
        if req.family == "permutation":
            assert res.x_best.dtype == np.int32
            assert req.instance.cost(res.x_best) == res.f_best
    reasons = {got[r.req_id].finish_reason for r in reqs}
    assert {"ladder", "budget", "target"} <= reasons
    assert max(r.start_tick for r in got.values()) > 0   # requests queued


@pytest.mark.parametrize("k", [1, 4])
def test_engine_matches_reference_engine(k):
    reqs = _workload("mixed")
    jreqs = [jrequest.SARequest(**dataclasses.asdict(r)) for r in reqs]
    eng, got = _serve(reqs, EngineConfig(n_slots=4, chains_per_slot=CPS,
                                         macro_k=k, device="cpu"))
    jeng = JEngine(JConfig(n_slots=4, chains_per_slot=CPS, macro_k=k,
                           use_pallas=False))
    for r in jreqs:
        jeng.submit(r)
    ref = {r.req_id: r for r in jeng.run()}
    assert eng.tick_count == jeng.tick_count
    for req in reqs:
        a, b = got[req.req_id], ref[req.req_id]
        assert (a.start_tick, a.first_tick, a.finish_tick, a.levels_run,
                a.n_evals, a.finish_reason, a.granted_chains) == \
            (b.start_tick, b.first_tick, b.finish_tick, b.levels_run,
             b.n_evals, b.finish_reason, b.granted_chains)
        if req.family == "permutation":
            _assert_exact(a, b)
        else:
            np.testing.assert_allclose(a.x_best, b.x_best, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(a.champion_history, b.champion_history,
                                       rtol=2e-3, atol=2e-3)


def test_engine_stats_and_results():
    eng, got = _serve(_workload("qap"), EngineConfig(
        n_slots=4, chains_per_slot=CPS, macro_k=4, device="cpu"))
    st = eng.stats()
    assert st["completed"] == st["submitted"] == len(got)
    assert 0.0 < st["occupancy"] <= 1.0 and st["wall_s"] > 0
    assert st["group_launches"] > 0 and st["sweeps"] == eng.sweeps_done
    rec = got[1].to_dict(include_x=True)
    assert rec["latency_ticks"] >= rec["ttft_ticks"] > 0
    json.dumps(rec)


_CFG = EngineConfig(n_slots=2, chains_per_slot=CPS, device="cpu")


@pytest.mark.parametrize("call", [
    lambda e: e.attach_controller(object()),
    lambda e: e._maybe_pa_shrink(None, None, None),
    lambda e: tengine._pt_partners(4, 0), lambda e: tengine._pa_dbeta(1.0, 0.9),
    lambda e: e.submit(_creq(0, method="pt")),
    lambda e: e.submit(_creq(0, method="pa")),
])
def test_deferred_features_raise(call):
    with pytest.raises(NotImplementedError):
        call(SAServeEngine(_CFG))


def _outcome(fn, *args):
    """(return value or (error type, message), the engine's fleet, queue
    and submit count afterwards) of ``fn(engine, request class, engine
    class)``."""
    eng, req_cls, eng_cls = args
    try:
        out = fn(eng, req_cls, eng_cls)
    except Exception as err:                  # noqa: BLE001 (compared below)
        out = (type(err).__name__, str(err))
    return out, [(s.index, s.draining) for s in eng.shards], \
        [r.req_id for r in eng.scheduler.pending], eng.n_submitted


@pytest.mark.parametrize("call", [
    lambda e, R, E: e.preempt(0),
    lambda e, R, E: e.migrate(0, 0),
    lambda e, R, E: e.drain(0),
    lambda e, R, E: e.resize(2),
    lambda e, R, E: e.add_shards(1),
    lambda e, R, E: e.degrade_active(0, 4),
    lambda e, R, E: e.truncate_active(0, 2),
    lambda e, R, E: e.run_stream([]),
    lambda e, R, E: e.submit(R(**dataclasses.asdict(_creq(0, finish_deadline=20.0)))),
    lambda e, R, E: [(s.index, s.pool.n_slots) for s in E(
        dataclasses.replace(e.cfg, n_devices=2)).shards],
], ids=["preempt", "migrate", "drain", "resize", "add_shards",
        "degrade_active", "truncate_active", "run_stream", "finish_deadline",
        "n_devices"])
def test_elastic_calls_match_reference_on_small_engine(call):
    """The calls that raised before the elastic slice, on a one-shard
    engine with nothing in flight: same return values, same errors and
    the same fleet and queue afterwards as the reference engine."""
    port = _outcome(call, SAServeEngine(_CFG), trequest.SARequest, SAServeEngine)
    ref = _outcome(call, JEngine(JConfig(n_slots=2, chains_per_slot=CPS,
                                         use_pallas=False)),
                   jrequest.SARequest, JEngine)
    assert port == ref


@pytest.mark.parametrize("policy, req_kw", [
    ("preempt", dict(priority=5)), ("degrade", dict(min_chains=CPS))],
    ids=["preempt", "degrade"])
def test_overload_plans_execute_bit_exact(policy, req_kw):
    """A two-slot arrival on a pool with one free slot: 'preempt' evicts
    the running request, 'degrade' admits at one slot.  Both results equal
    their standalone runs (the degraded one at its admitted width)."""
    cfg = dataclasses.replace(_CFG, scheduler=tsched.SchedulerConfig(
        overload=policy, default_deadline=5.0))
    eng = SAServeEngine(cfg)
    first, second = _creq(0), _creq(1, n_chains=2 * CPS, **req_kw)
    eng.submit(first)
    eng.tick()
    eng.submit(second)
    eng.tick()
    got = {r.req_id: r for r in eng.run()}
    if policy == "preempt":
        assert eng.preemptions == 1 and got[0].preempted_ticks == [1]
        _assert_exact(got[1], run_standalone(second, cfg))
    else:
        assert got[1].granted_chains == CPS and got[1].degraded
        _assert_exact(got[1], run_standalone(
            dataclasses.replace(second, n_chains=CPS), cfg))
    _assert_exact(got[0], run_standalone(first, cfg))


def test_serve_sa_cli_on_cpu(capsys):
    argv = ["--device", "cpu", "--family", "mixed", "--requests", "4",
            "--slots", "3", "--chains-per-slot", str(CPS), "--macro-k", "2",
            "--check"]
    assert serve_sa.main(argv) == 0
    assert "4/4 champions bit-exact vs standalone" in capsys.readouterr().out
    assert serve_sa.main(argv + ["--json", "--seed", "1"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["check"]["bit_exact"] == doc["check"]["served"] == 4
    assert doc["config"]["device"] == "cpu"
    with pytest.raises(SystemExit):
        serve_sa.main(argv + ["--autoscale"])
    assert "not ported" in capsys.readouterr().err
