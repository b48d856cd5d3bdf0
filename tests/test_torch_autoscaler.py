"""The port's closed-loop autoscaler and completion deadlines, on the CPU.

* Against the reference engine on the same seeded traces: the scaling
  history (each decision's tick, kind and fleet sizes), the sample count,
  the truncation events and the idle-jump cap are equal; the controller
  reads slots, ladders and ticks only, never f.
* Against itself: ladder truncation replays bit for bit through
  ``run_standalone`` at K = 1 and 4, the ``min_levels`` floor holds, the
  controller grows under a burst and drains in the trough without losing
  a request, and every champion served under the controller, the
  truncated ones too, equals its standalone replay.
* The reference's three hypothesis properties (no resize thrash under
  cooldown, no lost or duplicated request, truncation floor and replay),
  where hypothesis is installed.
"""
import dataclasses

import numpy as np
import pytest

from repro.service import ArrivalProcess as JArrivals
from repro.service import Autoscaler as JAutoscaler
from repro.service import AutoscalerConfig as JAutoscalerConfig
from repro.service import EngineConfig as JConfig
from repro.service import SARequest as JRequest
from repro.service import SAServeEngine as JEngine
from repro.service import serve_sa as jserve_sa
from repro_torch.service import (ArrivalProcess, Autoscaler,
                                 AutoscalerConfig, EngineConfig, SARequest,
                                 SAServeEngine, run_standalone, serve_sa)

CPS = 8
_REQ = dict(objective="rastrigin", dim=4, n_chains=CPS, T0=50.0, T_min=1.0,
            rho=0.8, N=10)


def _req(req_id, **kw):
    return SARequest(req_id=req_id, seed=100 + req_id, **{**_REQ, **kw})


def _cfg(n_slots=4, **kw):
    return EngineConfig(n_slots=n_slots, chains_per_slot=CPS, device="cpu",
                        **kw)


def _ctl_cfg(**kw):
    kw.setdefault("min_shards", 1)
    kw.setdefault("max_shards", 3)
    kw.setdefault("sample_every", 4)
    kw.setdefault("low_util", 0.5)
    kw.setdefault("window", 2)
    kw.setdefault("cooldown", 8)
    return kw


def _ctl(**kw):
    return Autoscaler(AutoscalerConfig(**_ctl_cfg(**kw)))


def _diurnal(reqs, rate=0.4, period=60.0, seed=3):
    return ArrivalProcess.diurnal(reqs, rate=rate, period=period,
                                  amplitude=0.9, seed=seed)


def _assert_replays(res, req, cfg):
    """The result equals its standalone run with its recorded width and
    ladder schedules, bit for bit."""
    if res.admitted_chains < req.n_chains:
        req = dataclasses.replace(req, n_chains=res.admitted_chains)
    solo = run_standalone(
        req, cfg,
        shrink_schedule=[(lvl, to) for lvl, _, to in res.shrink_events],
        truncate_schedule=[(lvl, to) for lvl, _, to in res.truncate_events])
    assert res.f_best == solo.f_best
    np.testing.assert_array_equal(res.x_best, solo.x_best)
    assert res.champion_history == solo.champion_history
    assert res.levels_run == solo.levels_run


# ------------------------------------------------ against the reference
def _serve_both(n, arrivals, ctl_kw, n_slots=2, max_ticks=5000, **req_kw):
    """Serve n requests under the controller in both engines; returns
    ((engine, controller, results), ...) for the port, then the
    reference."""
    runs = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            reqs = [_req(i, **req_kw) for i in range(n)]
            eng = SAServeEngine(_cfg(n_slots=n_slots))
            ctl = _ctl(**ctl_kw)
            arr = arrivals(ArrivalProcess, reqs)
        else:
            reqs = [JRequest(req_id=i, seed=100 + i, **{**_REQ, **req_kw})
                    for i in range(n)]
            eng = JEngine(JConfig(n_slots=n_slots, chains_per_slot=CPS,
                                  use_pallas=False))
            ctl = JAutoscaler(JAutoscalerConfig(**_ctl_cfg(**ctl_kw)))
            arr = arrivals(JArrivals, reqs)
        eng.attach_controller(ctl)
        res = {r.req_id: r for r in eng.run_stream(arr, max_ticks=max_ticks)}
        runs.append((eng, ctl, res))
    return runs


_STAMPS = ("arrival_time", "submit_tick", "start_tick", "finish_tick",
           "finish_reason", "levels_run", "home_shard", "migrated_ticks",
           "truncate_events")


def _assert_same_history(port, ref):
    (eng, ctl, got), (jeng, jctl, jgot) = port, ref
    assert ctl.decisions == jctl.decisions
    assert ctl.samples == jctl.samples
    assert ctl.next_sample_tick == jctl.next_sample_tick
    assert eng.tick_count == jeng.tick_count
    assert eng.retired_shards == jeng.retired_shards
    assert sorted(got) == sorted(jgot)
    for rid in got:
        assert [getattr(got[rid], s) for s in _STAMPS] == \
            [getattr(jgot[rid], s) for s in _STAMPS], rid
        np.testing.assert_allclose(got[rid].champion_history,
                                   jgot[rid].champion_history,
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n, rate, period", [(40, 0.2, 120.0),
                                             (16, 0.4, 60.0)])
def test_scaling_history_matches_reference_on_diurnal_trace(n, rate, period):
    runs = _serve_both(n, lambda AP, reqs: AP.diurnal(
        reqs, rate=rate, period=period, amplitude=0.9, seed=3), {})
    _assert_same_history(*runs)
    kinds = {k for _, k, _, _ in runs[0][1].decisions}
    assert "grow" in kinds and ("shrink" in kinds or n < 40)


def test_truncations_under_controller_match_reference_and_replay():
    """Completion deadlines under the controller: the same truncations as
    the reference, and every champion, the truncated ones too, replays
    standalone bit for bit."""
    runs = _serve_both(24, lambda AP, reqs: AP.diurnal(
        reqs, rate=0.6, period=60.0, amplitude=0.9, seed=5), {},
        finish_deadline=14.0, min_levels=4)
    _assert_same_history(*runs)
    eng, _, got = runs[0]
    truncated = [r for r in got.values() if r.truncated]
    assert truncated and eng.truncations == sum(r.n_truncations
                                                for r in got.values())
    for rid, res in got.items():
        _assert_replays(res, _req(rid, finish_deadline=14.0, min_levels=4),
                        eng.cfg)


def test_idle_jump_cap_matches_reference():
    runs = _serve_both(4, lambda AP, reqs: AP.trace(
        reqs, [1.0, 2.0, 3.0, 400.0]), dict(sample_every=16))
    _assert_same_history(*runs)


@pytest.mark.parametrize("macro_k", [1, 4])
def test_truncation_events_match_reference(macro_k):
    events = []
    for pkg in ("port", "ref"):
        kw = dict(_REQ, finish_deadline=12.0, min_levels=2)
        if pkg == "port":
            eng = SAServeEngine(_cfg(macro_k=macro_k))
            eng.submit(SARequest(req_id=0, seed=100, **kw))
        else:
            eng = JEngine(JConfig(n_slots=4, chains_per_slot=CPS,
                                  macro_k=macro_k, use_pallas=False))
            eng.submit(JRequest(req_id=0, seed=100, **kw))
        (res,) = eng.run()
        events.append((res.truncate_events, res.truncated_ticks,
                       res.levels_run, res.finish_tick, eng.truncations))
    assert events[0] == events[1]
    assert events[0][0]


def test_cli_autoscale_matches_reference_decisions(capsys):
    """``serve_sa --autoscale`` over make_mix with completion deadlines: the
    port's JSON report holds the reference's autoscaler decisions and
    every champion replays bit for bit (``--check``)."""
    import json
    argv = ["--autoscale", "--min-shards", "1", "--max-shards", "3",
            "--slots", "2", "--chains-per-slot", "8", "--requests", "5",
            "--arrivals", "diurnal", "--rate", "0.3", "--period", "60",
            "--amplitude", "0.9", "--finish-deadline-factor", "1.5",
            "--scale-sample-every", "4", "--scale-cooldown", "8",
            "--scale-window", "2", "--scale-low-util", "0.5", "--json"]
    assert serve_sa.main(["--device", "cpu"] + argv) == 0
    doc = json.loads(capsys.readouterr().out)
    jserve_sa.main(argv + ["--no-check"])
    jdoc = json.loads(capsys.readouterr().out)
    assert doc["autoscaler"] == jdoc["autoscaler"]
    assert doc["autoscaler"]["decisions"]
    assert doc["check"]["bit_exact"] == doc["check"]["served"] == 5
    assert doc["config"]["autoscale"] and doc["config"]["max_shards"] == 3


def test_cli_refuses_an_autoscale_fleet_outside_its_bounds():
    with pytest.raises(SystemExit) as err:
        serve_sa.main(["--device", "cpu", "--autoscale", "--devices", "3",
                       "--max-shards", "2"])
    assert err.value.code == 2


# ----------------------------------------------------------- SLO schema
def test_finish_deadline_and_min_levels_validated():
    _req(0, finish_deadline=50.0, min_levels=3)
    with pytest.raises(ValueError):
        _req(1, finish_deadline=0.0)
    with pytest.raises(ValueError):
        _req(2, min_levels=0)
    with pytest.raises(ValueError):
        _req(3, min_levels=100)
    with pytest.raises(ValueError):
        AutoscalerConfig(min_shards=3, max_shards=2)
    with pytest.raises(ValueError):
        AutoscalerConfig(headroom=0.5)


# ---------------------------------------------------- ladder truncation
@pytest.mark.parametrize("macro_k", [1, 4])
def test_truncation_fires_and_replays_bit_exact(macro_k):
    eng = SAServeEngine(_cfg(macro_k=macro_k))
    req = _req(0, finish_deadline=12.0, min_levels=2)
    eng.submit(req)
    (res,) = eng.run()
    assert res.completed and res.finish_reason == "truncated"
    assert res.truncated and res.n_truncations >= 1
    final_levels = res.truncate_events[-1][2]
    assert final_levels < req.n_levels
    assert res.levels_run == final_levels
    assert eng.stats()["truncations"] == res.n_truncations
    _assert_replays(res, req, eng.cfg)


def test_truncation_respects_min_levels_floor():
    eng = SAServeEngine(_cfg())
    eng.submit(_req(0, finish_deadline=1.0, min_levels=7))
    (res,) = eng.run()
    assert res.completed and res.levels_run >= 7
    for _lvl, frm, to in res.truncate_events:
        assert 7 <= to < frm


def test_no_deadline_means_no_truncation():
    eng = SAServeEngine(_cfg())
    eng.submit(_req(0))
    (res,) = eng.run()
    assert not res.truncated and res.truncate_events == []
    assert res.finish_reason == "ladder"


# ------------------------------------------------------ controller loop
def test_autoscaler_grows_under_burst_and_drains_after():
    reqs = [_req(i) for i in range(40)]
    ctl = _ctl()
    eng = SAServeEngine(_cfg(n_slots=2))
    eng.attach_controller(ctl)
    results = eng.run_stream(_diurnal(reqs, rate=0.2, period=120.0),
                             max_ticks=5000)
    assert len(results) == len(reqs)
    assert {r.req_id for r in results} == {q.req_id for q in reqs}
    kinds = [k for _, k, _, _ in ctl.decisions]
    assert "grow" in kinds and "shrink" in kinds
    assert ctl.samples > 0
    for _tick, _k, frm, to in ctl.decisions:
        assert 1 <= to <= ctl.cfg.max_shards and to != frm


def test_autoscaler_decisions_deterministic():
    def history():
        reqs = [_req(i) for i in range(16)]
        ctl = _ctl()
        eng = SAServeEngine(_cfg(n_slots=2))
        eng.attach_controller(ctl)
        res = eng.run_stream(_diurnal(reqs), max_ticks=5000)
        return ctl.decisions, sorted((r.req_id, r.f_best) for r in res)

    assert history() == history()


def test_autoscaler_respects_fleet_bounds():
    reqs = [_req(i) for i in range(20)]
    ctl = _ctl(max_shards=2)
    eng = SAServeEngine(_cfg(n_slots=2))
    eng.attach_controller(ctl)
    eng.run_stream(ArrivalProcess.trace(reqs, [1.0] * len(reqs)),
                   max_ticks=5000)
    assert ctl.decisions and all(to <= 2 for _, _, _, to in ctl.decisions)
    assert len(eng.live_shards) >= 1


def test_run_stream_idle_jump_capped_at_sampling_tick():
    reqs = [_req(i) for i in range(4)]
    ctl = _ctl(sample_every=16)
    eng = SAServeEngine(_cfg(n_slots=2))
    eng.attach_controller(ctl)
    results = eng.run_stream(
        ArrivalProcess.trace(reqs, [1.0, 2.0, 3.0, 400.0]), max_ticks=5000)
    assert len(results) == 4
    first_busy = max(r.finish_tick for r in results[:3])
    shrinks = [t for t, k, _, _ in ctl.decisions if k == "shrink"]
    assert any(first_busy < t < 400 for t in shrinks), ctl.decisions
    assert ctl.samples >= (400 - first_busy) // 16


# ----------------------------------------------------- property suite
def _given(**strategies):
    """Run the test body as a hypothesis property (8 examples)."""
    hyp = pytest.importorskip("hypothesis")
    return lambda body: hyp.settings(
        max_examples=8, deadline=None,
        suppress_health_check=[hyp.HealthCheck.too_slow])(
            hyp.given(**strategies)(body))


def test_property_no_resize_thrash_under_cooldown():
    st = pytest.importorskip("hypothesis.strategies")

    @_given(cooldown=st.integers(4, 40), rate=st.floats(0.2, 0.8),
            seed=st.integers(0, 5))
    def prop(cooldown, rate, seed):
        reqs = [_req(i) for i in range(12)]
        ctl = _ctl(cooldown=cooldown)
        eng = SAServeEngine(_cfg(n_slots=2))
        eng.attach_controller(ctl)
        eng.run_stream(_diurnal(reqs, rate=rate, seed=seed), max_ticks=5000)
        ticks = [t for t, _, _, _ in ctl.decisions]
        assert all(b - a >= cooldown for a, b in zip(ticks, ticks[1:])), \
            ctl.decisions

    prop()


def test_property_no_lost_or_duplicated_requests():
    st = pytest.importorskip("hypothesis.strategies")

    @_given(rate=st.floats(0.2, 1.0), seed=st.integers(0, 5),
            n=st.integers(6, 18))
    def prop(rate, seed, n):
        reqs = [_req(i) for i in range(n)]
        ctl = _ctl()
        eng = SAServeEngine(_cfg(n_slots=2))
        eng.attach_controller(ctl)
        results = eng.run_stream(_diurnal(reqs, rate=rate, seed=seed),
                                 max_ticks=8000)
        ids = [r.req_id for r in results]
        assert sorted(ids) == sorted(q.req_id for q in reqs)
        assert len(ids) == len(set(ids))

    prop()


def test_property_truncation_floor_and_bit_exact_replay():
    st = pytest.importorskip("hypothesis.strategies")

    @_given(deadline=st.floats(1.0, 30.0), min_levels=st.integers(1, 10),
            seed=st.integers(0, 5))
    def prop(deadline, min_levels, seed):
        base = _req(0)
        req = dataclasses.replace(base, seed=200 + seed,
                                  finish_deadline=deadline,
                                  min_levels=min(min_levels, base.n_levels))
        eng = SAServeEngine(_cfg())
        eng.submit(req)
        (res,) = eng.run()
        assert res.completed and res.levels_run >= req.min_levels
        for _lvl, frm, to in res.truncate_events:
            assert req.min_levels <= to < frm <= req.n_levels
        _assert_replays(res, req, eng.cfg)

    prop()
