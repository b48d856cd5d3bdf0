"""Parallel tempering (PT) and population annealing (PA) in the port:
the exchange operators and engine helpers against the JAX package bit for
bit on seeded inputs, and the port's own versions of the reference's
``test_tempering.py`` engine scenarios, held against the port's
``run_standalone`` bit for bit.

* Operators: ``_pt_partners``, ``_pa_dbeta``, ``_job_mcode``,
  ``pt_swap_segmented``, ``pa_resample_segmented`` and the four-stage
  ``serving_exchange`` equal the reference's outputs.
* Engine: PT + PA + SOS + sync tenants co-batched equal their standalone
  runs at K = 1, 2 and 4, the fused path equals K = 1, and so do they
  across preemption, resize and drain; the PA ESS self-shrink is
  re-derived by the standalone run; a degraded PT admission anneals the
  coarser ladder of its granted width.
* The PA prefix sum past the reference's int32 bound: a tenant's resample
  does not depend on its neighbours.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro.service import engine as jengine
from repro.service import request as jrequest
from repro.service.serve_sa import make_mix as jmix
from repro_torch.core import exchange as tex
from repro_torch.kernels import ops as tops
from repro_torch.service import engine as tengine
from repro_torch.service import serve_sa
from repro_torch.service.engine import EngineConfig, SAServeEngine, run_standalone
from repro_torch.service.request import SARequest
from repro_torch.service.scheduler import AdmissionScheduler, SchedulerConfig

CPS = 8


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _same(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


# ------------------------------------------------------------ operators
def test_class_constants_match_reference():
    assert (tex.MCODE_PLAIN, tex.MCODE_SOS, tex.MCODE_PT, tex.MCODE_PA) == \
        (jex.MCODE_PLAIN, jex.MCODE_SOS, jex.MCODE_PT, jex.MCODE_PA)
    assert (tex.SOS_SALT, tex.PT_SALT, tex.PA_SALT) == \
        (jex.SOS_SALT, jex.PT_SALT, jex.PA_SALT)
    assert tex.PA_WEIGHT_SCALE == jex.PA_WEIGHT_SCALE


@pytest.mark.parametrize("n", [1, 2, 5, 8, 17])
@pytest.mark.parametrize("parity", [0, 1])
def test_pt_partners_match_reference(n, parity):
    p, lo = tengine._pt_partners(n, parity)
    jp, jlo = jengine._pt_partners(n, parity)
    assert p.dtype == jp.dtype and lo.dtype == jlo.dtype
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(lo, jlo)
    assert p[p].tolist() == list(range(n))          # an involution


def test_pa_dbeta_and_mcode_match_reference():
    for t, rho in ((2.0, 0.8), (1000.0, 0.99), (0.37, 0.5)):
        assert tengine._pa_dbeta(t, rho) == jengine._pa_dbeta(t, rho)
    for kw in (dict(), dict(exchange="sos"), dict(exchange="async"),
               dict(method="pt"), dict(method="pa"),
               dict(method="pa", pa_ess_ratio=0.3)):
        req = dict(req_id=0, objective="rastrigin", dim=4, n_chains=16, **kw)
        assert tengine._job_mcode(SARequest(**req)) == \
            jengine._job_mcode(jrequest.SARequest(**req))


def _pt_batch(seed):
    """Two PT tenants of 8 and 5 rungs (rows 0-7, 10-14) around plain rows,
    values with ties and a favourable and a hopeless gap."""
    rs = np.random.default_rng(seed)
    n = 16
    x = rs.standard_normal((n, 3)).astype(np.float32)
    fx = rs.integers(-3, 4, n).astype(np.float32) * 1.5
    fx[3] = 1e6
    t_rung = np.ones(n, np.float32)
    partner = np.arange(n, dtype=np.int32)
    pairlo = np.zeros(n, np.uint32)
    is_pt = np.zeros(n, bool)
    parity = seed % 2
    for row0, m in ((0, 8), (10, 5)):
        t_rung[row0:row0 + m] = np.geomspace(20.0, 0.5, m).astype(np.float32)
        p, lo = jengine._pt_partners(m, parity)
        partner[row0:row0 + m] = row0 + p
        pairlo[row0:row0 + m] = lo
        is_pt[row0:row0 + m] = True
    seed_c = np.full(n, 7 + seed, np.uint32)
    lvl = np.full(n, 3 + seed, np.uint32)
    return x, fx, t_rung, partner, pairlo, seed_c, lvl, is_pt


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pt_swap_matches_reference(seed):
    args = _pt_batch(seed)
    ref = jex.pt_swap_segmented(*args)
    x, fx, t_rung, partner, pairlo, seed_c, lvl, is_pt = (_t(a) for a in args)
    u = tex.exchange_uniform(seed_c, tex.PT_SALT, pairlo, lvl)
    port = tex.pt_swap_segmented(x, fx, t_rung, partner, is_pt, u)
    _same(port[:2], ref)
    moved = (port[0] != x).any(1) | (port[1] != fx)
    assert not bool((moved & ~port[2]).any())       # only swapping rows move


def _pa_batch(seed, n=40, dbeta=0.4):
    """Two PA tenants (rows 0-15 and 24-39) around plain rows."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n, 4)).astype(np.float32)
    fx = rs.uniform(-2, 6, n).astype(np.float32)
    seg = np.zeros(n, np.int32)
    seg[16:24], seg[24:] = 1, 2
    fb = np.array([fx[seg == s].min() for s in range(3)] + [np.inf],
                  np.float32)
    rows = np.arange(n, dtype=np.int32)
    seg_lo, seg_hi = rows.copy(), rows + 1
    seg_lo[:16], seg_hi[:16] = 0, 16
    seg_lo[24:], seg_hi[24:] = 24, n
    is_pa = (seg == 0) | (seg == 2)
    dbeta_c = np.where(is_pa, dbeta, 0.0).astype(np.float32)
    cidx = np.where(seg == 2, rows - 24, rows).astype(np.uint32)
    seed_c = np.where(seg == 2, 99, 5).astype(np.uint32)
    lvl = np.full(n, 11, np.uint32)
    return x, fx, fb, seg, seg_lo, seg_hi, dbeta_c, seed_c, cidx, lvl, is_pa


def _pa_resample(x, fx, fb, seg, seg_lo, seg_hi, dbeta_c, seed_c, cidx, lvl,
                 is_pa):
    """The port's PA resample with the reference's arguments: the uniform
    drawn from ``(seed_c, cidx, lvl)`` first."""
    u = tex.exchange_uniform(seed_c, tex.PA_SALT, cidx, lvl)
    return tex.pa_resample_segmented(x, fx, fb, seg, seg_lo, seg_hi, dbeta_c,
                                     is_pa, u)


@pytest.mark.parametrize("seed,dbeta", [(0, 0.4), (1, 0.05), (2, 3.0),
                                        (3, 50.0)])
def test_pa_resample_matches_reference(seed, dbeta):
    args = _pa_batch(seed, dbeta=dbeta)
    ref = jex.pa_resample_segmented(*args)
    port = _pa_resample(*(_t(a) for a in args))
    _same(port[:2], ref)
    rows = torch.arange(len(args[1]))
    anc = torch.where(port[3], port[2], rows)
    assert torch.equal(port[0], _t(args[0])[anc])   # each row is its ancestor's
    x, fx, is_pa = args[0], args[1], args[-1]
    np.testing.assert_array_equal(port[0].numpy()[~is_pa], x[~is_pa])
    np.testing.assert_array_equal(port[1].numpy()[~is_pa], fx[~is_pa])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_four_stage_serving_exchange_matches_reference(seed):
    """Every class in one batch: sync, SOS, PT, PA and plain rows, a pad
    segment and a live mask, through all four stages."""
    rs = np.random.default_rng(seed)
    n, S = 48, 6
    x = rs.standard_normal((n, 3)).astype(np.float32)
    fx = rs.integers(0, 9, n).astype(np.float32) * 0.5
    seg = np.repeat(np.arange(6, dtype=np.int32), 8)
    seg[40:] = S - 1                            # the pad segment
    mcode = np.repeat(np.array([0, 1, 2, 3, 2, 0], np.int8), 8)
    adopt = mcode == 0
    adopt[40:] = False
    rows = np.arange(n, dtype=np.int32)
    t_rung = np.ones(n, np.float32)
    partner = rows.copy()
    pairlo = np.zeros(n, np.uint32)
    seg_lo, seg_hi = rows.copy(), rows + 1
    for row0 in (16, 32):
        t_rung[row0:row0 + 8] = np.geomspace(8.0, 0.5, 8).astype(np.float32)
        p, lo = jengine._pt_partners(8, (seed + row0 // 16) % 2)
        partner[row0:row0 + 8] = row0 + p
        pairlo[row0:row0 + 8] = lo
    seg_lo[24:32], seg_hi[24:32] = 24, 32
    dbeta_c = np.where(mcode == 3, 0.7, 0.0).astype(np.float32)
    T = rs.uniform(0.5, 3, n).astype(np.float32)
    seed_c = rs.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    cidx = (rows % 8).astype(np.uint32)
    lvl = np.full(n, 5 + seed, np.uint32)
    live = rs.random(n) < 0.9
    args = (x, fx, seg, S, adopt, mcode, t_rung, T, partner, pairlo, seg_lo,
            seg_hi, dbeta_c, seed_c, cidx, lvl, live)
    ref = jex.serving_exchange(*args)
    port = tex.serving_exchange(*(a if i == 3 else _t(a)
                                  for i, a in enumerate(args)))
    _same(port, ref)


def test_pa_resample_past_the_int32_bound_is_tenant_local():
    """A tenant of 64 PA chains packed after 40000 PA chains of another
    tenant at dbeta = 0 (every weight 65536): the group's weights sum past
    2^31 - 1, where the reference's int32 prefix sum wraps.  The port's
    int64 sum keeps the tenant's resample equal to its resample alone."""
    big, small = 40000, 64
    rs = np.random.default_rng(0)
    xs = rs.standard_normal((small, 2)).astype(np.float32)
    fs = rs.uniform(0, 1, small).astype(np.float32)

    def resample_after(pre):
        n = pre + small
        x = np.concatenate([np.zeros((pre, 2), np.float32), xs])
        fx = np.concatenate([np.zeros(pre, np.float32), fs])
        seg = np.r_[np.zeros(pre, np.int32), np.ones(small, np.int32)]
        fb = np.array([0.0, fs.min(), np.inf], np.float32)
        lo = np.r_[np.zeros(pre, np.int32), np.full(small, pre, np.int32)]
        hi = np.r_[np.full(pre, pre, np.int32), np.full(small, n, np.int32)]
        cidx = np.r_[np.arange(pre), np.arange(small)].astype(np.uint32)
        seed_c = np.r_[np.full(pre, 1), np.full(small, 2)].astype(np.uint32)
        out = _pa_resample(
            _t(x), _t(fx), _t(fb), _t(seg), _t(lo), _t(hi),
            torch.zeros(n), _t(seed_c), _t(cidx), torch.full((n,), 3),
            torch.ones(n, dtype=torch.bool))
        wq = np.full(n, int(tex.PA_WEIGHT_SCALE), np.int64)
        return out[0][pre:].numpy(), out[1][pre:].numpy(), wq.sum()

    x_alone, f_alone, tot_alone = resample_after(0)
    x_packed, f_packed, tot_packed = resample_after(big)
    assert tot_alone < 2**31 - 1 < tot_packed
    np.testing.assert_array_equal(x_packed, x_alone)
    np.testing.assert_array_equal(f_packed, f_alone)
    assert len(np.unique(f_alone)) > 1          # it resampled


def test_per_chain_temperature_column_is_inert_when_it_repeats_the_blocks():
    rs = np.random.default_rng(0)
    blk, n_blocks = 8, 3
    x = rs.standard_normal((n_blocks * blk, 5)).astype(np.float32)
    kw = dict(n_steps=4, blk=blk, device="cpu")
    ctl = (np.asarray([0, 1, 2], np.int32), np.asarray([5.0, 2.0, 1.0], np.float32),
           np.asarray([11, 22, 33], np.uint32), np.zeros(3, np.uint32),
           np.asarray([0, 0, 8], np.uint32))
    a = tops.metropolis_sweep_slots(x, *ctl, **kw)
    b = tops.metropolis_sweep_slots(x, *ctl, T_chain=np.repeat(ctl[1], blk), **kw)
    _same(a, b)
    c = tops.metropolis_sweep_slots(
        x, *ctl, T_chain=np.geomspace(5.0, 0.5, n_blocks * blk).astype(np.float32),
        **kw)
    assert not torch.equal(c[1], a[1])


# -------------------------------------------------------- engine scenarios
def _req(req_id, objective="rastrigin", **kw):
    kw.setdefault("dim", 4)
    kw.setdefault("n_chains", CPS)
    kw.setdefault("T0", 50.0)
    kw.setdefault("T_min", 1.0)
    kw.setdefault("rho", 0.8)      # 18-level ladder
    kw.setdefault("N", 10)
    return SARequest(req_id=req_id, objective=objective, seed=100 + req_id,
                     **kw)


def _cfg(k=1, n_devices=1, **kw):
    kw.setdefault("n_slots", 4)
    return EngineConfig(chains_per_slot=CPS, n_devices=n_devices, macro_k=k,
                        device="cpu", **kw)


#: The reference's mix: a 1-slot and a 2-slot PT tenant, a PA tenant, an
#: SOS tenant and a plain sync tenant, 6 blocks over two shards.
MIX = [
    dict(objective="rastrigin", method="pt"),
    dict(objective="ackley", dim=8, method="pa"),
    dict(objective="schwefel", exchange="sos"),
    dict(objective="griewank", n_chains=2 * CPS, method="pt"),
    dict(objective="rastrigin", dim=8),
]


def _mix(**extra):
    return [_req(i, **{**kw, **extra}) for i, kw in enumerate(MIX)]


def _serve(reqs, k, n_devices=2, ops=None, **cfg_kw):
    cfg = _cfg(k=k, n_devices=n_devices, **cfg_kw)
    engine = SAServeEngine(cfg)
    for r in reqs:
        engine.submit(r)
    if ops is not None:
        ops(engine)
    return {r.req_id: r for r in engine.run(max_ticks=2000)}, engine, cfg


def _assert_bit_equal(a, b, *, ticks=True):
    assert a.keys() == b.keys()
    for rid in a:
        ra, rb = a[rid], b[rid]
        assert ra.champion_history == rb.champion_history, rid
        assert ra.f_best == rb.f_best, rid
        np.testing.assert_array_equal(ra.x_best, rb.x_best)
        assert (ra.finish_reason, ra.levels_run, ra.n_evals) == \
            (rb.finish_reason, rb.levels_run, rb.n_evals), rid
        if ticks:
            assert (ra.finish_tick, ra.first_tick) == \
                (rb.finish_tick, rb.first_tick), rid


def _assert_standalone(res, req, cfg, **kw):
    solo = run_standalone(req, cfg, **kw)
    assert res.f_best == solo.f_best, req.req_id
    assert res.champion_history == solo.champion_history, req.req_id
    np.testing.assert_array_equal(res.x_best, solo.x_best)
    return solo


@pytest.mark.parametrize("k", (1, 2, 4))
def test_cobatched_classes_bit_exact_vs_standalone(k):
    served, engine, cfg = _serve(_mix(), k=k)
    assert len(served) == len(MIX) and engine.done
    for req in _mix():
        _assert_standalone(served[req.req_id], req, cfg)


def test_fused_k_matches_k1():
    base, _, _ = _serve(_mix(), k=1)
    fused, _, _ = _serve(_mix(), k=4)
    _assert_bit_equal(base, fused)


@pytest.mark.parametrize("k", (1, 4))
def test_classes_survive_preempt_resize_drain(k):
    """Operator actions at K-aligned ticks: the preempted tenant is a PT
    job (its checkpoint carries rung states), the fleet resizes and a
    shard drains mid-stream; bit-equal to K = 1 and to the standalone
    replays of the recorded width schedules."""
    def ops(engine):
        engine.schedule_op(8, lambda: engine.preempt(0))
        engine.schedule_op(8, lambda: engine.resize(3))
        engine.schedule_op(16, lambda: engine.drain(1))

    base, _, _ = _serve(_mix(), k=1, ops=ops)
    fused, engine, cfg = _serve(_mix(), k=k, ops=ops)
    assert engine.preemptions >= 1 and engine.retired_shards
    _assert_bit_equal(base, fused)
    for req in _mix():
        res = fused[req.req_id]
        _assert_standalone(
            res, req, cfg,
            shrink_schedule=[(lvl, to) for lvl, _frm, to in res.shrink_events])


@pytest.mark.parametrize("k", (1, 4))
def test_pa_ess_self_shrink_rederived_by_standalone(k):
    """A PA tenant whose ESS collapses halves its own width; the event
    lands in pa_shrink_events and the standalone run re-derives it from
    the same f stream, with no schedule fed back."""
    req = _req(0, method="pa", n_chains=2 * CPS, pa_ess_ratio=0.9)
    served, engine, cfg = _serve([req], k=k, n_devices=1)
    res = served[0]
    assert res.pa_shrink_events and not res.shrink_events
    lvl, frm, to = res.pa_shrink_events[0]
    assert (frm, to) == (2 * CPS, CPS) and lvl % k == 0
    assert engine.shrinks == len(res.pa_shrink_events)
    solo = _assert_standalone(res, req, cfg)
    assert solo.pa_shrink_events == res.pa_shrink_events
    assert res.to_dict()["pa_shrink_events"] == [list(e) for e in
                                                 res.pa_shrink_events]


def test_pa_ess_off_means_no_self_shrink():
    req = _req(0, method="pa", n_chains=2 * CPS)
    served, _, cfg = _serve([req], k=1, n_devices=1)
    assert not served[0].pa_shrink_events
    _assert_standalone(served[0], req, cfg)


def test_degraded_pt_admission_builds_coarser_ladder():
    """Admission-time degrade is allowed for PT: granted fewer chains, it
    anneals the coarser ladder of that width from level 0, bit-equal to a
    standalone run at the granted width."""
    reqs = [_req(0, method="pt", n_chains=4 * CPS, min_chains=CPS,
                 on_overload="degrade", deadline=0.0, priority=0),
            _req(1, objective="ackley", priority=5),
            _req(2, objective="schwefel", priority=5)]
    cfg = _cfg(k=1, n_slots=4, scheduler=SchedulerConfig(
        overload="degrade", default_deadline=0.0))
    engine = SAServeEngine(cfg)
    for r in reqs:
        engine.submit(r)
    res = {r.req_id: r for r in engine.run(max_ticks=2000)}[0]
    assert res.completed and res.granted_chains < 4 * CPS
    _assert_standalone(
        res, dataclasses.replace(reqs[0], n_chains=res.granted_chains), cfg)


def test_pt_jobs_are_not_degradable_mid_flight():
    sched = AdmissionScheduler(SchedulerConfig(overload="degrade"))

    def job(m):
        return SimpleNamespace(req=_req(0, method=m))

    assert not sched._degradable(job("pt"))
    assert sched._degradable(job("pa")) and sched._degradable(job("sa"))
    engine = SAServeEngine(_cfg())
    engine.submit(_req(0, method="pt", n_chains=2 * CPS))
    engine.submit(_req(1, method="pa", n_chains=2 * CPS))
    engine.tick()
    assert engine.degrade_active(0, CPS) is False
    assert engine.degrade_active(1, CPS) is True


def test_request_validation():
    with pytest.raises(ValueError, match="exchange"):
        _req(0, exchange="bogus")
    with pytest.raises(ValueError, match="method"):
        _req(0, method="tempering")
    with pytest.raises(ValueError, match="pa_ess_ratio"):
        _req(0, pa_ess_ratio=0.5)
    with pytest.raises(ValueError):
        _req(0, method="pa", pa_ess_ratio=1.0)
    assert sorted(tex.EXCHANGES) == ["async", "sos", "sync"]
    r = _req(0, method="pt").pt_rungs(16)
    assert r.dtype == np.float32 and r[0] == np.float32(50.0)
    assert r[-1] == np.float32(1.0) and np.all(np.diff(r) < 0)
    np.testing.assert_array_equal(
        r, jrequest.SARequest(req_id=0, objective="rastrigin", dim=4,
                              n_chains=CPS, T0=50.0, T_min=1.0, rho=0.8,
                              N=10, seed=100, method="pt").pt_rungs(16))


@pytest.mark.parametrize("method", ["pt", "pa", "mixed"])
def test_serve_sa_method_check_on_cpu(method, capsys):
    argv = ["--device", "cpu", "--method", method, "--family", "mixed",
            "--requests", "6", "--slots", "3", "--chains-per-slot", str(CPS),
            "--macro-k", "2", "--check"]
    assert serve_sa.main(argv) == 0
    assert "6/6 champions bit-exact vs standalone" in capsys.readouterr().out
    mix = serve_sa.make_mix(12, CPS, method=method, family="mixed")
    fields = ("req_id", "objective", "dim", "n_chains", "seed", "priority",
              "method", "pa_ess_ratio", "family", "T0", "T_min", "rho", "N")
    assert [[getattr(r, f) for f in fields] for r in mix] == \
        [[getattr(r, f) for f in fields]
         for r in jmix(12, CPS, method=method, family="mixed")]
    cont = [r for r in mix if r.family == "continuous"]
    want = {"pt": {"pt"}, "pa": {"pa"}, "mixed": {"sa", "pt", "pa"}}[method]
    assert {r.method for r in cont} == want
    assert all(r.method == "sa" for r in mix if r.family == "permutation")
    assert all(r.pa_ess_ratio == (0.5 if r.method == "pa" else 0.0)
               for r in mix)
    with pytest.raises(SystemExit):
        serve_sa.main(["--device", "cpu", "--family", "qap", "--method",
                       method])
    assert "plain SA only" in capsys.readouterr().err
