"""The port's profiler spans (``repro_torch/spans.py``): off, a span is the
shared no-op and opens no range; under a torch profiler the ladder opens
one ``sa.level`` range a level, as host events of the trace the benchmark
reads, and the solve's results do not change.  The card case finds no
``sa.pack`` range under V2's full sweep, which takes the champion as one
shared row, one a level after the first under V2's delta sweep, which
packs it, and no range among the device events."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import SAConfig, sa_minimize
from repro_torch.objectives import functions as TF
from repro_torch.spans import NULL_SPAN, Span, span

CFG = SAConfig(T0=50.0, T_min=50.0 * 0.8 ** 6.5, rho=0.8, N=8, n_chains=128,
               seed=5)


def _solve(mode, device="cpu", **kw):
    cfg = dataclasses.replace(CFG, exchange=mode, **kw)
    return cfg, sa_minimize(TF.schwefel(8), cfg, device=device)


def _profiled(mode, device="cpu", activities=(ProfilerActivity.CPU,), **kw):
    """(cfg, result, [(name, start_ns, end_ns)] of the trace's host events).
    No span may appear among the trace's device events."""
    with profile(activities=list(activities)) as prof:
        cfg, r = _solve(mode, device, **kw)
    events = prof.profiler.kineto_results.events()
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events if e.device_type() == DeviceType.CPU]
    assert not [e.name() for e in events if e.device_type() != DeviceType.CPU
                and e.name().startswith("sa.")]
    return cfg, r, host


def _named(host, name):
    return sorted((s, e) for n, s, e in host if n == name)


def test_private_range_constructor_is_there_and_records_a_host_event():
    """``span`` records through ``torch._C._profiler._RecordFunctionFast``,
    which torch does not promise to keep: should this fail, go back to
    ``torch.profiler.record_function`` in ``repro_torch/spans.py``, once
    the benchmark's trace keeps only kernels, copies and sets."""
    import torch._C._profiler as P
    assert hasattr(P, "_RecordFunctionFast"), \
        "torch._C._profiler._RecordFunctionFast is gone"
    # Called as ``Span`` calls it: one positional name, then a context.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P._RecordFunctionFast("sa.probe"):
            torch.ones(4).sum()
    events = prof.profiler.kineto_results.events()
    probe = [e for e in events if e.name() == "sa.probe"]
    assert len(probe) == 1 and probe[0].device_type() == DeviceType.CPU
    assert probe[0].duration_ns() > 0


def test_gate_opens_no_range_without_a_profiler():
    opened = Span.opened
    assert span("sa.level") is NULL_SPAN and span("sa.pack") is NULL_SPAN
    with span("sa.level"), span("sa.level"):
        pass
    _solve("sync")
    assert Span.opened == opened


@pytest.mark.parametrize("mode", ["sync", "async", "sos"])
def test_profiled_solve_opens_one_level_range_a_level(mode):
    opened = Span.opened
    cfg, _, host = _profiled(mode)
    levels = _named(host, "sa.level")
    assert cfg.n_levels == 7 and len(levels) == cfg.n_levels
    assert Span.opened - opened == cfg.n_levels
    assert all(s < e for s, e in levels)
    assert all(a[1] <= b[0] for a, b in zip(levels, levels[1:]))
    # The plain sweep copies nothing into a kernel's input.
    assert _named(host, "sa.pack") == []


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_results_bit_identical_with_and_without_profiler(mode):
    _, plain = _solve(mode)
    _, traced, _ = _profiled(mode)
    assert traced.f_best == plain.f_best
    np.testing.assert_array_equal(traced.x_best, plain.x_best)
    np.testing.assert_array_equal(traced.history_f, plain.history_f)


@pytest.fixture
def card():
    """Decided here, not at import: the kernel route runs only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cuda_v2_packs_every_level_after_the_first_v1_none(card):
    """Only the delta variant packs the V2 champion, once in each level
    after the first; the full variant reads it as one row and packs
    nothing, and V1 has nothing to pack."""
    acts = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    cfg, r2, host = _profiled("sync", card, acts, n_chains=4096)
    assert len(_named(host, "sa.level")) == cfg.n_levels
    assert _named(host, "sa.pack") == []
    _, plain = _solve("sync", card, n_chains=4096)
    assert r2.f_best == plain.f_best
    np.testing.assert_array_equal(r2.history_f, plain.history_f)
    _, rd, host = _profiled("sync", card, acts, n_chains=4096, use_delta_eval=True)
    levels, packs = _named(host, "sa.level"), _named(host, "sa.pack")
    assert len(levels) == cfg.n_levels and len(packs) == cfg.n_levels - 1
    # Level 0 sweeps the contiguous starts; each later level packs once.
    assert all(any(s <= p and q <= e for s, e in levels) for p, q in packs)
    assert not any(levels[0][0] <= p <= levels[0][1] for p, _ in packs)
    _, plain = _solve("sync", card, n_chains=4096, use_delta_eval=True)
    assert rd.f_best == plain.f_best
    np.testing.assert_array_equal(rd.history_f, plain.history_f)
    _, r1, host = _profiled("async", card, acts, n_chains=4096)
    assert len(_named(host, "sa.level")) == cfg.n_levels
    assert _named(host, "sa.pack") == []
