"""The port's sharding autotuner (``repro_torch.distributed.autotune``)
against the reference's (``repro.distributed.autotune``).

The port's roofline constants describe an H100; every test that compares
numbers with the reference first sets them to the reference's (on the
port's module only), so the two objectives are the same function.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.distributed import autotune as RA
from repro_torch.configs import get_arch
from repro_torch.distributed import autotune as TA

# dense, MoE, hybrid (Mamba + attention + MoE)
ARCHS = ("stablelm-1.6b", "deepseek-v2-lite-16b", "jamba-v0.1-52b")
# The reference hard-codes its per-chip memory capacity in _cost_terms
# (src/repro/distributed/autotune.py:134); its other constants are
# module-level.
REF_HBM_CAP = 16.0 * 2 ** 30


@pytest.fixture
def ref_constants(monkeypatch):
    for port_name, value in (("PEAK_FLOPS", RA.PEAK_FLOPS),
                             ("HBM_BW", RA.HBM_BW),
                             ("LINK_BW", RA.ICI_BW),
                             ("HBM_CAP", REF_HBM_CAP)):
        monkeypatch.setattr(TA, port_name, value)


def _problems(arch, chips=256):
    kw = dict(seq=4096, batch=256, chips=chips)
    return (RA.TuneProblem(cfg=ref_arch(arch).model, **kw),
            TA.TuneProblem(cfg=get_arch(arch).model, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_space_and_decode_point_match(arch):
    rp, tp = _problems(arch)
    assert tp.dp_choices() == rp.dp_choices()
    assert tp.space() == rp.space()
    pts = np.random.default_rng(7).random((64, 5)).astype(np.float32)
    pts[:4] = [[0.0] * 5, [0.999999] * 5, [0.5] * 5, [0.0, 0.99, 0.99, 0.99, 0.0]]
    for x in pts:
        assert TA.decode_point(tp, x) == RA.decode_point(rp, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_objective_values_match(ref_constants, arch):
    rp, tp = _problems(arch)
    x = np.random.default_rng(11).random((256, 5)).astype(np.float32)
    want = np.asarray(RA.make_objective(rp)(jnp.asarray(x)))
    got = TA.make_objective(tp)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_exhaustive_best_matches(ref_constants, arch):
    rp, tp = _problems(arch)
    want_choice, want_cost = RA.exhaustive_best(rp)
    got_choice, got_cost = TA.exhaustive_best(tp, device="cpu")
    assert got_choice == want_choice
    assert got_cost == pytest.approx(want_cost, rel=1e-6)


@pytest.mark.parametrize("arch,chips", [("stablelm-1.6b", 64),
                                        ("deepseek-v2-lite-16b", 256)])
def test_autotune_within_two_percent_of_exhaustive(ref_constants, arch, chips):
    """The reference's own gate (tests/test_autotune_hloparse.py:13-18,
    examples/sharding_autotuner.py:54), at the reference's constants."""
    _, tp = _problems(arch, chips)
    choice, cost = TA.autotune(tp, n_chains=128, seed=0, device="cpu")
    _, best = TA.exhaustive_best(tp, device="cpu")
    assert cost <= best * 1.02, (cost, best)
    assert choice["dp"] * choice["tp"] == chips


def _kimi_points(prob):
    dps = prob.dp_choices()
    x_dp_only = [(dps.index(256) + 0.5) / len(dps), 0.1, 0.1, 0.1, 0.1]
    x_mixed = [(dps.index(16) + 0.5) / len(dps), 0.5, 0.9, 0.9, 0.5]
    return np.array([x_dp_only, x_mixed], np.float32)


def test_cost_model_penalizes_oom_at_reference_constants(ref_constants):
    """The reference's OOM property (tests/test_autotune_hloparse.py:20-32):
    kimi-k2 (1T parameters) pure-DP on 256 chips must cost more than
    dp=16/tp=16 with dots remat, EP and 8 microbatches."""
    rp, tp = _problems("kimi-k2-1t-a32b")
    x = _kimi_points(tp)
    f_dp, f_mix = TA.make_objective(tp)(torch.from_numpy(x)).tolist()
    assert f_mix < f_dp
    np.testing.assert_allclose([f_dp, f_mix],
                               np.asarray(RA.make_objective(rp)(jnp.asarray(x))),
                               rtol=1e-6)


def test_kimi_points_at_h100_constants():
    """What the H100's constants decide between the same two kimi-k2
    points.  Pure DP holds 14 bytes per parameter over 256 chips (56.1 GB)
    plus its activations without remat over one microbatch (28.7 GB):
    84.8 GB per chip, 6% over the card's 80 GB, so its penalty is 6.0 s
    and the mixed point (0.90 s) is still preferred, by less than at the
    reference's constants."""
    _, tp = _problems("kimi-k2-1t-a32b")
    total, _ = tp.cfg.param_count()
    tokens = tp.batch * tp.seq
    act = tokens * tp.cfg.d_model * tp.cfg.n_layers * 8.0 * 2.0
    per_chip = total * 14.0 / tp.chips + act / tp.chips
    assert per_chip == pytest.approx(84.8e9, rel=1e-3)
    assert per_chip > TA.HBM_CAP
    f_dp, f_mix = TA.make_objective(tp)(torch.from_numpy(_kimi_points(tp))).tolist()
    assert f_mix < f_dp
    assert f_dp - f_mix == pytest.approx(100.0 * (per_chip / TA.HBM_CAP - 1.0), rel=0.2)
