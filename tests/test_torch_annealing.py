"""The port's ladder (repro_torch.core.annealing) vs the JAX package.

(a) Level by level: from the port's own state at each level, the port's
    sweep is held to the parity contract against
    repro.kernels.ops.metropolis_sweep on the same counters, and the port's
    exchange and best-so-far against repro.core.exchange applied to the
    port's swept state.
(b) In distribution: the median champion over 8 seeds against
    repro.core.sa_minimize, within the reference's own spread; the same
    over 6 seeds on six suite problems without a kernel id (two of them
    through the decomposable delta sweep) and on Schwefel in float64 (the
    reference under ``jax.enable_x64``).
(c) SAResult fields and n_evals; the hybrid on a problem without a
    kernel id.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SAConfig as JConfig
from repro.core import exchange as jexch
from repro.core import sa_minimize as j_sa
from repro.kernels import ops as jops
from repro.objectives import SUITE as JSUITE
from repro.objectives import functions as JF
from repro_torch.core import annealing as tann
from repro_torch.core import exchange as texch
from repro_torch.core import SAConfig, hybrid_minimize, sa_minimize
from repro_torch.interop import sa_config_from_dict
from repro_torch.objectives import SUITE
from repro_torch.objectives import functions as TF

from torch_parity import assert_sweep_parity


def _ref_exchange(mode, x, fx, T, seed, lvl):
    if mode == "sync":
        return jexch.exchange_sync(None, x, fx, T)
    if mode == "sos":
        xb, fb = jexch.global_champion(x, fx)
        u = jexch.exchange_uniform(seed, jexch.SOS_SALT,
                                   jnp.arange(fx.shape[0], dtype=jnp.uint32), lvl)
        adopt = u <= jexch.sos_adopt_prob(fx, fb, T)
        return (jnp.where(adopt[:, None], xb[None, :], x),
                jnp.where(adopt, fb, fx))
    return x, fx


@pytest.mark.parametrize("mode", ["sync", "async", "sos"])
@pytest.mark.parametrize("name", ["schwefel", "griewank"])
def test_level_by_level_against_reference_composition(name, mode):
    obj = getattr(TF, name)(8)
    cfg = SAConfig(T0=50.0, T_min=50.0 * 0.7 ** 5.5, rho=0.7, N=10,
                   n_chains=64, exchange=mode, seed=3, use_delta_eval=True)
    assert cfg.n_levels == 6
    rs = np.random.default_rng(0)
    x0 = (obj.lower + rs.random((64, 8)) * (obj.upper - obj.lower)).astype(np.float32)
    state = tann.init_state(torch.from_numpy(x0), objective=obj, cfg=cfg)
    n = cfg.n_chains
    for lvl, T in enumerate(cfg.ladder().tolist()):
        x_in = state.x.numpy().copy()

        def port(k, x_in=x_in, T=T, lvl=lvl):
            return tann.ops.metropolis_sweep(x_in, T, cfg.seed, lvl * cfg.N,
                                             kid=obj.kernel_id, n_steps=k,
                                             device="cpu")

        def ref(k, x_in=x_in, T=T, lvl=lvl):
            return jops.metropolis_sweep(x_in, T, cfg.seed, lvl * cfg.N,
                                         kid=obj.kernel_id, n_steps=k)

        xs, fs = port(cfg.N)
        assert_sweep_parity(x_in, port, ref, kid=np.full(n, obj.kernel_id),
                            T=np.full(n, T), seed=np.full(n, cfg.seed),
                            step0=np.full(n, lvl * cfg.N), cidx=np.arange(n),
                            variant="delta", n_steps=cfg.N)
        best_f_in = float(state.best_f)
        state = tann.level_step(state, lvl, T, objective=obj, cfg=cfg)
        xe, fe = _ref_exchange(mode, jnp.asarray(xs.numpy()),
                               jnp.asarray(fs.numpy()), np.float32(T),
                               cfg.seed, lvl)
        np.testing.assert_array_equal(state.x.numpy(), np.asarray(xe))
        np.testing.assert_array_equal(state.fx.numpy(), np.asarray(fe))
        _, fb = jexch.local_champion(xe, fe)
        assert float(state.best_f) == min(best_f_in, float(fb))
        assert float(state.hist[lvl]) == float(state.best_f)


def test_champion_in_distribution_matches_sa_minimize():
    """Median f_best over 8 seeds within the reference's own spread (max -
    min over the same seeds) of the reference's median."""
    kw = dict(T0=100.0, T_min=0.5, rho=0.8, N=30, n_chains=256,
              use_delta_eval=True, record_history=False)
    f_ref = np.array([j_sa(JF.schwefel(8), JConfig(**kw, seed=s)).f_best
                      for s in range(8)])
    f_port = np.array([sa_minimize(TF.schwefel(8), SAConfig(**kw, seed=s),
                                   device="cpu").f_best for s in range(8)])
    spread = f_ref.max() - f_ref.min()
    assert abs(np.median(f_port) - np.median(f_ref)) <= spread, (f_port, f_ref)
    assert np.all(np.abs(f_port - TF.schwefel(8).f_opt) < 0.1)


def _median_within_reference_spread(j_obj, t_obj, kw, seeds=6, **ctx):
    """Median f_best of the port within the reference's spread (max - min
    over the same seeds) of the reference's median; the reference draws
    from jax.random keys 0..seeds-1, the port from cfg.seed 0..seeds-1."""
    jcfg = JConfig(**kw)
    f_ref = np.array([j_sa(j_obj, jcfg, key=jax.random.PRNGKey(s)).f_best
                      for s in range(seeds)])
    f_port = np.array([sa_minimize(t_obj, SAConfig(**kw, seed=s),
                                   device="cpu").f_best
                       for s in range(seeds)])
    spread = f_ref.max() - f_ref.min()
    assert abs(np.median(f_port) - np.median(f_ref)) <= spread, (f_port, f_ref)
    return f_port


@pytest.mark.parametrize("key,delta", [
    ("F2", False), ("F3_b", True), ("F5", False), ("F9", False),
    ("F12_b", True), ("F16", False)])
def test_objectives_without_kernel_in_distribution(key, delta):
    """Suite problems the sweep kernel does not know run through the plain
    sweep (core/metropolis.py) and reach the reference's quality."""
    kw = dict(T0=10.0, T_min=0.01, rho=0.8, N=30, n_chains=128,
              use_delta_eval=delta, record_history=False)
    f_port = _median_within_reference_spread(JSUITE[key](), SUITE[key](), kw)
    assert np.all(np.abs(f_port - SUITE[key]().f_opt) < 1e-2)


def test_float64_schwefel_in_distribution():
    kw = dict(T0=100.0, T_min=0.5, rho=0.8, N=30, n_chains=256,
              record_history=False, dtype="float64")
    with jax.enable_x64(True):
        f_port = _median_within_reference_spread(JF.schwefel(8),
                                                 TF.schwefel(8), kw)
    assert np.all(np.abs(f_port - TF.schwefel(8).f_opt) < 0.1)


def test_hybrid_on_a_problem_without_kernel():
    obj = SUITE["F10_b"]()          # Levy-Montalvo 5, no kernel id
    cfg = SAConfig(T0=10.0, T_min=0.5, rho=0.8, N=20, n_chains=128, seed=4)
    h = hybrid_minimize(obj, cfg, nm_max_iters=500, device="cpu")
    assert h.f_best == min(h.sa.f_best, h.nm.f_best) <= h.sa.f_best
    assert abs(h.f_best - obj.f_opt) < 1e-3
    assert h.x_best.dtype == np.float32
    h64 = hybrid_minimize(obj, dataclasses.replace(cfg, dtype="float64"),
                          nm_max_iters=500, device="cpu")
    assert h64.x_best.dtype == np.float64 and h64.nm.x_best.dtype == np.float64


@pytest.mark.parametrize("mode,n_chains", [("async", 1), ("async", 32),
                                           ("sync", 32), ("sos", 32)])
def test_result_fields_and_n_evals(mode, n_chains):
    obj = TF.rastrigin(4)
    cfg = SAConfig(T0=10.0, T_min=1.0, rho=0.7, N=8, n_chains=n_chains,
                   exchange=mode, exchange_period=2, seed=5)
    res = sa_minimize(obj, cfg, device="cpu")
    assert res.x_best.shape == (4,) and isinstance(res.f_best, float)
    assert res.n_evals == cfg.n_levels * cfg.N * cfg.n_chains
    assert res.config is cfg and res.objective_name == "rastrigin_4"
    assert res.history_f.shape == (cfg.n_levels,)
    assert np.all(np.diff(res.history_f) <= 0)
    assert res.f_best <= res.history_f[-1]
    f_x = float(obj(torch.from_numpy(res.x_best)))
    assert abs(f_x - res.f_best) <= 1e-5 * max(1.0, abs(f_x))
    res2 = sa_minimize(obj, dataclasses.replace(cfg, record_history=False),
                       x0=np.zeros(4), device="cpu")
    assert res2.history_f is None


def test_config_round_trips_and_deferred_paths_raise():
    ref_cfg = JConfig(T0=7.0, N=3, exchange="sos", unroll=True)
    cfg = sa_config_from_dict(dataclasses.asdict(ref_cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.n_levels == ref_cfg.n_levels and cfg.n_evals == ref_cfg.n_evals
    np.testing.assert_array_equal(cfg.ladder(), ref_cfg.ladder())
    # float64 and objectives without a kernel_id run (they raised before
    # the plain sweep, core/metropolis.py, was ported).
    small = SAConfig(T0=5.0, T_min=1.0, rho=0.5, N=4, n_chains=16)
    res64 = sa_minimize(TF.schwefel(2), dataclasses.replace(small, dtype="float64"),
                        device="cpu")
    assert res64.x_best.dtype == np.float64 and res64.history_f.dtype == np.float64
    res_b = sa_minimize(TF.branin(), small, device="cpu")
    assert np.isfinite(res_b.f_best) and res_b.x_best.dtype == np.float32
    with pytest.raises(ValueError, match="unknown dtype"):
        sa_minimize(TF.schwefel(2), dataclasses.replace(small, dtype="float16"),
                    device="cpu")
    # The mesh path runs (tests/test_torch_sharded.py); a mesh must be a
    # DeviceMesh, and a champion over mesh axes needs a process group.
    with pytest.raises(TypeError, match="DeviceMesh"):
        sa_minimize(TF.schwefel(2), SAConfig(), device="cpu", mesh=object())
    with pytest.raises(RuntimeError, match="init_process_group"):
        texch.global_champion(torch.zeros(2, 2), torch.zeros(2), ("x",))
    with pytest.raises(ValueError, match="unknown exchange"):
        sa_minimize(TF.schwefel(2), SAConfig(exchange="ring"), device="cpu")


def test_exchange_uniform_and_adopt_prob_match_reference():
    idx = np.arange(1000, dtype=np.uint32)
    u_j = jexch.exchange_uniform(123, jexch.SOS_SALT, jnp.asarray(idx), 7)
    u_t = texch.exchange_uniform(123, texch.SOS_SALT, torch.from_numpy(idx.astype(np.int64)), 7)
    np.testing.assert_array_equal(np.asarray(u_j), u_t.numpy())
    assert (texch.SOS_SALT, texch.PT_SALT, texch.PA_SALT) == (
        int(jexch.SOS_SALT), int(jexch.PT_SALT), int(jexch.PA_SALT))
    fx = np.linspace(-3.0, 5.0, 33).astype(np.float32)
    for T in (0.5, 2.0):
        np.testing.assert_allclose(
            texch.sos_adopt_prob(torch.from_numpy(fx), torch.tensor(-3.0), T).numpy(),
            np.asarray(jexch.sos_adopt_prob(jnp.asarray(fx), np.float32(-3.0), np.float32(T))),
            rtol=1e-6)
