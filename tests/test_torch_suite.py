"""The paper's 41-problem suite (Table 8) in the port against the JAX
package, and ``sa_minimize`` on every problem of it.

* ``interop.objective_from_ref(key)`` gives the reference's box, f_opt,
  x_opt, kernel id and decomposable structure, and f at seeded points
  within 128 float32 ulps of the batch's largest |f| (torch and XLA round
  sin, cos, exp and the sums differently); Salomon's cos(2 pi r), at r of
  a few hundred, turns a 4-ulp difference of r into (2 pi + 0.1) times
  it, which its tolerance adds.  Bit for bit on the three polynomial
  problems, where both round alike.
* ``sa_minimize`` runs each problem on the CPU at a small size, through
  kernel B1's plain version for the 18 registry objectives and through
  ``core/metropolis.py`` for the 23 others.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.objectives import SUITE as JSUITE
from repro_torch import interop
from repro_torch.core import SAConfig, annealing, sa_minimize
from repro_torch.objectives import SUITE

KEYS = list(JSUITE)
POLYNOMIAL = ("F7", "F9", "F14")      # Goldstein-Price, Himmelblau, Rosenbrock


def _points(obj, n=256, seed=0):
    rs = np.random.default_rng(seed)
    return (obj.lower + rs.random((n, obj.dim))
            * (obj.upper - obj.lower)).astype(np.float32)


def test_suite_has_the_references_keys_and_kernel_split():
    assert list(SUITE) == KEYS and len(KEYS) == 41
    with_kid = [k for k in KEYS if SUITE[k]().kernel_id is not None]
    assert len(with_kid) == 18


@pytest.mark.parametrize("key", KEYS)
def test_suite_objective_matches_reference(key):
    jo, to = JSUITE[key](), interop.objective_from_ref(key)
    assert (to.name, to.dim, to.f_opt, to.kernel_id) == \
        (jo.name, jo.dim, jo.f_opt, jo.kernel_id)
    assert (to.decomposable is None) == (jo.decomposable is None)
    np.testing.assert_array_equal(to.lower, jo.lower)
    np.testing.assert_array_equal(to.upper, jo.upper)
    if jo.x_opt is None:
        assert to.x_opt is None
    else:
        np.testing.assert_array_equal(to.x_opt, jo.x_opt)
    x = _points(jo, seed=len(key))
    fj = np.asarray(jo(jnp.asarray(x)))
    ft = to(torch.from_numpy(x)).numpy()
    assert ft.dtype == np.float32 and ft.shape == (len(x),)
    if key in POLYNOMIAL:
        np.testing.assert_array_equal(ft, fj)
    else:
        atol = 128 * 2.0**-24 * float(np.max(np.abs(fj)))
        if key == "F15":
            r = np.sqrt((x.astype(np.float64) ** 2).sum(-1)).max()
            atol += (2 * np.pi + 0.1) * 4 * float(np.spacing(np.float32(r)))
        np.testing.assert_allclose(ft, fj, rtol=0, atol=atol)
    df, dx = to.error_to_opt(x[:3], ft[:3])
    jdf, jdx = jo.error_to_opt(jnp.asarray(x[:3]), jnp.asarray(ft[:3]))
    np.testing.assert_allclose(df, np.asarray(jdf), rtol=1e-6)
    np.testing.assert_allclose(dx, np.asarray(jdx), rtol=1e-5)


@pytest.mark.parametrize("key", KEYS)
def test_sa_minimize_runs_every_suite_problem(key, monkeypatch):
    obj = SUITE[key]()
    routes = []
    monkeypatch.setattr(annealing.ops, "metropolis_sweep",
                        _spy(annealing.ops.metropolis_sweep, "kernel", routes))
    monkeypatch.setattr(annealing.metropolis, "sweep_full",
                        _spy(annealing.metropolis.sweep_full, "plain", routes))
    cfg = SAConfig(T0=10.0, T_min=1.0, rho=0.5, N=4, n_chains=16, seed=1)
    res = sa_minimize(obj, cfg, device="cpu")
    assert np.isfinite(res.f_best) and res.x_best.shape == (obj.dim,)
    assert np.all((res.x_best >= obj.lower.astype(np.float32))
                  & (res.x_best <= obj.upper.astype(np.float32)))
    assert res.history_f.shape == (cfg.n_levels,)
    want = "kernel" if obj.kernel_id is not None else "plain"
    assert routes == [want] * cfg.n_levels


def _spy(fn, name, log):
    def wrapped(*a, **kw):
        log.append(name)
        return fn(*a, **kw)
    return wrapped


def test_float64_never_takes_the_kernel(monkeypatch):
    routes = []
    monkeypatch.setattr(annealing.ops, "metropolis_sweep",
                        _spy(annealing.ops.metropolis_sweep, "kernel", routes))
    cfg = SAConfig(T0=10.0, T_min=1.0, rho=0.5, N=4, n_chains=16,
                   dtype="float64")
    res = sa_minimize(SUITE["F0_a"](), cfg, device="cpu")
    assert routes == [] and res.x_best.dtype == np.float64
    assert annealing.sweeps_in_kernel(SUITE["F0_a"](), SAConfig())
    assert not annealing.sweeps_in_kernel(SUITE["F0_a"](), cfg)
    assert not annealing.sweeps_in_kernel(SUITE["F2"](), SAConfig())


@pytest.fixture
def card():
    """Decided here, not at import: the CUDA paths run only where there is
    a card (chip_smoke.py phases 11 and 12 drive them at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("key,dtype,b1", [("F0_a", "float32", True),
                                          ("F0_a", "float64", False),
                                          ("F2", "float32", False)])
def test_cuda_route_by_dtype_and_kernel_id(card, key, dtype, b1):
    from repro_torch.kernels import metropolis_sweep as ms
    from repro_torch.kernels import reduce_min as rm
    cfg = SAConfig(T0=10.0, T_min=1.0, rho=0.5, N=4, n_chains=256, dtype=dtype)
    ms.counter.launches = rm.counter.launches = 0
    res = sa_minimize(SUITE[key](), cfg)
    assert np.isfinite(res.f_best) and res.x_best.dtype == np.dtype(dtype)
    assert ms.counter.launches == (cfg.n_levels if b1 else 0)
    assert (rm.counter.launches > 0) == (dtype == "float32")
