"""Nelder–Mead and the hybrid SA→NM of the port vs the JAX package."""
import numpy as np
import pytest
import torch

from repro.core import nelder_mead as j_nm
from repro.objectives import functions as JF
from repro_torch.core import (HybridResult, NMResult, SAConfig, SAResult,
                              hybrid_minimize, nelder_mead)
from repro_torch.objectives import functions as TF


@pytest.mark.parametrize("name,x0", [
    ("exponential", [0.3, -0.2, 0.5, 0.1]),
    ("rastrigin", [0.1, -0.2, 0.15]),
])
def test_nelder_mead_matches_reference(name, x0):
    x0 = np.asarray(x0, np.float32)
    jo, to = getattr(JF, name)(x0.size), getattr(TF, name)(x0.size)
    rj = j_nm(jo, x0, max_iters=2000, fatol=1e-10, xatol=1e-10)
    rt = nelder_mead(to, x0, max_iters=2000, fatol=1e-10, xatol=1e-10,
                     device="cpu")
    assert abs(rt.f_best - rj.f_best) <= 1e-5
    assert rt.converged and rj.converged
    assert rt.x_best.shape == x0.shape and 0 < rt.n_iters < 2000


def test_nelder_mead_stops_at_max_iters():
    r = nelder_mead(TF.schwefel(4), np.full(4, 400.0, np.float32), max_iters=50,
                    fatol=0.0, xatol=0.0, device="cpu")
    assert r.n_iters == 50 and not r.converged


def test_hybrid_returns_the_winners_coherent_pair():
    obj = TF.schwefel(8)
    cfg = SAConfig(T0=100.0, T_min=1.0, rho=0.8, N=20, n_chains=128,
                   use_delta_eval=True, seed=2)
    h = hybrid_minimize(obj, cfg, nm_max_iters=500, device="cpu")
    assert h.f_best == min(h.sa.f_best, h.nm.f_best)
    assert h.f_best <= h.sa.f_best
    f_x = float(obj(torch.from_numpy(h.x_best)))
    assert abs(f_x - h.f_best) <= 1e-4 * abs(f_x)


def test_hybrid_keeps_sa_pair_when_nm_ends_worse():
    sa = SAResult(x_best=np.ones(2), f_best=-2.0, history_f=None, n_evals=1,
                  config=SAConfig())
    nm = NMResult(x_best=np.zeros(2), f_best=-1.0, n_iters=3, converged=False)
    h = HybridResult(sa=sa, nm=nm)
    assert h.f_best == -2.0 and np.array_equal(h.x_best, np.ones(2))
