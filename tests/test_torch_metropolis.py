"""The port's plain Metropolis sweeps (repro_torch.core.metropolis), its
DecomposableSpec and its float64 draws, against kernel B1's plain version
and the JAX package on the same seeded numpy inputs.

* ``sweep_full`` in float32 equals ``kernels.ref.metropolis_sweep_ref``'s
  ``full`` variant bit for bit on registry objectives whose ``fn`` rounds
  as ``objective_math.full_eval`` does (kids 0, 1, 2, 4, 5); on Griewank
  (product form against log-sum form) the states are held to the parity
  contract of torch_parity.py and f to a few float32 ulps.
* Each ported ``DecomposableSpec`` agrees with the reference's spec
  (``init_acc``, ``value``, ``terms``) to float32 rounding of the sums.
* ``draws3_f64`` keeps ``draws3``'s bits and widens both uniforms to 53
  bits in [0, 1).
"""
import numpy as np
import pytest
import torch

from repro.objectives import functions as JF
from repro_torch.core import metropolis as tmet
from repro_torch.kernels import objective_math as om
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rng as trng
from repro_torch.objectives import functions as TF

from torch_parity import assert_sweep_parity

CHAINS, DIM, STEPS = 64, 16, 12

#: The nine objectives of the reference with a DecomposableSpec.
DECOMPOSABLE = ["schwefel", "ackley", "cosine_mixture", "exponential",
                "griewank", "michalewicz", "rastrigin", "salomon", "shubert"]


def _points(obj, chains=CHAINS, seed=0, dtype=np.float32):
    rs = np.random.default_rng(seed)
    return (obj.lower + rs.random((chains, obj.dim))
            * (obj.upper - obj.lower)).astype(dtype)


def _make(name, dim):
    """The port's and the reference's objective ``name`` at ``dim`` (the
    fixed-dim factories ignore it)."""
    fixed = {"exponential": 4, "salomon": 10, "shubert": 2}
    n = fixed.get(name, dim)
    return getattr(TF, name)(n), getattr(JF, name)(n)


@pytest.mark.parametrize("kid", [0, 1, 2, 4, 5])
def test_sweep_full_equals_plain_b1_full_bit_for_bit(kid):
    name = next(k for k, v in om.KID_BY_NAME.items() if v == kid)
    obj = getattr(TF, name)(DIM)
    x = torch.from_numpy(_points(obj, seed=kid))
    np.testing.assert_array_equal(obj(x).numpy(),
                                  om.full_eval(kid, x, DIM)[:, 0].numpy())
    T = torch.linspace(0.5, 5.0, CHAINS)
    xs, fs = tmet.sweep_full(x, obj(x), T, 7, 2**32 - 5, objective=obj,
                             n_steps=STEPS)
    xr, fr = tref.metropolis_sweep_ref(x, T, 7, 2**32 - 5, kid=kid,
                                       n_steps=STEPS, variant="full")
    np.testing.assert_array_equal(xs.numpy(), xr.numpy())
    np.testing.assert_array_equal(fs.numpy(), fr.numpy())


def test_sweep_full_on_griewank_to_ulp_tolerance():
    obj = TF.griewank(DIM)
    x0 = _points(obj, seed=3)

    def port(k):
        x = torch.from_numpy(x0)
        return tmet.sweep_full(x, obj(x), 30.0, 11, 5, objective=obj,
                               n_steps=k)

    def plain(k):
        return tref.metropolis_sweep_ref(torch.from_numpy(x0), 30.0, 11, 5,
                                         kid=3, n_steps=k, variant="full")

    assert_sweep_parity(x0, port, plain, kid=np.full(CHAINS, 3),
                        T=np.full(CHAINS, 30.0), seed=np.full(CHAINS, 11),
                        step0=np.full(CHAINS, 5), cidx=np.arange(CHAINS),
                        variant="full", n_steps=STEPS)
    (_, fs), (_, fr) = port(STEPS), plain(STEPS)
    np.testing.assert_allclose(fs.numpy(), fr.numpy(), rtol=4 * 2.0**-24,
                               atol=0)


@pytest.mark.parametrize("name", DECOMPOSABLE)
def test_decomposable_spec_matches_reference(name):
    to, jo = _make(name, 8)
    assert to.decomposable is not None and jo.decomposable is not None
    ts, js = to.decomposable, jo.decomposable
    assert (ts.n_sum, ts.n_prod) == (js.n_sum, js.n_prod)
    x = _points(to, chains=32, seed=len(name))
    S_t, (lp_t, sg_t) = ts.init_acc(torch.from_numpy(x))
    S_j, (lp_j, sg_j) = js.init_acc(x)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=2e-6, atol=2e-5)
    np.testing.assert_array_equal(sg_t.numpy(), np.asarray(sg_j))
    v_t = ts.value(S_t, (lp_t, sg_t), to.dim).numpy()
    v_j = np.asarray(js.value(S_j, (lp_j, sg_j), to.dim))
    f_j = np.asarray(jo(x))
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v_t, f_j, rtol=1e-4, atol=1e-3)
    # One coordinate's terms, the O(1) update's operands.
    d = np.arange(32) % to.dim
    xi = x[np.arange(32), d]
    for a, b in zip(ts.terms(torch.from_numpy(xi), torch.from_numpy(d)),
                    js.terms(xi, d)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["schwefel", "griewank", "cosine_mixture",
                                  "shubert"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sweep_delta_follows_sweep_full(name, dtype):
    """The O(1) sweep takes the full sweep's accept decisions: states agree
    on at least 95% of the rows bit for bit and f to float rounding."""
    obj, _ = _make(name, 8)
    x = torch.from_numpy(_points(obj, seed=5)).to(dtype)
    xd, fd = tmet.sweep_delta(x, 2.0, 3, 0, objective=obj, n_steps=STEPS)
    xf, ff = tmet.sweep_full(x, obj(x), 2.0, 3, 0, objective=obj,
                             n_steps=STEPS)
    same = (xd == xf).all(1)
    assert same.float().mean() >= 0.95
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    np.testing.assert_allclose(fd[same].numpy(), ff[same].numpy(),
                               rtol=tol, atol=tol)
    assert xd.dtype == dtype and fd.dtype == dtype


def test_sweep_delta_needs_a_decomposable_objective():
    obj = TF.branin()
    x = torch.zeros(4, 2)
    with pytest.raises(AssertionError, match="no decomposable structure"):
        tmet.sweep_delta(x, 1.0, 0, 0, objective=obj, n_steps=1)
    with pytest.raises(TypeError, match="float32 or float64"):
        tmet.sweep_full(x.half(), obj(x).half(), 1.0, 0, 0, objective=obj,
                        n_steps=1)


def test_float64_draws_keep_float32_bits_and_widen_to_53():
    seed = torch.tensor([3, 2**31 + 9])[:, None]
    cidx = torch.arange(4096)[None, :]
    r0, u32, a32 = trng.draws3(seed, cidx, 2**32 - 1)
    s0, u64, a64 = trng.draws3_f64(seed, cidx, 2**32 - 1)
    np.testing.assert_array_equal(r0.numpy(), s0.numpy())
    # The exchange operators' single-block uniform is draws3's.
    assert torch.equal(trng.value_uniform(seed, cidx, 2**32 - 1), u32)
    for wide, narrow in ((u64, u32), (a64, a32)):
        assert wide.dtype == torch.float64
        assert bool(((wide >= 0) & (wide < 1)).all())
        ints = wide * 2.0**53
        assert bool((ints == torch.floor(ints)).all())       # 53-bit grid
        # The top 24 bits are the float32 uniform's.
        np.testing.assert_array_equal(
            (torch.floor(wide * 2.0**24) / 2.0**24).numpy(),
            narrow.to(torch.float64).numpy())
        # Bits below the 24th are used.
        assert float((ints % 2.0**29 != 0).double().mean()) > 0.99
    assert not torch.equal(u64, a64)


def test_float64_sweep_stays_in_the_box_and_carries_f():
    obj = TF.langerman(5)
    x = torch.from_numpy(_points(obj, seed=2, dtype=np.float64))
    xs, fs = tmet.sweep_full(x, obj(x), torch.full((CHAINS,), 0.3,
                                                   dtype=torch.float64),
                             1, 0, objective=obj, n_steps=STEPS)
    assert xs.dtype == fs.dtype == torch.float64
    assert bool(((xs >= 0) & (xs <= 10)).all())
    assert torch.equal(fs, obj(xs))
    assert bool((xs != x).any())
