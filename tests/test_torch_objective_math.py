"""Port objective math and objective suite vs the JAX package.

Per evaluation f agrees to float32 rounding: rtol 1e-5, scaled by dim
where a sum over coordinates is compared (torch and XLA sum in different
orders, and their sin/cos/exp/log differ by up to an ULP).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import objective_math as jom
from repro.objectives import SUITE as JSUITE
from repro_torch.kernels import objective_math as tom
from repro_torch.objectives import SUITE as TSUITE
from repro_torch.objectives import functions as TF

DIM = 16
_MAKERS = {tom.KID_SCHWEFEL: TF.schwefel, tom.KID_RASTRIGIN: TF.rastrigin,
           tom.KID_ACKLEY: TF.ackley, tom.KID_GRIEWANK: TF.griewank,
           tom.KID_EXPONENTIAL: TF.exponential, tom.KID_SALOMON: TF.salomon}


def _x(kid, rows=32, dim=DIM, seed=0):
    lo, hi = tom.BOX[kid]
    rs = np.random.default_rng(seed + kid)
    return (lo + rs.random((rows, dim)) * (hi - lo)).astype(np.float32)


def _close(a, b, scale=1.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5 * scale, atol=1e-5 * scale)


def test_constants_match_reference():
    assert tom.KID_BY_NAME == jom.KID_BY_NAME
    assert tom.BOX == jom.BOX and tom.N_KIDS == jom.N_KIDS


@pytest.mark.parametrize("kid", range(6))
def test_static_forms_match_reference(kid):
    x = _x(kid)
    xt = torch.from_numpy(x)
    _close(tom.full_eval(kid, xt, DIM), jom.full_eval(kid, jnp.asarray(x), DIM), DIM)
    d = np.arange(DIM, dtype=np.float32)[None, :, None].repeat(x.shape[0], 0)
    s_t, p_t = tom.term(kid, xt[..., None], torch.from_numpy(d))
    s_j, p_j = jom.term(kid, jnp.asarray(x)[..., None], jnp.asarray(d))
    _close(s_t, s_j)
    _close(p_t, p_j)
    acc_t = tom.init_acc(kid, xt)
    acc_j = jom.init_acc(kid, jnp.asarray(x))
    for a, b in zip(acc_t, acc_j):
        _close(a, b, DIM)
    f_t = tom.combine(kid, *acc_j_to_t(acc_j), DIM)
    _close(f_t, jom.combine(kid, *acc_j, DIM))


def acc_j_to_t(acc):
    return [torch.from_numpy(np.array(a)) for a in acc]


def test_runtime_forms_equal_static_bit_for_bit():
    """A mixed kid column selects each row's static branch verbatim."""
    rows = [_x(k, rows=4)[:, :DIM] for k in range(6)]
    x = torch.from_numpy(np.concatenate(rows))
    kid = torch.arange(6).repeat_interleave(4)[:, None]
    f_rt = tom.full_eval_rt(kid, x, DIM)
    acc_rt = tom.init_acc_rt(kid, x)
    comb_rt = tom.combine_rt(kid, *acc_rt, DIM)
    d = torch.full((x.shape[0], 1), 3.0)
    term_rt = tom.term_rt(kid, x[:, 3:4], d)
    lo, hi, width = tom.box_rt(kid[:, 0])
    for k in range(6):
        r = slice(4 * k, 4 * k + 4)
        assert torch.equal(f_rt[r], tom.full_eval(k, x, DIM)[r])
        acc = tom.init_acc(k, x)
        for a, b in zip(acc_rt, acc):
            assert torch.equal(a[r], b[r])
        assert torch.equal(comb_rt[r], tom.combine(k, *acc, DIM)[r])
        for a, b in zip(term_rt, tom.term(k, x[:, 3:4], d)):
            assert torch.equal(a[r], b[r])
        assert (lo[r] == tom.box_f32(k)[0]).all() and (width[r] == tom.box_f32(k)[2]).all()


@pytest.mark.parametrize("kid", range(6))
def test_full_eval_matches_port_objectives(kid):
    obj = _MAKERS[kid](DIM)
    assert obj.kernel_id == kid
    x = torch.from_numpy(_x(kid, rows=8, seed=7))
    np.testing.assert_allclose(tom.full_eval(kid, x, DIM)[:, 0].numpy(),
                               obj(x).numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ref", sorted(TSUITE))
def test_suite_objective_matches_reference(ref):
    jobj, tobj = JSUITE[ref](), TSUITE[ref]()
    assert (jobj.name, jobj.dim, jobj.f_opt, jobj.kernel_id) == (
        tobj.name, tobj.dim, tobj.f_opt, tobj.kernel_id)
    np.testing.assert_array_equal(jobj.lower, tobj.lower)
    np.testing.assert_array_equal(jobj.upper, tobj.upper)
    if jobj.x_opt is None:
        assert tobj.x_opt is None
    else:
        np.testing.assert_array_equal(jobj.x_opt, tobj.x_opt)
    rs = np.random.default_rng(len(ref))
    x = (jobj.lower + rs.random((64, jobj.dim)) * (jobj.upper - jobj.lower)).astype(np.float32)
    fj = np.asarray(jobj(jnp.asarray(x)))
    ft = tobj(torch.from_numpy(x)).numpy()
    assert ft.dtype == np.float32
    scale = np.abs(fj).max() + 1.0  # terms of any sign cancel inside a sum
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-5 * scale * max(1, jobj.dim ** 0.5))
