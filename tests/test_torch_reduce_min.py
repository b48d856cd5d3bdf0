"""Plain version of kernel B2 (argmin_reduce_plain, and argmin_reduce on
CPU tensors) vs repro.kernels.reduce_min: bit for bit, fp32 and bf16,
first-index ties, ragged n."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.reduce_min import argmin_reduce as j_argmin
from repro_torch.kernels.reduce_min import argmin_reduce, argmin_reduce_plain

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(f32, dtype):
    jd, td = _DT[dtype]
    fj = jnp.asarray(f32).astype(jd)
    ft = torch.from_numpy(np.array(fj.astype(jnp.float32))).to(td)
    return fj, ft


def _assert_same(fj, ft, blk, use_pallas=True):
    mj, ij = j_argmin(fj, blk=blk, use_pallas=use_pallas, interpret=True)
    mt, it = argmin_reduce(ft, blk=blk)
    assert it.dtype == torch.int32 and mt.dtype == ft.dtype
    assert int(it) == int(ij)
    assert float(mt) == float(mj) or (np.isnan(float(mt)) and np.isnan(float(mj)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,blk", [(64, 8), (256, 64), (1024, 128), (4096, 1024)])
def test_matches_reference_kernel(n, blk, dtype):
    f = np.random.default_rng(n + blk).standard_normal(n).astype(np.float32)
    _assert_same(*_both(f, dtype), blk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ties_within_and_across_tiles(dtype):
    f = np.full(64, 2.0, np.float32)
    f[[9, 11, 40, 63]] = -1.0   # tie inside tile 1 and across tiles 1 and 5
    _assert_same(*_both(f, dtype), 8)
    mt, it = argmin_reduce(_both(f, dtype)[1], blk=8)
    assert int(it) == 9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 1000, 1025, 16384 + 1])
def test_ragged_n_matches_reference(n, dtype):
    """The reference drops to jnp.argmin when n % blk; the port's tiles
    mask the ragged edge and give the same answer."""
    rs = np.random.default_rng(n)
    f = rs.standard_normal(n).astype(np.float32)
    if n > 2:
        f[[n // 3, n - 1]] = f.min() - 1.0   # tie, the second in the last tile
    _assert_same(*_both(f, dtype), 1024, use_pallas=False)


def test_nan_and_inf_follow_jnp_argmin():
    f = np.array([3.0, np.inf, np.nan, -np.inf, np.nan], np.float32)
    _assert_same(*_both(f, "float32"), 2, use_pallas=False)
    g = np.full(9, np.inf, np.float32)
    _assert_same(*_both(g, "float32"), 4, use_pallas=False)


def test_plain_is_the_cpu_path_and_rejects_bad_input():
    f = torch.tensor([5.0, 1.0, 1.0])
    assert [int(v) for v in argmin_reduce_plain(f)[1:]] == [1]
    with pytest.raises(ValueError):
        argmin_reduce(torch.zeros(2, 2))
    with pytest.raises(ValueError):
        argmin_reduce(torch.zeros(0))
    with pytest.raises(TypeError):
        argmin_reduce(torch.zeros(3, dtype=torch.float64))
