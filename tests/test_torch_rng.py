"""Port RNG (repro_torch.kernels.rng) vs repro.kernels.rng: bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rng as jrng
from repro_torch.kernels import rng as trng


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("vec,want", [
    ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
])
def test_random123_vectors(vec, want):
    x0, x1 = trng.threefry2x32(*vec)
    assert (int(x0), int(x1)) == want


def test_threefry_matches_reference():
    k0, k1, x0, x1 = (_u32(2048, s) for s in range(4))
    r0, r1 = jrng.threefry2x32(k0, k1, x0, x1)
    p0, p1 = trng.threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1))
    np.testing.assert_array_equal(np.asarray(r0).astype(np.int64), p0.numpy())
    np.testing.assert_array_equal(np.asarray(r1).astype(np.int64), p1.numpy())


def test_uniform_from_bits_matches_reference():
    bits = np.concatenate([_u32(4096, 9), np.array([0, 255, 256, 2**32 - 1], np.uint32)])
    u = trng.uniform_from_bits(_t(bits))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jrng.uniform_from_bits(jnp.asarray(bits))),
                                  u.numpy())
    assert float(u.max()) < 1.0 and float(u.min()) >= 0.0


# Steps include 2^31 and above, where 2*step wraps past 2^32.
@pytest.mark.parametrize("step", [0, 9, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1])
def test_draws3_matches_reference(step):
    seed = int(_u32(1, step % 1000)[0])
    cidx = _u32(1024, step % 997)
    r = jrng.draws3(seed, jnp.asarray(cidx), np.uint32(step))
    p = trng.draws3(seed, _t(cidx), step)
    np.testing.assert_array_equal(np.asarray(r[0]).astype(np.int64), p[0].numpy())
    np.testing.assert_array_equal(np.asarray(r[1]), p[1].numpy())
    np.testing.assert_array_equal(np.asarray(r[2]), p[2].numpy())


def test_draws3_per_chain_columns():
    """Per-chain seed/step columns broadcast like the kernel's controls."""
    seed, step, cidx = _u32(64, 1), _u32(64, 2), _u32(64, 3)
    r = jrng.draws3(jnp.asarray(seed), jnp.asarray(cidx), jnp.asarray(step))
    p = trng.draws3(_t(seed), _t(cidx), _t(step))
    for a, b in zip(r, p):
        np.testing.assert_array_equal(np.asarray(a).astype(b.numpy().dtype), b.numpy())
