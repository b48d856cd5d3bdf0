"""Plain version of kernel B1 (repro_torch.kernels.ref and the CPU path of
metropolis_sweep_kernel) vs the JAX package's oracle and its Pallas kernel
in interpret mode, under the parity contract of torch_parity.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import objective_math as jom
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rng as jrng
from repro.kernels.metropolis_sweep import metropolis_sweep_pallas
from repro_torch.kernels import objective_math as tom
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.metropolis_sweep import metropolis_sweep_kernel

from torch_parity import assert_sweep_parity

CHAINS, DIM, STEPS = 64, 8, 12


def _x(kids_per_row, dim=DIM, seed=0):
    rs = np.random.default_rng(seed)
    lo = np.array([jom.BOX[int(k)][0] for k in kids_per_row], np.float32)[:, None]
    hi = np.array([jom.BOX[int(k)][1] for k in kids_per_row], np.float32)[:, None]
    return (lo + rs.random((len(kids_per_row), dim)) * (hi - lo)).astype(np.float32)


def _rows(v, n):
    a = np.asarray(v).reshape(-1)
    return np.broadcast_to(a, (n,)) if a.size == 1 else a


def _expand(v, blk):
    return np.repeat(np.asarray(v).reshape(-1), blk)


@pytest.mark.parametrize("variant", ["full", "delta"])
@pytest.mark.parametrize("kid", [0, 1, 2, 3, 4, 5])
def test_plain_sweep_matches_oracle(kid, variant):
    x = _x([kid] * CHAINS, seed=kid)
    assert_sweep_parity(
        x,
        lambda k: tref.metropolis_sweep_ref(torch.from_numpy(x), 3.0, 42, 2**31 - 4,
                                            kid=kid, n_steps=k, variant=variant),
        lambda k: jref.metropolis_sweep_ref(x, 3.0, 42, 2**31 - 4, kid=kid,
                                            n_steps=k, variant=variant),
        kid=_rows(kid, CHAINS),
                        T=_rows(3.0, CHAINS), seed=_rows(42, CHAINS),
                        step0=_rows(2**31 - 4, CHAINS),
                        cidx=np.arange(CHAINS), variant=variant, n_steps=STEPS)


@pytest.mark.parametrize("variant", ["full", "delta"])
def test_per_block_controls_match_pallas_interpret(variant):
    """Per-block kid, T, seed, step0, shuffled chain_base and a live mask
    through the port's wrapper (CPU path) and the Pallas kernel."""
    blk, n_blocks = 16, 4
    kids = np.array([0, 3, 1, 2], np.int32)
    T = np.array([5.0, 50.0, 1.0, 0.5], np.float32)
    seeds = np.array([1, 2**32 - 1, 77, 12345], np.uint32)
    step0 = np.array([0, 2**31 + 3, 2**32 - 5, 40], np.uint32)
    base = np.array([48, 0, 1000, 2**31], np.uint32)
    live = np.array([1, 0, 1, 1], np.int32)
    x = _x(_expand(kids, blk), seed=5)

    def pallas(k):
        return metropolis_sweep_pallas(
            jnp.asarray(x), jnp.asarray(T), jnp.asarray(seeds), jnp.asarray(step0),
            kid=jnp.asarray(kids), n_steps=k, blk=blk, variant=variant,
            interpret=True, chain_base=jnp.asarray(base), live=jnp.asarray(live))

    def port(k):
        return metropolis_sweep_kernel(
            torch.from_numpy(x), torch.from_numpy(T), seeds, step0,
            kid=torch.from_numpy(kids), n_steps=k, blk=blk, variant=variant,
            chain_base=base, live=torch.from_numpy(live))

    xp, _ = port(STEPS)
    cidx = _expand(base, blk).astype(np.int64) + np.tile(np.arange(blk), n_blocks)
    assert_sweep_parity(x, port, pallas, kid=_expand(kids, blk),
                        T=_expand(T, blk), seed=_expand(seeds, blk),
                        step0=_expand(step0, blk), cidx=cidx, variant=variant,
                        n_steps=STEPS)
    dead = slice(blk, 2 * blk)
    np.testing.assert_array_equal(xp.numpy()[dead], x[dead])


def test_t_chain_matches_oracle_and_block_t():
    """Per-chain temperatures; rows carrying their block's T are
    bit-identical to the per-block path."""
    blk = 16
    x = _x([2] * 32, seed=3)
    t_chain = np.repeat(np.array([0.3, 4.0], np.float32), 16)
    t_chain[5] = 100.0

    def port(k):
        return metropolis_sweep_kernel(torch.from_numpy(x), [0.3, 4.0], 9, 0,
                                       kid=2, n_steps=k, blk=blk,
                                       t_chain=torch.from_numpy(t_chain))

    xp, fp = port(STEPS)
    assert_sweep_parity(x, port,
                        lambda k: jref.metropolis_sweep_ref(
                            x, jnp.asarray(t_chain), 9, 0, kid=2, n_steps=k),
                        kid=_rows(2, 32), T=t_chain,
                        seed=_rows(9, 32), step0=_rows(0, 32),
                        cidx=np.arange(32), variant="delta", n_steps=STEPS)
    xb, fb = metropolis_sweep_kernel(torch.from_numpy(x), [0.3, 4.0], 9, 0,
                                     kid=2, n_steps=STEPS, blk=blk)
    keep = np.arange(32) != 5
    assert torch.equal(xp[keep], xb[keep]) and torch.equal(fp[keep], fb[keep])


@pytest.mark.parametrize("dim", [1, 3])
@pytest.mark.parametrize("kid", [0, 1, 2, 3, 4, 5])
def test_collision_heavy_delta_matches_oracle(kid, dim):
    """At dim 1 and 3 nearly every step proposes a coordinate that an
    earlier step changed: the card stages proposals ahead of its walk and
    resolves such steps there, against this plain version.  step0 sits
    near the top of the int32 range that the JAX oracle takes."""
    x = _x([kid] * CHAINS, dim=dim, seed=kid)
    T, seed, step0, n_steps = 3.0, 42, 2**31 - 20, 64
    assert_sweep_parity(
        x,
        lambda k: tref.metropolis_sweep_ref(torch.from_numpy(x), T, seed, step0,
                                            kid=kid, n_steps=k),
        lambda k: jref.metropolis_sweep_ref(x, T, seed, step0, kid=kid, n_steps=k),
        kid=_rows(kid, CHAINS), T=_rows(T, CHAINS), seed=_rows(seed, CHAINS),
        step0=_rows(step0, CHAINS), cidx=np.arange(CHAINS), variant="delta",
        n_steps=n_steps)


@pytest.mark.parametrize("dim", [1, 3])
@pytest.mark.parametrize("kid", [0, 1, 2, 3, 4, 5])
def test_collision_heavy_full_matches_oracle(kid, dim):
    """The full variant where nearly every step revisits a coordinate that
    an earlier step changed: the card keeps each coordinate's terms cached
    and re-folds them, and is held to this plain version there."""
    x = _x([kid] * CHAINS, dim=dim, seed=kid)
    T, seed, step0, n_steps = 3.0, 42, 2**31 - 20, 64
    assert_sweep_parity(
        x,
        lambda k: tref.metropolis_sweep_ref(torch.from_numpy(x), T, seed, step0,
                                            kid=kid, n_steps=k, variant="full"),
        lambda k: jref.metropolis_sweep_ref(x, T, seed, step0, kid=kid, n_steps=k,
                                            variant="full"),
        kid=_rows(kid, CHAINS), T=_rows(T, CHAINS), seed=_rows(seed, CHAINS),
        step0=_rows(step0, CHAINS), cidx=np.arange(CHAINS), variant="full",
        n_steps=n_steps)


def test_padded_chains_match_oracle():
    """A ragged chain count pads with dummy chains that do not perturb the
    real ones."""
    x = _x([1] * 60, seed=11)

    def port(k):
        return metropolis_sweep_kernel(torch.from_numpy(x), 2.0, 3, 7, kid=1,
                                       n_steps=k, blk=16)

    xp, fp = port(STEPS)
    assert xp.shape == (60, DIM) and fp.shape == (60,)
    assert_sweep_parity(x, port,
                        lambda k: jref.metropolis_sweep_ref(x, 2.0, 3, 7, kid=1, n_steps=k),
                        kid=_rows(1, 60), T=_rows(2.0, 60),
                        seed=_rows(3, 60), step0=_rows(7, 60),
                        cidx=np.arange(60), variant="delta", n_steps=STEPS)


def test_blocking_invariance_bit_identical():
    x = torch.from_numpy(_x([1] * 32))
    outs = [metropolis_sweep_kernel(x, 2.0, 3, 0, kid=1, n_steps=10, blk=blk)
            for blk in (8, 16, 32)]
    for xo, fo in outs[1:]:
        assert torch.equal(outs[0][0], xo) and torch.equal(outs[0][1], fo)


def test_sweep_slots_matches_reference_ops():
    blk = 8
    kids = np.array([3, 0, 5, 1], np.int32)
    T = np.array([2.0, 9.0, 0.7, 1.5], np.float32)
    seeds = np.array([4, 4, 8, 2**31], np.uint32)
    step0 = np.array([10, 0, 2**32 - 3, 99], np.uint32)
    base = np.array([16, 0, 8, 24], np.uint32)
    live = np.array([1, 1, 0, 1], np.int32)
    x = _x(_expand(kids, blk), seed=2)

    def port(k):
        return tops.metropolis_sweep_slots(x, kids, T, seeds, step0, base,
                                           n_steps=k, blk=blk, live=live,
                                           device="cpu")

    xp, _ = port(STEPS)
    cidx = _expand(base, blk).astype(np.int64) + np.tile(np.arange(blk), 4)
    assert_sweep_parity(x, port,
                        lambda k: jops.metropolis_sweep_slots(
                            x, kids, T, seeds, step0, base, n_steps=k, blk=blk,
                            live=live),
                        kid=_expand(kids, blk),
                        T=_expand(T, blk), seed=_expand(seeds, blk),
                        step0=_expand(step0, blk), cidx=cidx, variant="delta",
                        n_steps=STEPS)
    np.testing.assert_array_equal(xp.numpy()[2 * blk:3 * blk], x[2 * blk:3 * blk])


def test_single_job_ops_matches_reference_ops():
    x = _x([0] * 40, seed=4)
    assert_sweep_parity(x,
                        lambda k: tops.metropolis_sweep(x, 10.0, 5, 30, kid=0, n_steps=k,
                                                        variant="full", device="cpu"),
                        lambda k: jops.metropolis_sweep(x, 10.0, 5, 30, kid=0, n_steps=k,
                                                        variant="full"),
                        kid=_rows(0, 40), T=_rows(10.0, 40),
                        seed=_rows(5, 40), step0=_rows(30, 40),
                        cidx=np.arange(40), variant="full", n_steps=STEPS)
    assert tops.kid_for(object()) is None


@pytest.mark.parametrize("call,match", [
    (lambda x: metropolis_sweep_kernel(x, 1.0, 0, 0, kid=6, n_steps=2), "outside the kernel registry"),
    (lambda x: metropolis_sweep_kernel(x, 1.0, 0, 0, kid=[0, -1], n_steps=2, blk=16), "outside the kernel registry"),
    (lambda x: metropolis_sweep_kernel(x, [1.0, 2.0, 3.0], 0, 0, kid=0, n_steps=2, blk=16), "3 entries for a 2-block grid"),
    (lambda x: metropolis_sweep_kernel(x[:30], [1.0, 2.0], 0, 0, kid=0, n_steps=2, blk=16), "must be a multiple of blk"),
    (lambda x: metropolis_sweep_kernel(x[:30], 1.0, 0, 0, kid=0, n_steps=2, blk=16, live=[1, 1]), "must be a multiple of blk"),
    (lambda x: metropolis_sweep_kernel(x, 1.0, 0, 0, kid=0, n_steps=2, blk=16, t_chain=[1.0] * 31), "t_chain has 31 entries"),
    (lambda x: metropolis_sweep_kernel(x, 1.0, 0, 0, kid=0, n_steps=2, variant="fast"), "variant"),
    (lambda x: tops.metropolis_sweep_slots(x[:30], 0, 1.0, 0, 0, 0, n_steps=2, blk=16, device="cpu"), "multiple of blk=16"),
])
def test_eager_errors(call, match):
    x = torch.zeros(32, 4)
    with pytest.raises(ValueError, match=match):
        call(x)


@pytest.mark.parametrize("kid", range(6))
def test_proposal_matches_xla_fused_multiply_add(kid):
    """XLA contracts the oracle's lo + u * (hi - lo) into one FMA; the
    port's proposal rounds once too, so the new coordinate is bit-equal."""
    u = np.array(jrng.draws3(42, jnp.arange(100_000, dtype=jnp.uint32), 7)[1])
    lo, hi = np.float32(jom.BOX[kid][0]), np.float32(jom.BOX[kid][1])
    xla = np.asarray(jax.jit(lambda u: lo + u * (hi - lo))(jnp.asarray(u)))
    lo_t, _, width = tom.box_f32(kid)
    port = tref.proposal(lo_t, width, torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(port, xla)
