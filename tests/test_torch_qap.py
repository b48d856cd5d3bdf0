"""The port's QAP path against the JAX package: instances, the plain
version of kernel B3 (``repro_torch.kernels.ref`` and the CPU path of
``qap_sweep_kernel``), ``qap_sweep_slots`` and the eager errors.  QAP data
are small integers, so every comparison here is bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.qap_sweep import qap_full_cost as jcost
from repro.kernels.qap_sweep import qap_sweep_pallas
from repro.objectives import families as jfam
from repro.objectives import qap as jqap
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qap_sweep as tqs
from repro_torch.kernels import ref as tref
from repro_torch.objectives import families as tfam
from repro_torch.objectives import qap as tqap


def _perms(rs, chains, n):
    return np.stack([rs.permutation(n) for _ in range(chains)]).astype(np.int32)


def _instances(rs, n, count):
    F = rs.integers(0, 10, (count, n, n)).astype(np.float32)
    D = rs.integers(0, 10, (count, n, n)).astype(np.float32)
    return F, D


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("name", sorted(jqap.INSTANCES))
def test_instances_equal_the_reference(name):
    a, b = jqap.get(name), tqap.get(name)
    np.testing.assert_array_equal(a.F, b.F)
    np.testing.assert_array_equal(a.D, b.D)
    assert (a.best_known, a.p_best, a.proven, a.n) == \
        (b.best_known, b.p_best, b.proven, b.n)
    assert b.cost(np.asarray(b.p_best)) == b.best_known
    assert tqap.INSTANCE_ID == jqap.INSTANCE_ID
    assert tfam.F_OPT_BY_NAME == jfam.F_OPT_BY_NAME
    assert tfam.PERMUTATION.servable() == jfam.PERMUTATION.servable()


@pytest.mark.parametrize("name", sorted(jqap.INSTANCES))
def test_full_cost_is_exact(name):
    inst = tqap.get(name)
    p = _perms(np.random.default_rng(3), 64, inst.n)
    p[0] = inst.p_best
    port = tref.qap_full_cost(torch.from_numpy(p), torch.tensor(inst.F),
                              torch.tensor(inst.D)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jcost(p, inst.F, inst.D))[:, 0])
    np.testing.assert_array_equal(port, inst.cost(p).astype(np.float32))
    assert port[0] == inst.best_known


def test_full_cost_per_chain_matrices():
    rs = np.random.default_rng(4)
    F, D = _instances(rs, 7, 16)
    p = _perms(rs, 16, 7)
    port = tref.qap_full_cost(torch.from_numpy(p), torch.from_numpy(F),
                              torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jcost(p, F, D))[:, 0])


def _controls(rs, chains):
    return dict(
        T=(10.0 ** rs.uniform(-1, 2, chains)).astype(np.float32),
        seed=rs.integers(0, 2**32, chains, dtype=np.uint64).astype(np.uint32),
        step0=(2**32 - 8 + rs.integers(0, 16, chains)).astype(np.uint64)
        .astype(np.uint32),
        cidx=rs.integers(0, 2**32, chains, dtype=np.uint64).astype(np.uint32),
        live=rs.random(chains) < 0.75)


@pytest.mark.parametrize("case", ["syn10", "grid12", 2, 3, 5, 12, 20, 31, 32])
def test_plain_sweep_matches_oracle(case):
    """Per-chain T, seed, step0 (wrapping past 2^32), chain index and live
    mask; the registered instances shared by every chain, random integer
    instances one per chain."""
    rs = np.random.default_rng(7)
    chains = 48
    if isinstance(case, str):
        inst = jqap.get(case)
        n, F, D = inst.n, inst.F, inst.D
    else:
        n = case
        F, D = _instances(rs, n, chains)
    p = _perms(rs, chains, n)
    c = _controls(rs, chains)
    pj, fj = jref.qap_sweep_ref(p, F, D, c["T"], c["seed"], c["step0"],
                                n_steps=24, cidx=c["cidx"], live=c["live"])
    pt, ft = tref.qap_sweep_ref(torch.from_numpy(p), torch.tensor(F),
                                torch.tensor(D), **{k: _t(v) for k, v in c.items()
                                                    if k in ("T", "seed", "step0")},
                                n_steps=24, cidx=_t(c["cidx"]), live=_t(c["live"]))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert pt.dtype == torch.int32
    dead = ~c["live"]
    np.testing.assert_array_equal(pt.numpy()[dead], p[dead])
    assert (pt.numpy()[c["live"]] != p[c["live"]]).any()
    per_chain = (F, D) if F.ndim == 3 else (np.broadcast_to(F, (chains, n, n)),
                                           np.broadcast_to(D, (chains, n, n)))
    host = (per_chain[0].astype(np.int64)
            * per_chain[1].astype(np.int64)[np.arange(chains)[:, None, None],
                                             pt.numpy()[:, :, None],
                                             pt.numpy()[:, None, :]]).sum((1, 2))
    np.testing.assert_array_equal(ft.numpy(), host.astype(np.float32))


def test_wrapper_matches_pallas_interpret():
    """Two blocks of 8 chains on syn10 and a random n = 10 instance, with
    per-block controls, a shuffled chain_base and a dead block."""
    rs = np.random.default_rng(11)
    n, blk = 10, 8
    F2, D2 = _instances(rs, n, 1)
    F = np.concatenate([jqap.get("syn10").F, F2[0]])
    D = np.concatenate([jqap.get("syn10").D, D2[0]])
    p = _perms(rs, 2 * blk, n)
    T = np.array([3.0, 20.0], np.float32)
    seed = np.array([5, 2**32 - 3], np.uint32)
    step0 = np.array([2**32 - 2, 9], np.uint32)
    base = np.array([8, 0], np.uint32)
    for live in (np.array([1, 1], np.int32), np.array([0, 1], np.int32)):
        pj, fj = qap_sweep_pallas(jnp.asarray(p), F, D, jnp.asarray(T),
                                  jnp.asarray(seed), jnp.asarray(step0),
                                  n_steps=8, blk=blk, interpret=True,
                                  chain_base=jnp.asarray(base),
                                  live=jnp.asarray(live))
        pt, ft = tqs.qap_sweep_kernel(torch.from_numpy(p), F, D, T, _t(seed),
                                      _t(step0), n_steps=8, blk=blk,
                                      chain_base=_t(base), live=live)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def _operands(F, D, packed):
    """Per-block (nb, n, n) F and D as the slot sweep takes them: both
    packed (True), one (n, n) for every block (False), or only F or only
    D packed and the other one (n, n)."""
    nb, n, _ = F.shape
    return (F.reshape(nb * n, n) if packed in (True, "F") else F[0],
            D.reshape(nb * n, n) if packed in (True, "D") else D[0])


@pytest.mark.parametrize("packed", [True, False, "F", "D"])
def test_slots_match_reference(packed):
    rs = np.random.default_rng(13)
    n, blk, nb = 12, 8, 4
    F, D = _operands(*_instances(rs, n, nb), packed)
    p = _perms(rs, nb * blk, n)
    T = np.array([1.0, 5.0, 20.0, 0.3], np.float32)
    seeds = np.array([1, 2**31 + 5, 7, 9], np.uint32)
    step0 = np.array([0, 100, 2**32 - 3, 5], np.uint32)
    base = np.array([24, 0, 8, 16], np.uint32)
    live = np.array([1, 0, 1, 1], np.int32)
    pj, fj = jops.qap_sweep_slots(p, F, D, T, seeds, step0, base, n_steps=20,
                                  blk=blk, live=live)
    pt, ft = tops.qap_sweep_slots(p, F, D, T, seeds, step0, base, n_steps=20,
                                  blk=blk, live=live, device="cpu")
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    out = torch.empty_like(pt)
    po, _ = tops.qap_sweep_slots(p, F, D, T, seeds, step0, base, n_steps=20,
                                 blk=blk, live=live, device="cpu", out=out)
    assert po is out and torch.equal(out, pt)


@pytest.mark.parametrize("bad, match", [
    (dict(blk=6), "must be a multiple of blk"),
    (dict(F=np.zeros((3 * 5, 5), np.float32)), "F_blocks must be"),
    (dict(D=np.zeros((5, 4), np.float32)), "D_blocks must be"),
    (dict(T=np.ones(3, np.float32)), "T has 3 entries for a 2-block grid"),
    (dict(seed=np.zeros(3, np.uint32)), "seed has 3 entries"),
    (dict(step0=np.zeros(4, np.uint32)), "step0 has 4 entries"),
    (dict(chain_base=np.zeros(3, np.uint32)), "chain_base has 3 entries"),
    (dict(live=np.ones(5, np.int32)), "live has 5 entries"),
])
def test_eager_errors_match_reference(bad, match):
    rs = np.random.default_rng(0)
    n, blk = 5, 8
    kw = dict(F=np.ones((n, n), np.float32), D=np.ones((n, n), np.float32),
              T=1.0, seed=0, step0=0, blk=blk, chain_base=None, live=None)
    kw.update(bad)
    p = _perms(rs, 2 * blk, n)

    def call(fn, conv):
        return fn(conv(p), kw["F"], kw["D"], kw["T"], kw["seed"], kw["step0"],
                  n_steps=1, blk=kw["blk"], chain_base=kw["chain_base"],
                  live=kw["live"])

    with pytest.raises(ValueError, match=match):
        call(lambda *a, **k: qap_sweep_pallas(*a, interpret=True, **k), jnp.asarray)
    with pytest.raises(ValueError, match=match):
        call(tqs.qap_sweep_kernel, torch.from_numpy)


def test_permutation_length_bound():
    p = torch.from_numpy(_perms(np.random.default_rng(0), 8, tqs.MAX_N + 1))
    M = np.ones((tqs.MAX_N + 1,) * 2, np.float32)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        tqs.qap_sweep_kernel(p, M, M, 1.0, 0, 0, n_steps=1, blk=8)
    with pytest.raises(ValueError, match="int32"):
        tqs.qap_sweep_kernel(p.long(), M, M, 1.0, 0, 0, n_steps=1, blk=8)


@pytest.fixture
def card():
    """Decided here, not at import: the CUDA kernel runs only where there
    is a card (chip_smoke.py drives it at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cuda_qap_kernel_matches_plain(card):
    rs = np.random.default_rng(1)
    n, blk, nb = 12, 64, 4
    F, D = _instances(rs, n, nb)
    p = torch.from_numpy(_perms(rs, nb * blk, n)).to(card)
    args = (torch.from_numpy(F.reshape(-1, n)).to(card),
            torch.from_numpy(D.reshape(-1, n)).to(card),
            torch.tensor([1.0, 5.0, 20.0, 0.3], device=card), 3, 2**31)
    kw = dict(n_steps=30, blk=blk, live=torch.tensor([1, 0, 1, 1], device=card))
    launches = tqs.counter.launches
    pk, fk = tqs.qap_sweep_kernel(p, *args, **kw)
    torch.cuda.synchronize()
    assert tqs.counter.launches == launches + 1
    pp, fp = tqs.qap_sweep_plain(p, *args, **kw)
    assert torch.equal(pk, pp) and torch.equal(fk, fp)


@pytest.mark.parametrize("blk", [32, 96, 512])
@pytest.mark.parametrize("n", [2, 31, 32])
def test_cuda_qap_kernel_lane_groups_match_plain(card, n, blk):
    """Lane groups of every width (n = 2, 31, 32), blocks that fill no whole
    CTA (blk 96) or one CTA exactly, and a dead block: bit for bit."""
    rs = np.random.default_rng(n + blk)
    nb = 4
    F, D = _instances(rs, n, nb)
    p = torch.from_numpy(_perms(rs, nb * blk, n)).to(card)
    args = (torch.from_numpy(F.reshape(-1, n)).to(card),
            torch.from_numpy(D.reshape(-1, n)).to(card),
            torch.tensor([1.0, 5.0, 20.0, 0.3], device=card), 3, 2**32 - 7)
    kw = dict(n_steps=40, blk=blk, chain_base=np.array([3, 1, 0, 2]) * blk,
              live=torch.tensor([1, 1, 0, 1], device=card))
    pk, fk = tqs.qap_sweep_kernel(p, *args, **kw)
    pp, fp = tqs.qap_sweep_plain(p, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(fk, fp)
    assert torch.equal(pk[2 * blk:3 * blk], p[2 * blk:3 * blk])


@pytest.mark.parametrize("packed", ["F", "D"])
def test_cuda_qap_kernel_mixed_operands(card, packed):
    """One matrix packed per block and the other (n, n): the kernel offsets
    each by itself, as the plain version does."""
    rs = np.random.default_rng(2)
    n, blk, nb = 10, 64, 4
    F, D = _operands(*_instances(rs, n, nb), packed)
    p = torch.from_numpy(_perms(rs, nb * blk, n)).to(card)
    args = (torch.from_numpy(F).to(card), torch.from_numpy(D).to(card),
            torch.tensor([1.0, 5.0, 20.0, 0.3], device=card), 3, 7)
    kw = dict(n_steps=30, blk=blk)
    pk, fk = tqs.qap_sweep_kernel(p, *args, **kw)
    pp, fp = tqs.qap_sweep_plain(p, *args, **kw)
    assert torch.equal(pk, pp) and torch.equal(fk, fp)
