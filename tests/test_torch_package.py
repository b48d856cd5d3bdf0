"""The port as a package: no JAX, the card by default, state carried
across, and the CUDA paths (collected here, run where there is a card)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import SAConfig as JConfig
from repro.objectives import functions as JF
from repro_torch import interop
from repro_torch.core import nelder_mead, sa_minimize, SAConfig, hybrid_minimize
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import metropolis_sweep as tms
from repro_torch.kernels import reduce_min as trm
from repro_torch.objectives import functions as TF
from repro_torch.service import EngineConfig, SARequest, SAServeEngine, run_standalone
from repro_torch.service import serve_sa
from repro_torch.configs import get_arch
from repro_torch.distributed import autotune as TA
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as llm_serve
from repro_torch.launch import steps as llm_steps
from repro_torch.launch.train import preset_config
from repro_torch.models import model as tmodel

SMOKE = preset_config("smoke")[0]

SRC = Path(__file__).resolve().parents[1] / "src"


def test_package_imports_no_jax_and_no_reference():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(SRC / "repro_torch").with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            f"for m in {mods!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.kernels.ops" in mods and "repro_torch.interop" in mods


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: sa_minimize(TF.schwefel(2), SAConfig(n_chains=4)),
    lambda: hybrid_minimize(TF.schwefel(2), SAConfig(n_chains=4)),
    lambda: nelder_mead(TF.schwefel(2), np.zeros(2, np.float32)),
    lambda: ops.metropolis_sweep(np.zeros((4, 2), np.float32), 1.0, 0, 0, kid=0, n_steps=1),
    lambda: ops.metropolis_sweep_slots(np.zeros((4, 2), np.float32), 0, 1.0, 0, 0, 0, n_steps=1, blk=4),
    lambda: interop.chains_from_numpy(np.zeros((2, 2)), np.zeros(2)),
    lambda: ops.qap_sweep_slots(np.tile(np.arange(3, dtype=np.int32), (4, 1)),
                                np.ones((3, 3), np.float32), np.ones((3, 3), np.float32),
                                1.0, 0, 0, 0, n_steps=1, blk=4),
    lambda: SAServeEngine(EngineConfig(n_slots=2, chains_per_slot=4)).run(),
    lambda: run_standalone(SARequest(req_id=0, objective="syn10", dim=10, n_chains=4,
                                     family="permutation"),
                           EngineConfig(n_slots=2, chains_per_slot=4)),
    lambda: serve_sa.main(["--family", "qap", "--requests", "2", "--slots", "2",
                           "--chains-per-slot", "4"]),
    lambda: tmesh.make_mesh((1,), ("data",)),
    lambda: TA.exhaustive_best(TA.TuneProblem(get_arch("whisper-base").model, 16, 4, 4)),
    lambda: TA.autotune(TA.TuneProblem(get_arch("whisper-base").model, 16, 4, 4), 4),
    lambda: llm_serve.main(["--requests", "1", "--max-new", "2"]),
    lambda: tmodel.Model(SMOKE),
    lambda: tmodel.init_cache(SMOKE, 1, 8),
    lambda: llm_steps.make_serve_step(SMOKE)(
        {}, tmodel.init_cache(SMOKE, 1, 8), torch.zeros(1, 1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32)),
    lambda: interop.model_params_from_jax({}, SMOKE),
])
def test_entry_points_need_the_card_by_default(no_card, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_interop_round_trips():
    ref_cfg = JConfig(T0=3.0, T_min=0.1, N=7, n_chains=12, exchange="async", seed=9)
    cfg = interop.sa_config_from_dict(dataclasses.asdict(ref_cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    with pytest.raises(ValueError, match="unknown SAConfig fields"):
        interop.sa_config_from_dict({"mesh": 1})
    for name in ("schwefel", "rastrigin", "ackley", "griewank", "exponential", "salomon"):
        jo, to = getattr(JF, name)(6), interop.objective_from_ref(name, 6)
        assert (to.kernel_id, to.f_opt, to.name) == (jo.kernel_id, jo.f_opt, jo.name)
        np.testing.assert_array_equal(to.lower, jo.lower)
        np.testing.assert_array_equal(to.x_opt, jo.x_opt)
    with pytest.raises(ValueError, match="not a registry objective"):
        interop.objective_from_ref("branin", 2)
    rs = np.random.default_rng(0)
    x, fx = rs.random((5, 3)).astype(np.float32), rs.random(5).astype(np.float32)
    xt, ft = interop.chains_from_numpy(x, fx, device="cpu")
    assert xt.dtype == torch.float32 and xt.device.type == "cpu"
    x2, f2 = interop.chains_to_numpy(xt, ft)
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(f2, fx)


@pytest.fixture
def card():
    """Decided here, not at import: the CUDA paths run only where there is
    a card (chip_smoke.py drives them at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cuda_sweep_kernel_matches_plain(card):
    x = (torch.rand(512, 16, device=card) - 0.5) * 1000
    launches = tms.counter.launches
    xk, fk = tms.metropolis_sweep_kernel(x, 5.0, 1, 2**31, kid=0, n_steps=12, blk=64)
    torch.cuda.synchronize()
    assert tms.counter.launches == launches + 1
    xp, fp = tref.metropolis_sweep_ref(x, 5.0, 1, 2**31, kid=0, n_steps=12)
    assert (xk == xp).all(1).float().mean() >= 0.95


@pytest.mark.parametrize("variant", ["delta", "full"])
def test_cuda_sweep_dim3_long_sweep_matches_plain(card, variant):
    """Rows that are not 16-byte aligned and steps that keep revisiting a
    coordinate, over 100 steps with step0 wrapping past 2^32."""
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    x = ((torch.rand(512, 3, device=card, generator=gen) - 0.5) * 1000).contiguous()
    kw = dict(kid=0, n_steps=100, blk=64, variant=variant)
    xk, fk = tms.metropolis_sweep_kernel(x, 50.0, 9, 2**32 - 40, **kw)
    xp, fp = tms.metropolis_sweep_plain(x, 50.0, 9, 2**32 - 40, **kw)
    torch.cuda.synchronize()
    same = (xk == xp).all(1)
    assert same.float().mean() >= 0.95
    assert torch.allclose(fk[same], fp[same], rtol=2e-3, atol=2e-3)
    assert not torch.equal(xk, x)


def test_cuda_full_sweep_wide_rows_match_plain(card):
    """Rows whose full-variant term caches do not fit in shared memory
    (Griewank's two caches at dim 30000) take the kernel that re-evaluates
    every term; it is held to the plain version all the same."""
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    x = ((torch.rand(64, 30000, device=card, generator=gen) - 0.5) * 1000).contiguous()
    kw = dict(kid=torch.tensor([0, 3], dtype=torch.int32, device=card), n_steps=8,
              blk=32, variant="full")
    xk, fk = tms.metropolis_sweep_kernel(x, 50.0, 9, 11, **kw)
    xp, fp = tms.metropolis_sweep_plain(x, 50.0, 9, 11, **kw)
    torch.cuda.synchronize()
    same = (xk == xp).all(1)
    assert same.float().mean() >= 0.95
    assert torch.allclose(fk[same], fp[same], rtol=2e-3, atol=2e-3)
    assert not torch.equal(xk, x)


@pytest.mark.parametrize("variant", ["delta", "full"])
@pytest.mark.parametrize("dim", [3, 512])
def test_cuda_sweep_placement_invariant(card, dim, variant):
    """One block's chains swept alone and packed among others at blk 64
    and 256 give the same rows and f, bit for bit."""
    gen = torch.Generator(device=card)
    gen.manual_seed(dim)
    x = ((torch.rand(1024, dim, device=card, generator=gen) - 0.5) * 1000).contiguous()
    T = torch.tensor([1.0, 5.0, 20.0, 80.0], device=card)
    seeds, step0s = [11, 12, 13, 14], [2**32 - 5, 0, 7, 2**31]
    base = np.array([768, 0, 256, 512], np.int64)
    rows = slice(256, 512)                     # block 1 of 256
    alone = tms.metropolis_sweep_kernel(x[rows].clone(), 5.0, 12, 0, kid=0, n_steps=33,
                                        blk=256, chain_base=[0], variant=variant)
    packed256 = tms.metropolis_sweep_kernel(x, T, seeds, step0s, kid=0, n_steps=33,
                                            blk=256, chain_base=base, variant=variant)
    packed64 = tms.metropolis_sweep_kernel(
        x, T.repeat_interleave(4), np.repeat(seeds, 4), np.repeat(step0s, 4), kid=0,
        n_steps=33, blk=64, chain_base=np.repeat(base, 4) + np.tile(np.arange(4) * 64, 4),
        variant=variant)
    torch.cuda.synchronize()
    for xo, fo in (packed256, packed64):
        assert torch.equal(xo[rows], alone[0]) and torch.equal(fo[rows], alone[1])


def test_cuda_kid_out_of_range_raises_eagerly(card):
    x = torch.zeros(32, 4, device=card)
    kids = torch.tensor([0, 6], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="outside the kernel registry"):
        tms.metropolis_sweep_kernel(x, 1.0, 0, 0, kid=kids, n_steps=2, blk=16)
    with pytest.raises(ValueError, match="outside the kernel registry"):
        ops.metropolis_sweep_slots(x, kids, 1.0, 0, 0, 0, n_steps=2, blk=16,
                                   device=card)


def test_cuda_argmin_kernel_matches_plain(card):
    f = torch.randn(16385, device=card)
    f[[77, 16384]] = f.min() - 1
    m, i = trm.argmin_reduce(f)
    mp, ip = trm.argmin_reduce_plain(f)
    assert int(i) == int(ip) == 77 and float(m) == float(mp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_argmin_edge_cases_match_plain(card, dtype):
    """n = 1, an all-equal vector (index 0), NaNs (the first wins) and a
    slice that starts off 16-byte alignment, exact against plain."""
    big = torch.randn(16393, device=card).to(dtype)
    nan = torch.randn(16385, device=card).to(dtype)
    nan[[3, 900, 12000]] = torch.tensor([-float("inf"), float("nan"), float("nan")],
                                        device=card, dtype=dtype)
    for f, want in ((torch.randn(1, device=card).to(dtype), 0),
                    (torch.full((16385,), 0.25, device=card, dtype=dtype), 0),
                    (nan, 900), (big[3:3 + 16385], None)):
        m, i = trm.argmin_reduce(f)
        mp, ip = trm.argmin_reduce_plain(f)
        assert int(i) == int(ip) and (want is None or int(i) == want)
        assert float(m) == float(mp) or (np.isnan(float(m)) and np.isnan(float(mp)))


def test_cuda_sa_minimize_runs(card):
    r = sa_minimize(TF.schwefel(8), SAConfig(T0=50.0, T_min=1.0, rho=0.8, N=10,
                                             n_chains=256))
    assert np.isfinite(r.f_best) and r.x_best.shape == (8,)
