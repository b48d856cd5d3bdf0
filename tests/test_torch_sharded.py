"""The sharded SA ladder of the port (``sa_minimize(mesh=...)``,
``build_sharded_ladder``, ``hybrid_minimize(mesh=...)``) on the CPU over
gloo, against the port's own unsharded run and the reference's sharded
ladder.

Every chain keeps its global index in every draw, so a sharded run must
give the unsharded ``f_best`` bit for bit at any world size, and the
history the reference defines for it: the first shard's local
best-so-far.  World size 1 runs in this process; world sizes 2 and 4 run
as gloo process groups of subprocesses (``torch_sharded_worker.py``).
Every rendezvous goes through a file under ``tmp_path``; every group and
subprocess has a timeout.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import SAConfig, hybrid_minimize, sa_minimize
from repro_torch.launch import mesh as tmesh
from repro_torch.objectives import functions as TF
from repro_torch.objectives import get

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
WORKER = str(Path(__file__).resolve().parent / "torch_sharded_worker.py")
TIMEOUT_S = 240
CONTRACT = dict(T0=50.0, T_min=0.5, rho=0.8, N=10, n_chains=256)


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.local_test_mesh(device="cpu")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-size-1 gloo group in this process, torn down after the
    module."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _same(a, b):
    return (a.f_best == b.f_best and np.array_equal(a.x_best, b.x_best)
            and a.x_best.dtype == b.x_best.dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("exchange", ["sync", "sos", "async"])
@pytest.mark.parametrize("name", ["schwefel8", "F11_b"])
def test_world1_mesh_equals_unsharded(group, name, exchange, dtype):
    """Schwefel-8 goes through B1's and B2's plain versions in float32;
    F11_b (no kernel_id) and every float64 run through the plain sweep."""
    obj = TF.schwefel(8) if name == "schwefel8" else get(name)
    cfg = SAConfig(**{**CONTRACT, "n_chains": 64}, exchange=exchange,
                   dtype=dtype, seed=2)
    ref = sa_minimize(obj, cfg, device="cpu")
    for m, axes in ((tmesh.make_mesh((1,), ("data",), device="cpu"), None),
                    (tmesh.make_mesh((1, 1), ("data", "model"), device="cpu"),
                     ("data",))):
        got = sa_minimize(obj, cfg, mesh=m, mesh_axes=axes)
        assert _same(got, ref)
        if exchange == "async":   # V1 stays free of communication
            assert got.history_f is None
        else:
            np.testing.assert_array_equal(got.history_f, ref.history_f)


def test_mesh_helpers_and_errors(group):
    m = tmesh.local_test_mesh(device="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    assert tmesh.dp_axes(m) == ("data",) and tmesh.mesh_size(m) == 1
    assert tmesh.slot_pool_mesh(3, "cpu") == [torch.device("cpu")] * 3
    cfg = SAConfig(**CONTRACT)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sa_minimize(TF.schwefel(8), cfg, device="cpu", mesh_axes=("data",))
    with pytest.raises(ValueError, match="distinct dims"):
        sa_minimize(TF.schwefel(8), cfg, mesh=m, mesh_axes=("pod",))
    with pytest.raises(ValueError, match="not the mesh's"):
        sa_minimize(TF.schwefel(8), cfg, mesh=m, device="meta")
    with pytest.raises(ValueError, match="holds 2 ranks"):
        tmesh.make_mesh((2,), ("data",), device="cpu")


def test_hybrid_minimize_over_a_mesh(group):
    obj = TF.schwefel(8)
    cfg = SAConfig(**{**CONTRACT, "T_min": 5.0})
    m = tmesh.make_mesh((1,), ("data",), device="cpu")
    ref = hybrid_minimize(obj, cfg, device="cpu")
    got = hybrid_minimize(obj, cfg, device="cpu", mesh=m)
    assert got.f_best == ref.f_best and np.array_equal(got.x_best, ref.x_best)
    assert got.f_best <= got.sa.f_best


def _launch(world: int, tmp: Path):
    """Start the ``world`` ranks of one gloo group; returns the processes."""
    tmp.mkdir()
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "init"), str(tmp)],
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _collect(procs, world: int, tmp: Path):
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """World sizes 2 and 4, run at once: {world: [rank results]}."""
    base = tmp_path_factory.mktemp("sharded")
    procs = {w: _launch(w, base / f"w{w}") for w in (2, 4)}
    return {w: _collect(procs[w], w, base / f"w{w}") for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_multi_rank_equals_unsharded(multi_rank, world):
    """f_best bit for bit; x_best too unless two distinct states tie in f
    (the test says which); the first shard's history as derived from the
    unsharded run; every rank the same; two calls the same."""
    ranks = multi_rank[world]
    ties = []
    for mi, m in enumerate(ranks[0]["meshes"]):
        for label, rec in m["runs"].items():
            u = rec["unsharded"]
            assert rec["f"] == u["f"], (m["shape"], m["axes"], label)
            if rec["x"] != u["x"]:
                assert u["f_x"] == pytest.approx(
                    np.frombuffer(bytes.fromhex(rec["f"]), np.float64)[0],
                    rel=1e-5), label
                ties.append(label)
            assert rec["hist"] == u["hist"], label
            assert rec["again"], label
            for other in ranks[1:]:
                o = other["meshes"][mi]["runs"][label]
                assert (o["f"], o["x"], o["hist"]) == (rec["f"], rec["x"], rec["hist"])
    # On these seeds no two distinct states tie: x_best is bit-equal too.
    assert ties == [], f"x_best differs by a tie in f: {ties}"


def test_replicas_agree_and_data_only_mesh(multi_rank):
    """World 4 on (2, 2) cut along "data" alone: ranks that differ only
    on "model" are replicas and return the same result (checked above for
    every rank); the chains are cut in two, and indivisible counts raise
    with the reference's message."""
    meshes = multi_rank[4][0]["meshes"]
    assert [m["axes"] for m in meshes] == [None, ["data"]]
    assert meshes[0]["indivisible"] == "n_chains=5 not divisible by mesh size 4"
    assert meshes[1]["indivisible"] == "n_chains=3 not divisible by mesh size 2"
    assert multi_rank[2][0]["meshes"][0]["indivisible"] == \
        "n_chains=3 not divisible by mesh size 2"


def _reference_8dev() -> dict:
    """The reference's sharded ladder on 8 fake devices, (4, 2) mesh, as
    its own test runs it, over the contract's four seeds."""
    code = """
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, jax
from repro.core import SAConfig, sa_minimize
from repro.objectives import functions as F
from repro.launch.mesh import make_mesh
mesh = make_mesh((4, 2), ("data", "model"))
obj = F.schwefel(8)
errs = []
for seed in range(4):
    cfg = SAConfig(T0=50.0, T_min=0.5, rho=0.8, N=10, n_chains=256,
                   exchange="sync", record_history=False, seed=seed)
    res = sa_minimize(obj, cfg, key=jax.random.PRNGKey(seed), mesh=mesh)
    errs.append(abs(float(res.f_best) - obj.f_opt))
try:
    sa_minimize(obj, SAConfig(n_chains=12), mesh=mesh)
    msg = None
except ValueError as e:
    msg = str(e)
print(json.dumps({"errs": errs, "indivisible": msg}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=TIMEOUT_S,
                         env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_against_reference_sharded_ladder(multi_rank):
    """The reference's contract (error < 30 on Schwefel-8) holds for both,
    and their champion quality agrees in distribution: over the four
    seeds the mean errors lie within 0.25 of each other (both are set by
    T_min = 0.5; each is near 0.03 at these seeds).  The draws differ
    (``jax.random`` against counter-based streams), so no bit agrees."""
    ref = _reference_8dev()
    assert ref["indivisible"] == "n_chains=12 not divisible by mesh size 8"
    port = multi_rank[4][0]["meshes"][0]["contract_err"]
    assert len(port) == len(ref["errs"]) == 4
    assert max(port) < 30.0 and max(ref["errs"]) < 30.0
    assert abs(np.mean(port) - np.mean(ref["errs"])) <= 0.25
    for w in (2, 4):
        for m in multi_rank[w][0]["meshes"]:
            assert max(m["contract_err"]) < 30.0


def test_sharded_ladder_slices_and_bases(group):
    """build_sharded_ladder takes the global chains and runs the rank's
    slice; at world size 1 that is all of them."""
    from repro_torch.core import annealing
    obj = TF.schwefel(8)
    cfg = SAConfig(**{**CONTRACT, "n_chains": 32})
    m = tmesh.make_mesh((1,), ("data",), device="cpu")
    gen = torch.Generator()
    gen.manual_seed(cfg.seed)
    x0c = obj.sample_uniform(gen, (cfg.n_chains,), torch.float32)
    bx, bf, hist = annealing.build_sharded_ladder(obj, cfg, m)(x0c)
    rx, rf, rhist = annealing.run_ladder(x0c, objective=obj, cfg=cfg)
    assert float(bf) == float(rf) and torch.equal(bx, rx)
    assert torch.equal(hist, rhist)
    run = annealing.build_sharded_ladder(obj, dataclasses.replace(cfg, exchange="async"), m)
    assert run(x0c)[2] is None


@pytest.mark.parametrize("variant", ["full", "delta"])
def test_sweep_rows_keep_their_global_chain_index(variant):
    """A shard's slice swept with ``chain_base`` equals the same rows of
    the whole batch's sweep, also when the slice fills no whole block
    (300 rows in blocks of 256: the padded path)."""
    from repro_torch.kernels import ops
    x = torch.from_numpy(np.random.default_rng(3).uniform(-500, 500, (600, 4))
                         .astype(np.float32))
    kw = dict(kid=0, n_steps=12, variant=variant, device="cpu")
    whole = ops.metropolis_sweep(x, 50.0, 7, 33, **kw)
    part = ops.metropolis_sweep(x[100:400], 50.0, 7, 33, chain_base=100, **kw)
    assert torch.equal(part[0], whole[0][100:400])
    assert torch.equal(part[1], whole[1][100:400])
