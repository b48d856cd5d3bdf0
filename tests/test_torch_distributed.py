"""The port's distributed training pieces (``repro_torch.distributed``:
compression, monitor, pipeline; the expert-parallel MoE of
``models.layers``/``models.model``; ``make_train_step`` and
``launch.train`` over a mesh) on the CPU: over gloo process groups of
subprocesses at world sizes 2 and 4 (``torch_train_worker.py``), and
against the reference's quantizer and monitor in this process.

Tolerances are the reference's own (``tests/test_distributed.py``,
``tests/test_moe_ep.py:62-63``): compressed sums within 5% of the dense
sum, the pipeline within 1e-5 of the layers applied in order, the
expert-parallel MoE's loss and gradients within 1e-5 (relative) of the
local form's.  Train steps over a mesh hold the unsharded steps' losses
at rtol = atol = 2e-4, as ``tests/test_torch_train.py`` holds the port
against the reference.  Every rendezvous goes through a file under
``tmp_path``; every subprocess has a timeout.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import quantize_int8 as ref_quantize
from repro.distributed.monitor import StragglerMonitor as RefMonitor
from repro_torch.distributed import Heartbeat, StepTimer, StragglerMonitor
from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.launch import train as TT

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
WORKER = Path(__file__).resolve().parent / "torch_train_worker.py"
TIMEOUT_S = 240
EP_REL = 1e-5
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)


def _launch(world: int, tmp: Path):
    tmp.mkdir(parents=True)
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(tmp / "init"), str(tmp)],
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """World sizes 2 and 4, run at once: {world: [rank results]}."""
    base = tmp_path_factory.mktemp("train_ranks")
    procs = {w: _launch(w, base / f"w{w}") for w in (2, 4)}
    out = {}
    try:
        for w, ps in procs.items():
            for p in ps:
                _, err = p.communicate(timeout=TIMEOUT_S)
                assert p.returncode == 0, err[-4000:]
            out[w] = [json.loads((base / f"w{w}" / f"rank{r}.json").read_text())
                      for r in range(w)]
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    return out


def test_worker_imports_no_jax():
    src = WORKER.read_text()
    assert "import jax" not in src and "from repro." not in src and "ml_dtypes" not in src


# ------------------------------------------------------------- compression
def test_quantize_matches_reference_and_rounds_half_to_even():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(64,)).astype(np.float32) * 3,
              np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32),
              np.zeros(5, np.float32)):
        q, s = quantize_int8(torch.as_tensor(x))
        rq, rs = ref_quantize(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
    q, _ = quantize_int8(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_quantize_roundtrip_error_bounded():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(64,)) * 3, dtype=torch.float32)
    q, s = quantize_int8(x)
    assert float((dequantize_int8(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-6


def sum_peers(shape, axes, world):
    """Every rank's group of a sum over the mesh dims ``axes``: the ranks
    that share its coordinates on every other dim."""
    coords = [np.unravel_index(r, shape) for r in range(world)]
    off = [d for d, a in enumerate(("data", "model")[:len(shape)]) if a in axes]
    return [[p for p in range(world)
             if all(coords[p][d] == coords[r][d] for d in range(len(shape)) if d not in off)]
            for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_dense_sum(ranks, world):
    """Each rank's sum over the dims asked for: the sum of its group's
    dequantized shards, within 5% of the dense sum, and its residual is
    its own quantization error."""
    res = ranks[world]
    for m, (shape, _, axes) in enumerate(MESHES[world]):
        groups = sum_peers(shape, axes, world)
        for r in range(world):
            rec = res[r]["compression"][m]
            peers = groups[r]
            x = np.array([res[p]["compression"][m]["x"] for p in peers])
            deq = sum(np.float64(res[p]["compression"][m]["scale"])
                      * np.array(res[p]["compression"][m]["q"], np.float64) for p in peers)
            approx = np.array(rec["approx"])
            np.testing.assert_allclose(approx, deq, rtol=1e-6, atol=1e-6)
            exact = x.sum(0)
            assert np.abs(approx - exact).max() / np.abs(exact).max() < 0.05
            np.testing.assert_allclose(
                np.array(rec["resid"]),
                np.array(rec["x"]) - rec["scale"] * np.array(rec["q"], np.float32), atol=1e-6)
            assert np.any(np.array(rec["resid"]) != 0)


@pytest.mark.parametrize("world", [2, 4])
def test_compress_grads_tree_carries_residuals(ranks, world):
    """compress_grads_tree over a float32 and a bfloat16 leaf, two calls:
    each leaf's input is its gradient in float32 plus the residual the
    call before left (zero at first); its sum is the group's sum of the
    reference's dequantized shards of those inputs, and its new residual
    the rank's own quantization error, carried here from call to call."""
    res = ranks[world]
    for m, (shape, _, axes) in enumerate(MESHES[world]):
        groups = sum_peers(shape, axes, world)
        recs = [res[r]["compression"][m]["tree"] for r in range(world)]
        for leaf, dtype in (("a", "torch.float32"), ("b/c", "torch.bfloat16")):
            resid = [np.float32(0.0)] * world
            for k in range(2):
                x = [np.array(recs[r][k]["g"][leaf][0], np.float32) + resid[r]
                     for r in range(world)]
                qs = [tuple(map(np.asarray, ref_quantize(jnp.asarray(xi)))) for xi in x]
                for r in range(world):
                    rec = recs[r][k]
                    assert rec["g"][leaf][1] == dtype
                    assert rec["sum"][leaf][1] == rec["resid"][leaf][1] == "torch.float32"
                    want = sum(np.float64(qs[p][1]) * qs[p][0].astype(np.float64)
                               for p in groups[r])
                    np.testing.assert_allclose(rec["sum"][leaf][0], want, rtol=1e-6, atol=1e-6)
                resid = [x[r] - qs[r][1] * qs[r][0].astype(np.float32) for r in range(world)]
                for r in range(world):
                    np.testing.assert_allclose(recs[r][k]["resid"][leaf][0], resid[r], atol=1e-6)


MESHES = {2: (((2,), ("data",), ("data",)),),
          4: (((2, 2), ("data", "model"), ("data",)),
              ((2, 2), ("data", "model"), ("data", "model")))}


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_2stage_matches_sequential(ranks, world):
    for rec in ranks[world]:
        assert rec["pipeline"]["err"] < 1e-5, rec["pipeline"]
        assert abs(rec["pipeline"]["bubble"] - (2 - 1) / (4 + 2 - 1)) < 1e-9


# -------------------------------------------------------- expert parallel
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["ep_moe_apply", "ep_mesh_moe", "deepseek"])
def test_expert_parallel_matches_local_values_and_gradients(ranks, world, case):
    """moe_apply's EP form with distinct tokens per rank, _moe under a
    model mesh with the same tokens on every rank (the reference's
    shard_map, tests/test_moe_ep.py), and lm_loss of shrink(deepseek)
    with moe_ep: output or loss and every gradient within 1e-5 of the
    local form's."""
    for rec in ranks[world]:
        errs = rec[case]
        assert max(errs.values()) < EP_REL, errs


# ------------------------------------------------------------------ train
@pytest.mark.parametrize("world", [2, 4])
def test_train_steps_over_a_mesh_match_unsharded(ranks, world):
    """World 2: the smoke preset over a (2, 1) mesh, each rank half the
    batch; world 4: shrink(deepseek) with moe_ep over (2, 2), data and
    experts both split.  Three steps' losses against the unsharded
    steps', the same on every rank."""
    for rec in ranks[world]:
        np.testing.assert_allclose(rec["train"]["mesh"], rec["train"]["unsharded"], **LOSS_TOL)
        assert rec["train"]["mesh"] == ranks[world][0]["train"]["mesh"]


def test_train_main_under_a_group_matches_one_process(ranks):
    """launch.train.main under a world-2 gloo group: a (2, 1) mesh, each
    rank reading its host's half of every batch, the loss averaged."""
    want = TT.main(["--device", "cpu", "--preset", "smoke", "--steps", "3", "--log-every", "100"])
    for rec in ranks[2]:
        np.testing.assert_allclose(rec["main"], want, **LOSS_TOL)


def test_model_parallel_needs_a_group():
    with pytest.raises(ValueError, match="process group"):
        TT.main(["--device", "cpu", "--preset", "smoke", "--steps", "1", "--model-parallel", "2"])


# ----------------------------------------------------------------- monitor
@pytest.mark.parametrize("impl", [StragglerMonitor, RefMonitor])
def test_straggler_monitor_detects_outlier(impl):
    mon = impl(zscore=2.0)
    for h in range(8):
        for _ in range(16):
            mon.record(h, 0.1 if h != 5 else 0.5, now=1000.0)
    assert mon.stragglers() == [5]
    assert mon.dead(now=2000.0) == list(range(8))
    assert mon.dead(now=1001.0) == []


def test_heartbeats_and_step_timer(tmp_path):
    for h in range(4):
        hb = Heartbeat(tmp_path, h)
        for s in range(3):
            hb.beat(s, 0.1 if h != 2 else 0.9)
    mon = StragglerMonitor(zscore=1.5)
    mon.ingest(tmp_path)
    assert mon.stragglers() == [2] and mon.dead() == []
    timer = StepTimer(alpha=0.5, deadline_factor=2.0)
    assert not timer.exceeded_deadline(1e9)
    timer.start()
    dt = timer.stop()
    assert timer.mean == dt and timer.exceeded_deadline(3 * dt + 1e-3)


def test_expert_parallel_remat_is_bit_equal(ranks):
    """remat "full" and "dots" around regions that hold the EP all_to_all
    (shrink(deepseek), shrink(jamba)'s 8-layer period) over gloo at world
    size 2: the exchanges pair up again in the backward, and the loss and
    every gradient equal those without remat, bit for bit, on every rank."""
    for r in ranks[2]:
        assert r["remat_ep"] == {a: {"full": 0.0, "dots": 0.0}
                                 for a in ("deepseek-v2-lite-16b", "jamba-v0.1-52b")}
