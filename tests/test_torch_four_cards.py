"""A CPU rehearsal of the four-card record's multi-rank paths
(``chip_smoke.four_cards_paths_rank``): the same per-rank function that
``chip_smoke.four_cards`` runs under torchrun over NCCL on four cards, run
here over gloo at world size 4 at small sizes, and held by the same checks
(``chip_smoke.PATH_CHECKS``): the sharded SA ladder over (4,) and two
(2, 2) meshes bit for bit against the unsharded run, V1, SOS and the
hybrid; shrink(deepseek-v2-lite-16b) trained with ``moe_ep`` over (1, 4)
against one rank and against (1, 4) without it; shrink(stablelm) served
tensor-parallel over (1, 4) and (2, 2); its checkpoint saved over (2, 2)
and resumed over (1, 4) and, in this process without a group, on one
device; the four-stage GPipe pipeline and the compressed sums.

One launch of four subprocesses, rendezvous through a file under
``tmp_path``, with a timeout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

TIMEOUT_S = 240
WORLD = 4
SMALL = dict(
    sa=dict(dim=8, cfg=dict(cs.MAIN_CFG, n_chains=256, rho=0.9),
            delta_cfg=dict(cs.DELTA_CFG, n_chains=256, rho=0.9),
            meshes=cs.FOUR_CARDS_PATHS["sa"]["meshes"], wide=4, profile_levels=10, v1_dim=8,
            v1=dict(T0=100.0, T_min=1.0, rho=0.8, N=10, use_delta_eval=True, n_chains=256)),
    ep=dict(arch="deepseek-v2-lite-16b", shrink=True, layers=4, seq=32, batch=4, steps=4,
            timed_from=1),
    tp=dict(arch="stablelm-1.6b", shrink=True, meshes=((1, 4), (2, 2)), requests=2, prompt=12,
            max_new=6, s_max=32),
    ckpt=dict(arch="stablelm-1.6b", shrink=True, seq=32, batch=4, steps=6, save_at=3),
    pipe=cs.FOUR_CARDS_PATHS["pipe"],
    compress=cs.FOUR_CARDS_PATHS["compress"],
)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    """Every case's record from one gloo launch of four ranks, and the
    checkpoint's resume on one device without a group."""
    tmp = tmp_path_factory.mktemp("four_cards")
    out = tmp / "paths.json"
    init = f"file://{tmp / 'init'}"
    code = (f"import chip_smoke as cs; cs.four_cards_paths_rank({str(out)!r}, 'cpu', "
            f"{SMALL!r}, {init!r})")
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "src")]), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "WORLD_SIZE": str(WORLD)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    one = cs.four_cards_resume_one(SMALL["ckpt"], tmp / "ckpt", "cpu")
    return json.loads(out.read_text()), one


def test_rank_function_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from repro." not in src and "import repro." not in src


@pytest.mark.parametrize("case", list(cs.PATH_CHECKS))
def test_case_holds(record, case):
    rec, one = record
    assert len(rec[case]) == WORLD and [r["device"] for r in rec[case]] == ["cpu"] * WORLD
    if case == "ckpt":
        cs.check_paths_ckpt(rec[case], one)
    else:
        cs.PATH_CHECKS[case](rec[case])
