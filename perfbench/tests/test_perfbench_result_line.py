"""The result line's schema from each driver at toy sizes on the CPU,
through the test-only entry; and run.py refusing to run without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

import _toy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _schema(res, trace, cell):
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    names = {m["name"]: m for m in (_toy.BENCH["per_layer"] if trace
                                    else _toy.BENCH["end_to_end"])}
    for k, v in res["metrics"].items():
        assert k in names and v["unit"] == names[k]["unit"]
        assert isinstance(v["value"], float)
    if not trace:
        want = {m["name"] for m in _toy.cells.end_to_end_of(_toy.BENCH, cell)}
        assert set(res["metrics"]) == want
    for c in res["check"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


@pytest.mark.parametrize("trace", [False, True])
def test_ladder_line(trace):
    _schema(_toy.run_toy(_toy.LADDER, trace=trace), trace, _toy.LADDER)


def test_ranks_line():
    res = _toy.run_toy(_toy.RANKS, trace=True)
    _schema(res, True, _toy.RANKS)
    assert "sa.host_ms_per_level" in res["metrics"]


def test_run_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(_toy.ROOT / "perfbench" / "run.py"), "--workload",
         _toy.LADDER, "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _ranks_alive(tmp):
    """Rank processes whose spec lies under ``tmp`` (their ``TMPDIR``)."""
    from pathlib import Path
    alive = []
    for d in Path("/proc").iterdir():
        try:
            cmd = (d / "cmdline").read_bytes()
        except OSError:
            continue
        if b"perfbench.drivers.ladder_ranks" in cmd and str(tmp).encode() in cmd:
            alive.append(d.name)
    return alive


def test_ranks_run_refuses_without_cards_and_stops_its_ranks(tmp_path):
    # The four-card cell starts its ranks before it looks for the cards;
    # without them it prints nothing and leaves no rank running.
    proc = subprocess.run(
        [sys.executable, str(_toy.ROOT / "perfbench" / "run.py"), "--workload",
         _toy.RANKS, "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=240,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "TMPDIR": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stdout
    assert "needs 4 CUDA card(s)" in proc.stderr, proc.stderr
    assert _ranks_alive(tmp_path) == []
