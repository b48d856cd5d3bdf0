"""Each fault a cell can have, planted under the timed path with the
harness's look for a card skipped, must turn ``correct`` false: a step
that returns its state unchanged, half of the chains left out (the
champion taken over the rest), an answer altered where it is produced,
a ladder cut short, and, over ranks, the exchange between them left
out."""
from __future__ import annotations

import os

import pytest

import _toy


def _unchanged(orig):
    def sweep(*a, **kw):
        return orig(*a, **{**kw, "n_steps": 0})
    return sweep


def _half(orig):
    def sweep(x, *a, **kw):
        xo, fo = orig(x, *a, **kw)
        h = x.shape[0] // 2
        xo, fo = xo.clone(), fo.clone()
        xo[h:] = x[h:]
        fo[h:] = float("inf")
        return xo, fo
    return sweep


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer", "short"])
def test_ladder_fault_is_caught(fault, monkeypatch):
    from repro_torch.core import annealing
    from repro_torch.kernels import ops
    if fault == "short":
        orig = annealing.SAConfig.ladder
        monkeypatch.setattr(annealing.SAConfig, "ladder",
                            lambda self: orig(self)[:-1])
    elif fault == "answer":
        orig = annealing.run_ladder

        def run_ladder(*a, **kw):
            x, f, h = orig(*a, **kw)
            return x, f * 1.01, h
        monkeypatch.setattr(annealing, "run_ladder", run_ladder)
    else:
        wrap = _unchanged if fault == "unchanged" else _half
        monkeypatch.setattr(ops, "metropolis_sweep", wrap(ops.metropolis_sweep))
    assert _toy.run_toy(_toy.LADDER)["correct"] is False


def test_ranks_without_the_exchange_are_caught(tmp_path, monkeypatch):
    (tmp_path / "sitecustomize.py").write_text(
        "from repro_torch.core import exchange\n"
        "exchange.gather_champion = lambda xb, fb, shard: (xb, fb)\n")
    path = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(_toy.ROOT / "src"), str(tmp_path)] + ([path] if path else [])))
    assert _toy.run_toy(_toy.RANKS)["correct"] is False
