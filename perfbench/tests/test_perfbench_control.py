"""The control: the reference in bfloat16 put in the program's place must
come out not correct through the cell's own check (``run.run_cell`` with
the control as the driver), here at a size a test run holds (on the card
it runs at the cell's own size: ``perfbench/control.py``)."""
from __future__ import annotations

import pytest

import _toy
from perfbench import control


@pytest.mark.parametrize("cell", [_toy.LADDER, _toy.RANKS])
def test_ladder_control_fails(cell):
    for seed in (1, 2, 2**31 + 3):
        res = _toy.run_toy(cell, seed=seed, driver=control)
        assert res["correct"] is False, res["check"]
        assert res["check"]["level_f_gap"]["value"] > 0


def test_control_solve_hands_the_check_what_the_program_does():
    cfg, tr = _toy.ladder_parts()
    s = control.control_solve(cfg, 64, 5, 3, "cpu")
    assert s["f"].shape == (3,) and s["x"].shape == (3, cfg["dim"])
    assert list(s["history"]) == sorted(s["history"], reverse=True)
    assert s["f_best"] == s["history"][-1]
