"""The plain reference on its own: threefry's known answers, the
objectives against float64, and each sweep's invariants."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import objectives as ob  # noqa: E402
from perfbench.reference import ladder_check  # noqa: E402
from perfbench.reference import sweep  # noqa: E402
from perfbench.reference.threefry import threefry2x32  # noqa: E402


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    got = threefry2x32(torch.tensor(key[0]), torch.tensor(key[1]),
                       torch.tensor(ctr[0]), torch.tensor(ctr[1]))
    assert (int(got[0]), int(got[1])) == want


def _states(name, n, dim, seed=0):
    lo, hi = ob.BOX[name]
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.uniform(lo, hi, (n, dim)).astype(np.float32))


def test_full_value_against_float64():
    x = _states("schwefel", 8, 512)
    np.testing.assert_allclose(ob.full_value("schwefel", x).numpy(),
                               ob.value64("schwefel", x.numpy()), rtol=1e-5, atol=1e-4)


def test_full_level_carries_the_full_order_value():
    x = _states("schwefel", 64, 96, 3)
    cidx = torch.arange(64, dtype=torch.int64)
    xo, fo = sweep.full_level(x, 30.0, 12345, 66, 33, cidx)
    assert torch.equal(fo, ob.full_value("schwefel", xo))
    assert not torch.equal(xo, x)


def test_hot_walk_takes_every_proposal():
    x = _states("schwefel", 8, 4)
    cidx = torch.arange(8, dtype=torch.int64)
    xo, _ = sweep.full_level(x, 1e30, 1, 0, 1, cidx)
    bits, uval, _ = sweep.level_draws(1, 0, 1, cidx)
    d = (bits[:, 0] % 4)
    want = sweep.proposal(*ob.box32("schwefel"), uval[:, 0], torch.float32)
    assert torch.equal(xo[torch.arange(8), d], want)


def test_ladder_temperatures():
    cfg = {"T0": 1000.0, "T_min": 1.0, "rho": 0.99}
    T = ladder_check.temperatures(cfg, 688)
    assert T[0] == np.float32(1000.0) and ladder_check.n_levels(cfg) == 688
    assert T[-1] == pytest.approx(1000 * 0.99 ** 687, rel=1e-6)


def test_ladder_inputs_are_deterministic_per_seed():
    # A run's solves and starts come from --seed alone: the same seed
    # gives the same inputs, another seed others, large seeds included.
    from perfbench.lib import ladder
    big = 2**31 + 12345
    assert [ladder.solve_seed(big, i) for i in range(3)] == \
        [ladder.solve_seed(big, i) for i in range(3)]
    assert len({ladder.solve_seed(big, i) for i in range(50)}) == 50
    assert ladder.solve_seed(big, 0) != ladder.solve_seed(big + 1, 0)
    cfg = {"dim": 8, "box": [-512.0, 512.0]}
    a = ladder_check.start_states(cfg, 16, ladder.solve_seed(big, 0), "cpu")
    b = ladder_check.start_states(cfg, 16, ladder.solve_seed(big, 0), "cpu")
    c = ladder_check.start_states(cfg, 16, ladder.solve_seed(big, 1), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= -512.0 and float(a.max()) <= 512.0
