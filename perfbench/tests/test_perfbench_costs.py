"""The roofline counts against hand counts at the cells' sizes."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.costs import b1_full, b2, sa_level, threefry  # noqa: E402
from perfbench.lib import peaks  # noqa: E402

# B1 full per chain at dim 512, N 33.  A step: 2 + 4 + 16 + 5 + 1 + 2 = 30
# operations and one threefry block plus the modulo, 78 integer ops.
# Apart: each chain's 512 x 4 bytes read and its start summed (512 terms
# of 4 operations, 511 adds, a divide: 2560).  Champion: its one row read.
# Both write each chain's value and the champion's row.
FULL = {
    (16384, "apart"): {"bytes": 33_622_016, "flops": 58_163_200,
                       "int_ops": 42_172_416},
    (16384, "champion"): {"bytes": 69_632, "flops": 16_220_160,
                          "int_ops": 42_172_416},
    (1 << 20, "apart"): {"bytes": 2_151_680_000, "flops": 3_722_444_800,
                         "int_ops": 2_699_034_624},
    (1 << 20, "champion"): {"bytes": 4_198_400, "flops": 1_038_090_240,
                            "int_ops": 2_699_034_624},
}


def test_threefry_count():
    assert threefry.OPS == 77


@pytest.mark.parametrize("chains,start", sorted(FULL))
def test_b1_full_hand_count(chains, start):
    assert b1_full.cost(chains, 512, 33, start) == FULL[chains, start]


def test_b1_full_counts_the_term_from_the_formula():
    # Four operations a Schwefel term: the count does not come from any
    # compiled code, so a faster kernel cannot read over its bound by it.
    assert b1_full.TERM_OPS == 4
    one = b1_full.cost(1, 512, 0, "apart")["flops"]
    assert one == 512 * 4 + 511 + 1
    assert b1_full.cost(1, 512, 0, "champion")["flops"] == 0
    with pytest.raises(ValueError):
        b1_full.cost(1, 512, 33, "adopted")


@pytest.mark.parametrize("chains", [16384, 1 << 20])
def test_level_and_b2_hand_count(chains):
    assert b2.cost(chains) == {"bytes": 4 * chains}
    lvl = sa_level.cost(chains, 512, 33)
    full = FULL[chains, "champion"]
    # One B2 pass and no adoption copy: the champion's row is all a V2
    # level reads of the states.
    assert lvl == {"bytes": full["bytes"] + 4 * chains,
                   "flops": full["flops"], "int_ops": full["int_ops"]}
    if chains == 1 << 20:
        assert lvl["bytes"] == 8_392_704


def test_least_time_at_one_card_of_the_ladder():
    t, kind = peaks.least_seconds(b1_full.cost(1 << 20, 512, 33, "apart"))
    assert kind == "bytes" and t == pytest.approx(2_151_680_000 / 3.35e12)
    t, kind = peaks.least_seconds(b1_full.cost(1 << 20, 512, 33, "champion"))
    assert kind == "int_ops" and t == pytest.approx(2_699_034_624 / 1.672704e13)
    t, kind = peaks.least_seconds(sa_level.cost(1 << 20, 512, 33))
    assert kind == "int_ops" and t == pytest.approx(2_699_034_624 / 1.672704e13)


def test_peaks_and_sums():
    assert peaks.INT32_OPS_PER_S == pytest.approx(1.672704e13)
    assert peaks.add({"bytes": 1}, {"flops": 2}, {"int_ops": 3, "bytes": 4}) == {
        "bytes": 5, "flops": 2, "int_ops": 3}
    t, kind = peaks.least_seconds({"flops": 67e12})
    assert kind == "flops" and t == pytest.approx(1.0)
