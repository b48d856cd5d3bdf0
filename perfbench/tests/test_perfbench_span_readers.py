"""The reader of the program's spans (``sa.pack_ms_per_level``) on
hand-built stretches."""
from __future__ import annotations

import pytest

import _toy
from perfbench.lib.records import Records
from perfbench.lib.trace import Stretch

PACK = _toy.cells.load_module("metrics", "sa.pack_ms_per_level")

B1 = "sa::sweep_full_kernel<float>"
B2 = "void sa::argmin_kernel<float>"
COPY = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl"
        "<at::native::direct_copy_kernel_cuda>>")
# Named with "copy", so that only the NCCL test keeps it from the pack.
NCCL = "ncclDevKernel_AllGather_RING_LL_copy"
MS = 1_000_000
# 2^20 rows of 512 float32: a copy of them all takes 0.641 ms at least.
CONFIG = {"dim": 512, "dtype": "float32"}
CHAINS = 1 << 20


def _records(device=(), host=(), levels=None, config=CONFIG):
    counts = {"chains": CHAINS, **({"levels": levels} if levels else {})}
    return Records(cell=_toy.LADDER, config=config, traffic={},
                   stretch=Stretch(list(device), list(host), 0, 100 * MS, 0.1),
                   counts=counts)


def _ladder(levels, pack_ns, nccl=False):
    """Host and device events of ``levels`` V2 levels, 10 ms apart: level
    k > 0 packs (``pack_ns`` of device time) right before its B1; each
    level then reduces, copies the champion's value and the history
    entry, and, with ``nccl``, all-gathers on a stream of its own, its
    kernel landing between the pack and B1."""
    host, dev = [], []
    for k in range(levels):
        t = k * 10 * MS
        host.append(("sa.level", t, t + 9 * MS))
        if k:
            host.append(("sa.pack", t + 100, t + 200))
            dev.append((COPY, t + 300, t + 300 + pack_ns))
        if nccl and k:
            dev.append((NCCL, t + 300 + pack_ns, t + 400 + pack_ns))
        dev.append((B1, t + 1 * MS, t + 4 * MS))
        dev.append((B2, t + 4 * MS, t + 4 * MS + 10))
        dev.append((COPY, t + 5 * MS, t + 5 * MS + 7))
        dev.append((COPY, t + 6 * MS, t + 6 * MS + 9))
    dev.sort(key=lambda d: d[1])
    return dev, host


@pytest.mark.parametrize("nccl", [False, True])
def test_packs_matched_in_order(nccl):
    dev, host = _ladder(5, 1_250_000, nccl)
    # Four packs of 1.25 ms over five levels; the NCCL kernel between the
    # pack and B1 is not taken for the pack.
    assert PACK.read(_records(dev, host)) == pytest.approx(4 * 1.25 / 5)


def test_b1_count_unlike_the_level_count_gives_none():
    dev, host = _ladder(4, 1000)
    dev.remove(next(d for d in dev if d[0] == B1))
    assert PACK.read(_records(dev, host)) is None


def test_a_level_that_packed_without_a_copy_gives_none():
    dev, host = _ladder(3, 1000)
    first_pack = next(d for d in dev if d[0] == COPY and d[1] == 10 * MS + 300)
    dev.remove(first_pack)
    # The copies of level 0's champion update still lie in the interval,
    # so drop them too: nothing is left to take for the pack.
    dev = [d for d in dev if not (d[0] == COPY and 4 * MS < d[1] < 10 * MS)]
    assert PACK.read(_records(dev, host)) is None


def test_levels_without_packs_read_zero():
    dev, host = _ladder(4, 1000)
    host = [h for h in host if h[0] != "sa.pack"]
    assert PACK.read(_records(dev, host)) == 0.0


def test_no_program_span_gives_none():
    dev, host = _ladder(3, 1000)
    host = [h for h in host if h[0] not in ("sa.level", "sa.pack")]
    assert PACK.read(_records(dev, host)) is None
    assert PACK.read(Records(cell=_toy.LADDER, config={}, traffic={})) is None


def _unspanned(levels, pack_ns):
    """A ladder whose packs left their span: each copy still runs."""
    dev, host = _ladder(levels, pack_ns)
    return dev, [h for h in host if h[0] != "sa.pack"]


@pytest.mark.parametrize("solve_levels", [None, 4, 2])
def test_a_pack_sized_copy_outside_any_pack_span_gives_none(solve_levels):
    # With two levels a solve the copies of the second level of each of
    # the two solves are still seen.
    dev, host = _unspanned(4, 1_250_000)
    assert PACK.read(_records(dev, host, solve_levels)) is None


def test_a_pack_sized_copy_in_one_level_gives_none():
    dev, host = _ladder(4, 1_250_000)
    host.remove(next(h for h in host if h[0] == "sa.pack"))
    assert PACK.read(_records(dev, host)) is None


def test_a_solves_first_level_may_copy_its_starts():
    # Each solve's starts are made before its first B1; only a later
    # level's copy of the pack's size counts against the reading.
    dev, host = _unspanned(4, 1_250_000)
    dev = [d for d in dev if not (d[0] == COPY and d[1] % (10 * MS) == 300
                                  and d[1] // (10 * MS) % 2)]
    assert PACK.read(_records(dev, host, levels=2)) == 0.0
    assert PACK.read(_records(dev, host)) is None


def test_copies_shorter_than_half_the_rows_write_still_read_zero():
    # 0.3 ms: under half of the 0.641 ms least time of the rows' write.
    dev, host = _unspanned(4, 300_000)
    assert PACK.read(_records(dev, host)) == 0.0
    dev, host = _unspanned(4, 330_000)
    assert PACK.read(_records(dev, host)) is None


@pytest.mark.parametrize("config", [{}, {"dim": 512}, {"dim": 512, "dtype": "bfloat16"}])
def test_levels_without_packs_and_no_known_row_size_give_none(config):
    dev, host = _unspanned(3, 1000)
    assert PACK.read(_records(dev, host, config=config)) is None
    # Levels that pack need no row size.
    dev, host = _ladder(3, 1000)
    assert PACK.read(_records(dev, host, config=config)) == pytest.approx(
        2 * 1e-3 / 3)
