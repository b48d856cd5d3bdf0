"""Kernel B1, full variant: one temperature level of ``chains`` chains of
Schwefel in ``dim`` coordinates, ``N`` steps each, counted from what the
algorithm needs and not from any kernel that implements it.

Bytes.  ``start="champion"``, every level of a V2 solve but its first:
every chain starts from the same champion, so the champion's state is
read once (``dim`` floats) and its value is known.  ``start="apart"``,
a solve's first level: each chain's own state is read.  Either way each
chain's final value is written; the next level needs no other chain's
state, only the champion's, whose row is written once.

Float32 operations, from the formula: a Schwefel term ``x sin(sqrt|x|)``
is four operations (absolute value, square root, sine, product),
whatever instructions a kernel spends on its elementary functions.  A
chain that starts apart first sums its ``dim`` terms (``dim - 1`` adds
and a divide).  A step is the proposal (a fused multiply-add, two), the
new term (four), the value again with only the changed lane of 32
refolded (``ceil(dim / 32)`` adds) and the five tree adds above it, the
divide, and the accept test's subtract and compare (two): the
exponential and the rest of the test are needed only when the proposal
goes uphill.

Integer operations: one threefry2x32 block and the coordinate's modulo
per step.  The second block gives only the accept uniform, which a
downhill proposal does not need."""
from perfbench.costs import threefry

TERM_OPS = 4
STARTS = ("champion", "apart")


def cost(chains: int, dim: int, N: int, start: str = "champion") -> dict:
    if start not in STARTS:
        raise ValueError(f"start is one of {STARTS}, not {start!r}")
    apart = start == "apart"
    read = chains * dim * 4 if apart else dim * 4
    init = dim * TERM_OPS + (dim - 1) + 1 if apart else 0
    step = 2 + TERM_OPS + (-(-dim // 32)) + 5 + 1 + 2
    return {"bytes": read + chains * 4 + dim * 4,
            "flops": chains * (init + N * step),
            "int_ops": chains * N * (threefry.OPS + 1)}
