"""One level of the V2 ladder on ``chains`` chains, from the champion of
the level before: the B1 full sweep (``b1_full``, champion start) and one
B2 champion over the chains' values.  The program reduces a second time
for its best-so-far, but over the champion's value broadcast to every
chain, which the first reduction already gave; and the adoption, every
chain restarting from the champion, needs no bytes beyond the champion's
row that the sweep reads."""
from perfbench.costs import b1_full, b2
from perfbench.lib.peaks import add


def cost(chains: int, dim: int, N: int) -> dict:
    return add(b1_full.cost(chains, dim, N, "champion"), b2.cost(chains))
