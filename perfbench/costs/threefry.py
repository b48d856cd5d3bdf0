"""Integer operations of one threefry2x32 (20 rounds): 2 key adds, 20
rounds of an add, a rotate and an xor, and 5 key injections of 3 adds.
A Metropolis step draws two blocks, the second only for its accept
uniform (``b1_full`` counts what a step needs)."""
OPS = 2 + 20 * 3 + 5 * 3
