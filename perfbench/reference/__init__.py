"""The benchmark's plain reference: the annealing semantics written out in
plain PyTorch, apart from the program under test.

Nothing here imports the program (``repro_torch``), the JAX package
(``repro``) or ``jax``, and nothing takes a tensor the program made:
the check in ``ladder_check`` reads the program's outputs only to judge
them.  Every function takes a ``dtype``, float32
for the reference and bfloat16 for the control (``perfbench/control.py``).
"""
