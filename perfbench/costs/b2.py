"""Kernel B2, the (min, first argmin) of ``n`` float32 values, as
``kernels/bounds.py`` counted it (frozen here): the values read once."""


def cost(n: int) -> dict:
    return {"bytes": 4 * n}
