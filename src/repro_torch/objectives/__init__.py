"""Benchmark objective suite (paper Table 8: 41 problems, 19 families),
the counterpart of ``repro.objectives``."""
from __future__ import annotations

from .base import DecomposableSpec, Objective
from . import functions as F

__all__ = ["Objective", "DecomposableSpec", "get", "SUITE", "suite_objectives"]

# Paper Table 8 — reference id -> factory call.
SUITE = {
    "F0_a": lambda: F.schwefel(8),
    "F0_b": lambda: F.schwefel(16),
    "F0_c": lambda: F.schwefel(32),
    "F0_d": lambda: F.schwefel(64),
    "F0_e": lambda: F.schwefel(128),
    "F0_f": lambda: F.schwefel(256),
    "F0_g": lambda: F.schwefel(512),
    "F1_a": lambda: F.ackley(30),
    "F1_b": lambda: F.ackley(100),
    "F1_c": lambda: F.ackley(200),
    "F1_d": lambda: F.ackley(400),
    "F2": lambda: F.branin(),
    "F3_a": lambda: F.cosine_mixture(2),
    "F3_b": lambda: F.cosine_mixture(4),
    "F4": lambda: F.dekkers_aarts(),
    "F5": lambda: F.easom(),
    "F6": lambda: F.exponential(4),
    "F7": lambda: F.goldstein_price(),
    "F8_a": lambda: F.griewank(100),
    "F8_b": lambda: F.griewank(200),
    "F8_c": lambda: F.griewank(400),
    "F9": lambda: F.himmelblau(),
    "F10_a": lambda: F.levy_montalvo(2),
    "F10_b": lambda: F.levy_montalvo(5),
    "F10_c": lambda: F.levy_montalvo(10),
    "F11_a": lambda: F.langerman(2),
    "F11_b": lambda: F.langerman(5),
    "F12_a": lambda: F.michalewicz(2),
    "F12_b": lambda: F.michalewicz(5),
    "F12_c": lambda: F.michalewicz(10),
    "F13_a": lambda: F.rastrigin(100),
    "F13_b": lambda: F.rastrigin(400),
    "F14": lambda: F.rosenbrock(4),
    "F15": lambda: F.salomon(10),
    "F16": lambda: F.six_hump_camel(),
    "F17": lambda: F.shubert(2),
    "F18_a": lambda: F.shekel(5),
    "F18_b": lambda: F.shekel(7),
    "F18_c": lambda: F.shekel(10),
    "F19_a": lambda: F.shekel_foxholes(2),
    "F19_b": lambda: F.shekel_foxholes(5),
}


def get(ref: str) -> Objective:
    """Instantiate a suite problem by its paper reference (e.g. ``"F0_b"``)."""
    return SUITE[ref]()


def suite_objectives():
    for ref, factory in SUITE.items():
        yield ref, factory()
