"""Core: the paper's contribution, parallel simulated annealing."""
from repro_torch.core.annealing import SAConfig, SAResult, sa_minimize
from repro_torch.core.hybrid import HybridResult, hybrid_minimize
from repro_torch.core.neldermead import NMResult, nelder_mead

__all__ = [
    "SAConfig", "SAResult", "sa_minimize",
    "HybridResult", "hybrid_minimize", "NMResult", "nelder_mead",
]
