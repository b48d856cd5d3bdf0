"""PyTorch/CUDA port of the parallel simulated annealing package ``repro``.

The JAX/Pallas package ``repro`` stays the reference; this package runs the
same algorithms with PyTorch on an NVIDIA H100, with the reference's Pallas
kernels rewritten as hand-written CUDA C++ (``kernels/csrc``).  It imports
no JAX and nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without ``device="cpu"`` they raise.  On CPU tensors the
kernel wrappers run their plain PyTorch versions.
"""
from repro_torch.core import (HybridResult, NMResult, SAConfig, SAResult,
                              hybrid_minimize, nelder_mead, sa_minimize)

__all__ = [
    "SAConfig", "SAResult", "sa_minimize", "HybridResult",
    "hybrid_minimize", "NMResult", "nelder_mead",
]
