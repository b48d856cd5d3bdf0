"""Architecture + shape registry (assignment pool)."""
from repro_torch.configs.archs import ARCHS, ARCH_IDS, get_arch
from repro_torch.configs.common import SHAPES, ArchSpec, shrink

__all__ = ["ARCHS", "ARCH_IDS", "get_arch", "SHAPES", "ArchSpec", "shrink"]
