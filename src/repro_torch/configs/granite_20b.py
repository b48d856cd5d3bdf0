"""Assigned architecture config: granite-20b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("granite-20b")
MODEL = ARCH.model
