"""Assigned architecture config: stablelm-1.6b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("stablelm-1.6b")
MODEL = ARCH.model
