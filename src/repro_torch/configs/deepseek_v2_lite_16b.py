"""Assigned architecture config: deepseek-v2-lite-16b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("deepseek-v2-lite-16b")
MODEL = ARCH.model
