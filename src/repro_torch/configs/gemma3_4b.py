"""Assigned architecture config: gemma3-4b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("gemma3-4b")
MODEL = ARCH.model
