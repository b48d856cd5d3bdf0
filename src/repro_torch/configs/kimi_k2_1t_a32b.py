"""Assigned architecture config: kimi-k2-1t-a32b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("kimi-k2-1t-a32b")
MODEL = ARCH.model
