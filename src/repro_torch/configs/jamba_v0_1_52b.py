"""Assigned architecture config: jamba-v0.1-52b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("jamba-v0.1-52b")
MODEL = ARCH.model
