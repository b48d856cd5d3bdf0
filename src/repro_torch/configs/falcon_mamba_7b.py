"""Assigned architecture config: falcon-mamba-7b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("falcon-mamba-7b")
MODEL = ARCH.model
