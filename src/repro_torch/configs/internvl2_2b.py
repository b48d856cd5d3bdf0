"""Assigned architecture config: internvl2-2b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("internvl2-2b")
MODEL = ARCH.model
