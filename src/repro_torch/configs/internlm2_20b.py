"""Assigned architecture config: internlm2-20b (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("internlm2-20b")
MODEL = ARCH.model
