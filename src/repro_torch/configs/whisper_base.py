"""Assigned architecture config: whisper-base (defined in archs.py)."""
from repro_torch.configs.archs import get_arch

ARCH = get_arch("whisper-base")
MODEL = ARCH.model
