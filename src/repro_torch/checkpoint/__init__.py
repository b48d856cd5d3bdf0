"""Fault-tolerant checkpointing: async save, atomic publish, restore
onto any device."""
from repro_torch.checkpoint.manager import (CheckpointManager, all_steps, latest_step,
                                            restore_state, save_state)

__all__ = ["CheckpointManager", "save_state", "restore_state", "latest_step", "all_steps"]
