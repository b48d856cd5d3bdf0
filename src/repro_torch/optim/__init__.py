"""Optimizers on the port's parameter trees: AdamW and Adafactor, the
counterpart of ``repro.optim``.

Adafactor (factored second moment + bf16 first moment) is the default for
≥100B-parameter configs: AdamW state at kimi-k2 scale would need ~16 TB,
Adafactor ~4.5 bytes/param.
"""
from repro_torch.optim.optimizers import (OptConfig, adafactor_init, adamw_init,
                                          apply_updates, global_norm, init_opt_state,
                                          opt_step, opt_update, schedule_lr)

__all__ = ["OptConfig", "adamw_init", "adafactor_init", "init_opt_state",
           "opt_update", "opt_step", "apply_updates", "global_norm", "schedule_lr"]
