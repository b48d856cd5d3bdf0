"""Distributed substrate of the port: the SA-driven sharding autotuner,
``repro_torch.distributed.autotune`` (its ``autotune`` function keeps the
module's name, so the package exports the module, not the function).

The reference's gradient compression, monitoring and pipeline modules
wait for the training slice."""
from repro_torch.distributed import autotune
from repro_torch.distributed.autotune import (TuneProblem, decode_point,
                                              exhaustive_best, make_objective)

__all__ = ["autotune", "TuneProblem", "decode_point", "exhaustive_best",
           "make_objective"]
