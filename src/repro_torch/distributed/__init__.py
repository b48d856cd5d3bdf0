"""Distributed substrate of the port: the SA-driven sharding autotuner
(``repro_torch.distributed.autotune``; its ``autotune`` function keeps the
module's name, so the package exports the module, not the function),
int8 gradient compression, straggler monitoring and GPipe pipelining."""
from repro_torch.distributed import autotune
from repro_torch.distributed.autotune import (TuneProblem, decode_point,
                                              exhaustive_best, make_objective)
from repro_torch.distributed.compression import (compress_grads_tree,
                                                 compressed_psum, init_residuals)
from repro_torch.distributed.monitor import Heartbeat, StepTimer, StragglerMonitor
from repro_torch.distributed.pipeline import (bubble_fraction, make_pipelined_fn,
                                              pipeline_apply)

__all__ = ["autotune", "TuneProblem", "decode_point", "exhaustive_best",
           "make_objective", "compressed_psum", "compress_grads_tree", "init_residuals",
           "Heartbeat", "StepTimer", "StragglerMonitor",
           "pipeline_apply", "make_pipelined_fn", "bubble_fraction"]
