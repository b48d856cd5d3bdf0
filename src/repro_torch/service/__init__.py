"""Multi-tenant SA serving engine on the card, the counterpart of
``repro.service``: slot pools on one or several engine shards, an
admission scheduler with overload policies, migration, drain, resize,
proactive degrade and completion deadlines, open-loop arrival processes,
and a continuous-batching tick loop that co-batches the continuous family
(kernel B1) and the QAP permutation family (kernel B3).

Usage::

    from repro_torch.service import EngineConfig, SARequest, SAServeEngine

    engine = SAServeEngine(EngineConfig(n_slots=8, chains_per_slot=512,
                                        macro_k=4))
    engine.submit(SARequest(req_id=0, objective="grid12", dim=12,
                            n_chains=512, T0=50.0, T_min=0.5, rho=0.9,
                            N=40, family="permutation"))
    results = engine.run()          # or engine.run_stream(ArrivalProcess...)

Or from the shell: ``python -m repro_torch.service.serve_sa --family qap``.
"""
from repro_torch.service.arrivals import ArrivalProcess, latency_summary
from repro_torch.service.engine import (EngineConfig, F_OPT, SAServeEngine,
                                        run_standalone)
from repro_torch.service.request import (OVERLOAD_POLICIES, RequestResult,
                                         SARequest, SERVABLE,
                                         TERMINAL_REASONS)
from repro_torch.service.scheduler import (AdmissionPlan, AdmissionScheduler,
                                           QueueEntry, SchedulerConfig,
                                           ShardView)
from repro_torch.service.sharding import EngineShard, slot_pool_devices
from repro_torch.service.slots import ActiveJob, SlotPool, SwappedJob

__all__ = [
    "EngineConfig", "SAServeEngine", "run_standalone", "F_OPT",
    "SARequest", "RequestResult", "SERVABLE", "OVERLOAD_POLICIES",
    "TERMINAL_REASONS",
    "AdmissionScheduler", "AdmissionPlan", "QueueEntry", "SchedulerConfig",
    "ShardView", "EngineShard", "slot_pool_devices", "SlotPool",
    "ActiveJob", "SwappedJob", "ArrivalProcess", "latency_summary",
]
