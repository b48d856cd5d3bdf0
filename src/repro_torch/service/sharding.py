"""Engine shards: the counterpart of ``repro.service.sharding`` for one
card.

An :class:`EngineShard` pairs one ``torch.device`` with a private
:class:`~repro_torch.service.slots.SlotPool` and
:class:`~repro_torch.service.slots.RidTable`; the engine runs each shard's
dispatch groups as independent launches.  Rids (segment ids of the masked
champion exchange) are shard-local.  This slice serves one shard: several
shards, their migration and their drain belong to the elastic slice and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.service.slots import RidTable, SlotPool


@dataclasses.dataclass
class EngineShard:
    """One device's slice of the serving state."""

    index: int                  # stable shard id
    device: torch.device        # where the shard's launches run
    pool: SlotPool
    rids: RidTable
    sweeps_done: int = 0        # block-sweeps on this shard (utilization
                                # numerator for per-shard occupancy)
    resident_ticks: int = 0     # engine ticks this shard was in the fleet
    group_cache: dict = dataclasses.field(default_factory=dict)
                                # (family, dim, N) -> the fused macro-tick
                                # path's two state buffers, which one holds
                                # the group's state, and n_padded.  When a
                                # group's membership is unchanged since its
                                # last launch, the host repack and upload
                                # are skipped (engine._launch_group_fused)

    @property
    def jobs(self):
        """rid -> ActiveJob resident on this shard."""
        return self.rids.jobs

    def occupancy(self) -> float:
        """Fraction of this shard's slot-ticks spent sweeping."""
        return self.sweeps_done / (max(self.resident_ticks, 1)
                                   * self.pool.n_slots)


def make_shards(n_devices: int, n_slots: int, chains_per_slot: int,
                device: torch.device) -> List[EngineShard]:
    """The engine's shard list: one shard of ``n_slots`` slots on
    ``device``."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices > 1:
        raise NotImplementedError(
            "several engine shards (n_devices > 1) are not ported yet")
    return [EngineShard(index=0, device=device,
                        pool=SlotPool(n_slots, chains_per_slot),
                        rids=RidTable(n_slots))]
