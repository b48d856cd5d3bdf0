"""Engine shards: the counterpart of ``repro.service.sharding``.

An :class:`EngineShard` pairs one ``torch.device`` with a private
:class:`~repro_torch.service.slots.SlotPool` and
:class:`~repro_torch.service.slots.RidTable`; the engine runs each shard's
dispatch groups as independent launches.  Rids (segment ids of the masked
champion exchange) are shard-local, so the segmented reduce of one shard
is the single-pool one.

Moving a job between shards is a host checkpoint on one and a restore on
the other (:class:`~repro_torch.service.slots.SwappedJob`); the
counter-based RNG keys on logical chain coordinates, so the move leaves
the trajectory bit-exact.  Which shard a request calls home, and which
jobs move, the scheduler decides (scheduler.py); this module only knows
devices and per-shard state.

The fleet is elastic (engine.py ``drain``/``resize``): a shard marked
``draining`` takes no new placements while its jobs are evacuated, and is
retired once empty.  ``index`` is therefore a stable identity: retired
indices are never reused and added shards get fresh ones.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.service.slots import RidTable, SlotPool


def slot_pool_devices(n_shards: int, device) -> List[torch.device]:
    """The devices backing ``n_shards`` engine shards.

    With ``device`` the card without an index (``"cuda"``), logical shards
    round-robin over the cards ``torch.cuda.device_count()`` reports, as
    the reference's oversubscribed rule does over ``jax.devices()``: on a
    one-card host every shard lives on ``cuda:0``.  A device with an index,
    or the CPU, backs every shard."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return [shard_device(i, device) for i in range(n_shards)]


def shard_device(index: int, device) -> torch.device:
    """The device of shard ``index`` (see :func:`slot_pool_devices`)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", index % max(torch.cuda.device_count(), 1))
    return device


@dataclasses.dataclass
class EngineShard:
    """One device's slice of the serving state."""

    index: int                  # stable shard id (never reused)
    device: torch.device        # where the shard's launches run
    pool: SlotPool
    rids: RidTable
    sweeps_done: int = 0        # block-sweeps on this shard (utilization
                                # numerator for per-shard occupancy)
    resident_ticks: int = 0     # engine ticks this shard was in the fleet
                                # (shards join and leave mid-run)
    draining: bool = False      # no new placements; evacuating to retire
    group_cache: dict = dataclasses.field(default_factory=dict)
                                # (family, dim, N) -> the fused macro-tick
                                # path's two state buffers and n_padded.
                                # When a group's membership is unchanged
                                # since its last launch, the host repack
                                # and upload are skipped
                                # (engine._launch_group_fused); a retired
                                # shard drops it, freeing the buffers

    @property
    def jobs(self):
        """rid -> ActiveJob resident on this shard."""
        return self.rids.jobs

    def occupancy(self, ticks: int = 0) -> float:
        """Fraction of this shard's slot-ticks spent sweeping.  Uses the
        shard's own residency by default; pass ``ticks`` to override the
        denominator."""
        denom = ticks if ticks else self.resident_ticks
        return self.sweeps_done / (max(denom, 1) * self.pool.n_slots)


def make_shard(index: int, n_slots: int, chains_per_slot: int,
               device) -> EngineShard:
    """One shard of ``n_slots`` slots on the device backing ``index`` (the
    grow path, where shards are added one at a time with fresh
    indices)."""
    return EngineShard(index=index, device=shard_device(index, device),
                       pool=SlotPool(n_slots, chains_per_slot),
                       rids=RidTable(n_slots))


def make_shards(n_devices: int, n_slots: int, chains_per_slot: int,
                device) -> List[EngineShard]:
    """The engine's shard list: ``n_slots`` slots per shard."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return [make_shard(i, n_slots, chains_per_slot, device)
            for i in range(n_devices)]
