"""Device meshes over ``torch.distributed``, the counterpart of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank
of the process group, in rank order: rank ``r`` sits at the row-major
coordinate ``r`` of ``shape``.  Its device type is ``cuda`` unless the
caller asks for ``cpu``, and the process group's backend must follow the
device: NCCL for ``cuda``, gloo for ``cpu`` (gloo has no all-gather of
CUDA tensors, and NCCL none of CPU ones).

The reference runs SPMD code inside ``jax.shard_map`` over one process's
devices; torch runs it as one process per rank, so ``shard_map`` has no
counterpart here: every rank calls the same function, and a collective
names the mesh dims it runs over (:func:`axis_group`).  The process group
is the caller's, started before any mesh is made: by ``torchrun``, or by
hand with ``torch.distributed.init_process_group(backend,
store=torch.distributed.FileStore(path, world_size), rank=r,
world_size=world_size)`` (a ``HashStore`` serves a world of one).

``make_production_mesh`` (256 and 512 chips) serves the dry run
(``launch.dryrun``), over a fake world: torch's ``"fake"`` backend
(:func:`start_fake_world`), whose collectives return at once and move no
data.  A mesh over it sizes a step; it computes nothing.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device

#: The process-group backend each mesh device type needs.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

START_GROUP = (
    "start one before making a mesh: run under torchrun, or call "
    "torch.distributed.init_process_group(backend, store="
    "torch.distributed.FileStore(path, world_size), rank=rank, "
    "world_size=world_size) in every rank (nccl for cuda, gloo for cpu)")


FAKE_BACKEND = "fake"


def start_fake_world(world_size: int) -> None:
    """A process group of ``world_size`` ranks, this process being rank
    0, in which no other rank exists: the ``"fake"`` backend over
    ``FakeStore`` (torch's testing module), whose collectives return at
    once and move no data.  For the dry run only; end it with
    ``torch.distributed.destroy_process_group()``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world_size)


def require_group() -> None:
    """Raise, saying how to start one, unless a process group is up."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"no torch.distributed process group: {START_GROUP}")


def _check_group(device_type: str) -> None:
    """The process group's backend must be the one ``device_type``
    needs; the dry run's fake one passes for a ``cpu`` mesh only, so no
    mesh of the card ever runs over collectives that move nothing."""
    require_group()
    want = BACKENDS[device_type]
    have = str(dist.get_backend())
    if want not in have and not (have == FAKE_BACKEND and device_type == "cpu"):
        raise ValueError(
            f"a {device_type} mesh needs a {want} process group, not {have!r}")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks.  A ``cpu`` mesh over the world the
    caller started: for the dry run, :func:`start_fake_world` of that
    size, which needs no card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, "cpu")


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> DeviceMesh:
    """A mesh of ``shape`` over every rank, with dims named ``axes``, on
    ``device`` (default: the card).  ``prod(shape)`` must equal the world
    size.  The process group's backend follows the device (``BACKENDS``),
    or, for a ``cpu`` mesh, is the dry run's fake one."""
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"make_mesh: unsupported device {dev}")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    _check_group(dev.type)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def local_test_mesh(model: int = 1, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the whole world."""
    require_group()
    n = dist.get_world_size()
    return make_mesh((n // model, model), ("data", "model"), device)


def slot_pool_mesh(n_shards: int, device=None) -> List[torch.device]:
    """The devices backing the serving engine's ``n_shards`` shards,
    round-robin over the cards (``service/sharding.py``).  The engine's
    shards live in one process, so this is a list of devices, not a
    ``DeviceMesh``, and needs no process group."""
    from repro_torch.service.sharding import slot_pool_devices
    return slot_pool_devices(n_shards, resolve_device(device))


def dp_axes(mesh: DeviceMesh) -> tuple:
    """Axes used for batch/FSDP sharding ('pod' folds into DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def mesh_size(mesh: DeviceMesh) -> int:
    return int(mesh.mesh.numel())


def check_mesh(mesh, axes=None) -> tuple:
    """``axes`` (default: all of the mesh's dims) as a tuple, checked
    against ``mesh``, which must be a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_mesh), not {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    axes = names if axes is None else tuple(axes)
    if not axes or len(set(axes)) != len(axes) or not set(axes) <= set(names):
        raise ValueError(f"mesh axes {axes} must be distinct dims of {names}")
    return axes


def shard_count(mesh: DeviceMesh, axes) -> int:
    """How many shards the dims ``axes`` cut the chains into."""
    return int(np.prod([mesh.shape[mesh.mesh_dim_names.index(a)] for a in axes]))


def _coords(mesh: DeviceMesh) -> dict:
    """Global rank -> its coordinate tuple in the mesh."""
    m = mesh.mesh.numpy()
    return {int(r): c for c, r in np.ndenumerate(m)}


def shard_index(mesh: DeviceMesh, axes, rank=None) -> int:
    """The row-major coordinate of ``rank`` (default: this one) over the
    dims ``axes``, in the order given: the index of its slice of chains."""
    names = mesh.mesh_dim_names
    c = _coords(mesh)[dist.get_rank() if rank is None else rank]
    idx = 0
    for a in axes:
        d = names.index(a)
        idx = idx * mesh.shape[d] + c[d]
    return idx


def axis_group(mesh: DeviceMesh, axes):
    """The process group a collective over the dims ``axes`` runs on, and
    which of its members' contributions this rank reduces over.

    Returns ``(group, rows)``: an all-gather over ``group`` gives one row
    per member in the group's rank order, and ``rows`` lists the members
    that share this rank's coordinates on every other dim, in the order
    of their :func:`shard_index` over ``axes``.  One dim is the mesh's own
    group along it; all dims, the default group; a strict subset of
    several dims (a mesh of three or more dims) is gathered over the
    default group, whose other rows are replicas."""
    axes = check_mesh(mesh, axes)
    names = mesh.mesh_dim_names
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group = dist.group.WORLD
        if mesh_size(mesh) != dist.get_world_size():
            raise ValueError("a collective over several mesh dims needs the "
                             "mesh to hold every rank (launch.mesh.make_mesh)")
    members = dist.get_process_group_ranks(group)
    coords = _coords(mesh)
    mine = coords[dist.get_rank()]
    off = [names.index(a) for a in axes]
    same = [i for i, r in enumerate(members)
            if all(coords[r][d] == mine[d] for d in range(len(names))
                   if d not in off)]
    rows = sorted(same, key=lambda i: shard_index(mesh, axes, members[i]))
    return group, rows
