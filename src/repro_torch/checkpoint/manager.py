"""Checkpointing, the counterpart of ``repro.checkpoint.manager``.

Layout (one directory per step)::

    <root>/step_000000123.tmp/   — being written
        manifest.json          — step, extras, and each leaf's path, shape, dtype
        arr_000000.npy ...     — one file per leaf (its full value)
    <root>/step_000000123/       — atomically renamed when complete

A state is a tree of dicts and lists of tensors (the training state's
``{"params", "opt"}``); a leaf is named by its path in it
(``params/layers/3/attn/wq``), where the reference names leaves by their
order under a treedef string.  numpy has no bfloat16, so a bfloat16 leaf
is stored as its ``uint16`` bits and the manifest keeps its dtype.

* **Atomic publish** — a crash mid-save never corrupts the latest checkpoint;
  readers only ever see fully-written directories.
* **Async** — ``save_async`` copies the tensors to host memory, then writes
  on a background thread; training continues meanwhile.
* **Restore onto any device** — leaves are stored whole; ``restore`` places
  them on the device asked for (default: the one of ``state_like``'s leaf).
* **Any world size** — a state held as each rank's blocks
  (``distributed.sharded``; ``specs`` and ``mesh``) is gathered leaf by
  leaf to whole and written by rank 0 alone, as the reference saves whole
  leaves; restore reads each whole leaf and keeps the rank's block, as
  the reference's ``restore_state(..., shardings)`` does.  The files are
  the same at every world size, so a checkpoint of one restores at any
  other.
* **Retention** — keep the last N checkpoints, always keep multiples of K.
* **Emergency save** — SIGTERM handler hook for preemption (see train.py).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import flatten, map_tree
from repro_torch.distributed import sharded


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _writes(specs) -> bool:
    """Whether this rank writes: every rank of a whole state, rank 0 of
    a sharded one."""
    return specs is None or dist.get_rank() == 0


def _whole_leaves(state, specs, mesh):
    """(path, whole leaf) of ``state`` one leaf at a time, each gathered
    from every rank's block under ``specs`` (every rank must iterate)."""
    fs = sharded.spec_paths(specs) if specs is not None else None
    for path, leaf in flatten(state).items():
        leaf = leaf.detach()
        yield path, leaf if fs is None else sharded.gather_leaf(leaf, fs[path], mesh)


def save_state(root: str | Path, step: int, state, extras: Optional[dict] = None,
               specs=None, mesh=None):
    """Synchronous save with atomic publish: the leaves go to
    ``step_%09d.tmp``, which is then renamed ``step_%09d``.  With
    ``specs`` and ``mesh`` ``state`` holds each rank's blocks: every rank
    gathers each leaf in turn and rank 0 writes it."""
    if not _writes(specs):
        for _ in _whole_leaves(state, specs, mesh):
            pass
        return None
    root = Path(root)
    tmp = root / f"step_{step:09d}.tmp"
    final = root / f"step_{step:09d}"
    if final.exists():
        shutil.rmtree(final)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    n_leaves = len(flatten(state))
    manifest = {"step": step, "n_leaves": n_leaves, "extras": extras or {}, "leaves": []}
    for i, (path, leaf) in enumerate(_whole_leaves(state, specs, mesh)):
        np.save(tmp / f"arr_{i:06d}.npy", _to_numpy(leaf))
        manifest["leaves"].append({"index": i, "path": path, "shape": list(leaf.shape),
                                   "dtype": str(leaf.dtype).removeprefix("torch.")})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    os.replace(tmp, final)  # atomic publish
    return final


class CheckpointManager:
    """Async checkpoint writer with retention policy.  With ``specs`` and
    ``mesh`` the states it saves and restores are each rank's blocks (see
    the module's docstring); every rank calls each method."""

    def __init__(self, root: str | Path, keep_last: int = 3, keep_every: int = 0, *,
                 specs=None, mesh=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.specs, self.mesh = specs, mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, state, extras: Optional[dict] = None):
        """Copy to host memory now (whole leaves, gathered under
        ``specs``); write + publish in the background (rank 0 alone under
        ``specs``)."""
        self.wait()  # one in-flight save at a time
        writes = _writes(self.specs)
        host = {path: leaf.to("cpu", copy=True) if writes else None
                for path, leaf in _whole_leaves(state, self.specs, self.mesh)}
        if not writes:
            return
        host_state = map_tree(lambda path, _: host[path], state)

        def work():
            try:
                save_state(self.root, step, host_state, extras)
                self._gc()
            except BaseException as e:  # noqa: BLE001  (re-raised by wait())
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, state, extras: Optional[dict] = None):
        self.wait()
        save_state(self.root, step, state, extras, self.specs, self.mesh)
        if _writes(self.specs):
            self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(all_steps(self.root))
        doomed = steps[:-self.keep_last] if self.keep_last else []
        for s in doomed:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.root)

    def restore(self, state_like, step: Optional[int] = None, device=None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return restore_state(self.root, step, state_like, device, self.specs, self.mesh)


def all_steps(root: str | Path):
    root = Path(root)
    out = []
    for p in root.glob("step_*"):
        if p.suffix == ".tmp" or not p.is_dir():
            continue
        try:
            out.append(int(p.name.split("_")[1]))
        except ValueError:
            continue
    return out


def latest_step(root: str | Path) -> Optional[int]:
    steps = all_steps(root)
    return max(steps) if steps else None


def restore_state(root: str | Path, step: int, state_like, device=None, specs=None,
                  mesh=None):
    """Restore into the structure of ``state_like`` (a tree of tensors):
    each leaf by its path, its shape checked, in the dtype of
    ``state_like``'s leaf, on ``device`` (default: that leaf's device).
    With ``specs`` and ``mesh`` ``state_like`` holds this rank's blocks:
    each whole leaf is read, checked against the block's whole shape,
    and cut to the block.  Returns (state, extras)."""
    d = Path(root) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    stored = {rec["path"]: rec for rec in manifest["leaves"]}
    want = flatten(state_like)
    if set(stored) != set(want):
        raise ValueError(f"checkpoint leaves differ: missing {sorted(set(want) - set(stored))}, "
                         f"unexpected {sorted(set(stored) - set(want))}")

    fs = sharded.spec_paths(specs) if specs is not None else None

    def load(path, like):
        rec = stored[path]
        t = _from_numpy(np.load(d / f"arr_{rec['index']:06d}.npy"), rec["dtype"])
        want = tuple(like.shape) if fs is None else sharded.whole_shape(like.shape, fs[path], mesh)
        if tuple(t.shape) != want:
            raise ValueError(f"leaf {path}: shape {tuple(t.shape)} != {want}")
        if fs is not None:
            t = sharded.shard_leaf(t, fs[path], mesh)
        return t.to(device=like.device if device is None else device, dtype=like.dtype)

    return map_tree(load, state_like), manifest["extras"]
