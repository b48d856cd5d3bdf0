"""An op census of one step, in place of ``repro.launch.hloparse``.

The reference compiles each dry-run cell with XLA and reads its costs
from the optimized HLO text, guessing which buffers a fusing compiler
materializes.  The port has no HLO and nothing to guess: in eager torch
every aten op reads its operands and writes its outputs to device
memory.  So the census is a ``TorchDispatchMode`` over the step, run on
fake tensors (``FakeTensorMode``), that counts per op:

  hbm_bytes  = bytes of its tensor operands + bytes of its outputs;
               view and metadata ops (``view``, ``t``, ``expand``,
               ``slice``, ``select``, ``as_strided``, ``detach``, ...) and
               allocations (``empty``) count zero;
  wire bytes = per collective kind, the reference's ring model with n
               the size of the op's process group:
               all-gather: out·(n-1)/n     all-reduce: 2·in·(n-1)/n
               reduce-scatter: in·(n-1)/n  all-to-all: in·(n-1)/n
               collective-permute (a send): in;
  flops      = ``torch.utils.flop_counter.FlopCounterMode``'s count
               (matmuls, convolutions and attention, forward and
               backward);

and follows the live storages: every tensor handed in (:meth:`Census.hold`)
and every storage an op creates, until it is freed, so ``peak`` is the
most bytes held at once, with the temporaries that kernels allocate
inside themselves (:func:`hidden_bytes`) counted while the op runs.  On
a CUDA device each storage is rounded up to the caching allocator's
512-byte blocks.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

#: Ops that move no bytes: they alias their input or allocate without writing.
FREE_OPS = {aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh, aten.empty,
            aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
            aten._local_scalar_dense}

#: c10d op -> (collective kind, the position of its outputs among its
#: arguments (None: written in place of the inputs), that of its inputs).
COLLECTIVES = {
    "c10d::allreduce_": ("all-reduce", None, 0),
    "c10d::allreduce_coalesced_": ("all-reduce", None, 0),
    "c10d::_allgather_base_": ("all-gather", 0, 1),
    "c10d::allgather_": ("all-gather", 0, 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 0, 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "c10d::alltoall_base_": ("all-to-all", 0, 1),
    "c10d::alltoall_": ("all-to-all", 0, 1),
    "c10d::send": ("collective-permute", None, 0),
}

ALLOC_BLOCK = 512   # the CUDA caching allocator rounds every block up to 512 bytes


def hidden_bytes(func, args) -> int:
    """Bytes of the temporaries an op's CUDA kernel allocates inside
    itself, which no dispatch mode sees (each measured on the H100 by
    ``max_memory_allocated`` around the op): ``logsumexp`` writes
    ``(x - max).exp_()`` whole before it sums; the softmax backward a
    product the size of its gradient; and the softmax and its backward
    copy an operand that is not contiguous into one that is.  Such a
    temporary lives while the op's outputs do, and is written once and
    read once."""
    p = func.overloadpacket
    if p is aten.logsumexp:
        return _nbytes(args[0])
    if p is aten._softmax:
        return 0 if args[0].is_contiguous() else _nbytes(args[0])
    if p is aten._softmax_backward_data:
        return _nbytes(args[0]) + sum(_nbytes(t) for t in args[:2] if not t.is_contiguous())
    return 0


def wire_bytes(kind: str, in_bytes: float, out_bytes: float, n: int) -> float:
    """Bytes on the wire of one collective over ``n`` ranks, ring model."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "all-reduce":
        return 2 * in_bytes * frac
    if kind in ("reduce-scatter", "all-to-all"):
        return in_bytes * frac
    return in_bytes   # collective-permute


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group(args):
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    raise ValueError("a collective without a process group")


def _group_size(args) -> int:
    return _group(args).size()


class Census(TorchDispatchMode):
    """The census of the ops run under it (see the module's docstring).
    ``groups`` ({name: process group}, e.g. a mesh's axes) splits the wire
    bytes and the calls by the group each collective runs over
    (``wire_by_group``, ``calls_by_group``)."""

    def __init__(self, groups=None):
        super().__init__()
        self.groups = dict(groups or {})
        self.wire_by_group = defaultdict(lambda: defaultdict(float))
        self.calls_by_group = defaultdict(lambda: defaultdict(int))
        self.hbm_bytes = 0.0
        self.by_op = defaultdict(float)
        self.wire = defaultdict(float)
        self.coll_operands = defaultdict(float)
        self.calls = defaultdict(int)
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._held = {}

    def _storage_bytes(self, st) -> int:
        n = st.nbytes()
        if st.device.type == "cuda":
            n = -(-n // ALLOC_BLOCK) * ALLOC_BLOCK
        return n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = self._storage_bytes(st)
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._held.pop(key)

    def hold(self, *trees) -> int:
        """Count the tensors of ``trees`` (dicts and lists) as live from
        now on, as long as they are; returns their bytes."""
        before = self.live
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if func.namespace == "c10d":
            if name in COLLECTIVES:
                kind, o, i = COLLECTIVES[name]
                in_b = _nbytes(args[i])
                out_b = _nbytes(args[o]) if o is not None else in_b
                pg = _group(args)
                wire = wire_bytes(kind, in_b, out_b, pg.size())
                self.wire[kind] += wire
                name = next((k for k, g in self.groups.items() if g is pg), None)
                if name is not None:
                    self.wire_by_group[name][kind] += wire
                    self.calls_by_group[name][kind] += 1
                self.coll_operands[kind] += in_b
                self.calls[kind] += 1
                self.hbm_bytes += in_b + out_b
                self.by_op[kind] += in_b + out_b
            elif _nbytes((args, kwargs)):
                raise ValueError(f"the census has no ring model for {name}")
            return out
        op = str(func.overloadpacket)
        self.calls[op] += 1
        hidden = hidden_bytes(func, args)
        if not (func.is_view or func.overloadpacket in FREE_OPS):
            moved = _nbytes((args, kwargs)) + _nbytes(out) + 2 * hidden
            self.hbm_bytes += moved
            self.by_op[op] += moved
        for j, ret in enumerate(func._schema.returns):
            if ret.alias_info is None:   # a fresh tensor (or list of them)
                res = out if len(func._schema.returns) == 1 else out[j]
                for t in tree_leaves(res):
                    if isinstance(t, torch.Tensor):
                        self._track(t)
        self.peak = max(self.peak, self.live + hidden)
        return out

    def result(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes, "by_op": dict(self.by_op),
                "wire": dict(self.wire), "coll_operands": dict(self.coll_operands),
                "wire_by_group": {k: dict(v) for k, v in self.wire_by_group.items()},
                "calls_by_group": {k: dict(v) for k, v in self.calls_by_group.items()},
                "calls": dict(self.calls), "peak": self.peak}


@contextlib.contextmanager
def op_census(*held, groups=None):
    """``with op_census(state, batch) as c: step(...)``: a :class:`Census`
    of the ops run inside (``groups`` as there), the tensors of ``held``
    live from the start; its ``flops`` are filled on leaving."""
    census = Census(groups)
    census.hold(*held)
    counter = FlopCounterMode(display=False)
    with counter, census:
        yield census
    census.flops = counter.get_total_flops()
