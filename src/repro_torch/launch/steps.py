"""Training and serving steps of the LLM scaffold, the counterpart of
``repro.launch.steps``: ``make_train_step``, ``make_prefill_step`` and
``make_serve_step`` as plain functions on tensors; the reference's
sharding rules (:func:`param_specs`, :func:`state_specs`,
:func:`cache_specs`, :func:`batch_specs`, :func:`activation_policy`) as
pure functions over shapes and a mesh's sizes; and the dry run's cells
(:class:`Cell`, :func:`build_cell`), whose arguments are fake tensors.

A spec is a tuple with one entry per dim: ``None``, a mesh axis name or
a tuple of them, the reference's ``PartitionSpec`` entries value for
value.  The reference stacks each group's layers on a leading
``repeats`` axis (spec ``None``); the port keeps one dict per layer, so
a layer's spec here is the reference's without that entry.  A mesh is a
``DeviceMesh`` or a ``(sizes, names)`` pair: the rules read only its
axes' names and sizes.

The specs describe the reference's layout, which the port's compute does
not take: every rank holds the whole state and its share of the batch
(ROADMAP.md section A, item 5), and the layout knobs ``seq_shard_kv``,
``serve_params_tp_only`` and ``seq_parallel`` change the specs only.
``repro.launch.shardctx`` has no counterpart: its ``constrain`` pins a
traced activation to a layout, where each of the port's ranks holds
local tensors, so :func:`activation_policy` gives the layout as DTensor
placements and nothing applies it.  Next tokens are int32, by
``torch.argmax`` (the first index on ties, as ``jnp.argmax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch._tree import flatten, map_tree
from repro_torch.configs.common import SHAPES, ArchSpec
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state, opt_step
from repro_torch.optim.optimizers import leaf_groups


# ----------------------------------------------------------- spec assignment
def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a ``(sizes, names)`` pair."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    sizes, names = mesh
    return dict(zip(names, sizes))


def _dp(axes: dict) -> tuple:
    """The batch and FSDP axes: every axis but 'model' ('pod' folds into DP)."""
    return tuple(a for a in axes if a != "model")


def _fit(size: int, axes: tuple, mesh) -> Optional[Any]:
    """Largest prefix of ``axes`` whose product divides ``size``."""
    sizes = mesh_axes(mesh)
    out = []
    prod = 1
    for a in axes:
        if size % (prod * sizes[a]) == 0:
            out.append(a)
            prod *= sizes[a]
    if not out:
        return None
    return tuple(out) if len(out) > 1 else out[0]


_BASE_NDIM = {
    "wq": 3, "wk": 3, "wv": 3, "wo": 3, "w_uk": 3, "w_uv": 3, "A_log": 2,
    "w_dkv": 2, "w_kr": 2, "router": 2, "in_proj": 2, "out_proj": 2,
    "x_proj": 2, "dt_proj": 2, "conv_w": 2, "conv_b": 1, "dt_bias": 1,
    "D": 1, "norm1": 1, "norm2": 1, "normc": 1, "final_norm": 1,
    "embed": 2, "lm_head": 2, "pos_embed": 2,
    "w_gate": 2, "w_up": 2, "w_down": 2,
}


def _leaf_spec(name: str, shape: tuple, cfg: M.ModelConfig, mesh) -> tuple:
    """The reference's spec of a leaf named ``name`` of ``shape`` (its
    stacked shape where the reference stacks it)."""
    fsdp = _dp(mesh_axes(mesh))
    tp = mesh_axes(mesh)["model"]

    def tpm(size):  # 'model' when divisible
        return "model" if size % tp == 0 else None

    def f(size):  # FSDP axes that fit
        return _fit(size, fsdp, mesh)

    nd = len(shape)
    base = _BASE_NDIM.get(name, nd)
    is_moe = False
    if name in ("w_gate", "w_up", "w_down") and nd >= 3 \
            and cfg.n_experts and shape[nd - 3] == cfg.n_experts:
        base = 3
        is_moe = True
    lead = (None,) * (nd - base)
    t = shape[nd - base:] if base else ()
    if name in ("wq", "wk", "wv"):
        s = (f(t[0]), tpm(t[1]), None)
    elif name == "wo":
        s = (tpm(t[0]), None, f(t[2]))
    elif name in ("w_uk", "w_uv"):
        s = (None, tpm(t[1]), None)
    elif name in ("w_dkv", "w_kr", "router"):
        s = (f(t[0]), None)
    elif name in ("w_gate", "w_up"):
        s = (tpm(t[0]), f(t[1]), None) if is_moe else (f(t[0]), tpm(t[1]))
    elif name == "w_down":
        s = (tpm(t[0]), None, f(t[2])) if is_moe else (tpm(t[0]), f(t[1]))
    elif name == "in_proj":
        s = (f(t[0]), tpm(t[1]))
    elif name == "out_proj":
        s = (tpm(t[0]), f(t[1]))
    elif name == "x_proj":
        s = (tpm(t[0]), None)
    elif name in ("dt_proj", "conv_w"):
        s = (None, tpm(t[1]))
    elif name in ("conv_b", "dt_bias", "D"):
        s = (tpm(t[0]),)
    elif name == "A_log":
        s = (tpm(t[0]), None)
    elif name == "embed":
        s = (tpm(t[0]), f(t[1]))
    elif name == "lm_head":
        s = (f(t[0]), tpm(t[1]))
    elif name == "pos_embed":
        s = (None, f(t[1]))
    else:  # norms and anything unknown: replicated
        s = (None,) * base
    return lead + tuple(s)


def _repeats(cfg: M.ModelConfig) -> dict:
    """{"layers": [each layer's group repeats], "enc/layers": [...]}: the
    leading axis the reference stacks each layer's leaves on."""
    out = {"layers": [reps for pattern, reps in cfg.blocks for _ in range(reps)
                      for _ in pattern]}
    if cfg.kind == "encdec":
        out["enc/layers"] = [cfg.n_enc_layers] * cfg.n_enc_layers
    return out


def _stacked(path: str, reps: dict) -> Optional[int]:
    """The repeats the reference stacks the leaf at ``path`` on, or None."""
    for head, r in reps.items():
        if path.startswith(head + "/"):
            return r[int(path[len(head) + 1:].split("/", 1)[0])]
    return None


def param_specs(params_shapes, cfg: M.ModelConfig, mesh):
    """Specs mirroring the port's parameter tree (leaves with ``.shape``):
    each leaf's the reference's, computed on its stacked shape and less
    the stacked axis's ``None``."""
    reps = _repeats(cfg)

    def spec(path, leaf):
        r = _stacked(path, reps)
        name = path.rsplit("/", 1)[-1]
        if r is None:
            return _leaf_spec(name, tuple(leaf.shape), cfg, mesh)
        return _leaf_spec(name, (r, *leaf.shape), cfg, mesh)[1:]

    return map_tree(spec, params_shapes)


def tp_only(pspecs):
    """The serving layout of ``serve_params_tp_only``: the FSDP axes
    stripped, so weights are TP-sharded and DP-replicated (no per-step
    weight all-gather)."""
    if isinstance(pspecs, dict):
        return {k: tp_only(v) for k, v in pspecs.items()}
    if isinstance(pspecs, list):
        return [tp_only(v) for v in pspecs]
    return tuple(a if a == "model" else None for a in pspecs)


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def state_specs(state_shapes, pspecs, model: M.ModelConfig):
    """Specs for the ``{"params", "opt"}`` train state: the moments
    mirror the parameters; Adafactor's second moments, kept per stacked
    leaf (``optim.leaf_groups``), take the stacked leaf's spec (the
    layer's with the leading ``None``), ``vr`` less its last entry and
    ``vc`` less its second last.  ``model`` gives the stacking."""
    params = state_shapes["params"]
    param_paths = set(flatten(params))
    groups = leaf_groups(params, model)

    def spec(path, _):
        head, _, rest = path.partition("/")
        if head == "params":
            return _at(pspecs, rest)
        kind, _, sub = rest.partition("/")
        if kind == "step":
            return ()
        if sub in param_paths:          # m, and AdamW's v
            return _at(pspecs, sub)
        name, stat = sub.rsplit("/", 1)  # Adafactor's {"vr", "vc"} or {"v"}
        stacked, paths = groups[name]
        base = (None, *_at(pspecs, paths[0])) if stacked else _at(pspecs, paths[0])
        return {"v": base, "vr": base[:-1], "vc": base[:-2] + base[-1:]}[stat]

    return map_tree(spec, state_shapes)


def cache_specs(cfg: M.ModelConfig, mesh, batch: int) -> list:
    """Specs mirroring ``init_cache``, one dict per layer.  Batch 1 ->
    sequence-parallel caches (the sequence axis over the DP axes)."""
    fsdp = _dp(mesh_axes(mesh))
    tp = mesh_axes(mesh)["model"]
    bspec = _fit(batch, fsdp, mesh)
    seq_par = bspec is None  # long-context: shard the sequence axis instead
    if seq_par:   # as a PartitionSpec entry: one axis by its name
        seq_axes = fsdp if len(fsdp) > 1 else fsdp[0]

    def layer_spec(spec: M.LayerSpec):
        if spec.kind == "mamba":
            c = {"conv": (bspec, None, "model" if cfg.d_inner % tp == 0 else None),
                 "h": (bspec, "model" if cfg.d_inner % tp == 0 else None, None)}
        elif spec.kind == "mla":
            sq = seq_axes if seq_par else None
            if sq is None and cfg.seq_shard_kv:
                sq = "model"  # flash-decode layout: latent cache seq-sharded
            c = {"c_kv": (bspec, sq, None), "k_rope": (bspec, sq, None), "pos_k": (bspec, sq)}
        else:
            kvs = "model" if cfg.n_kv_heads % tp == 0 else None
            sq = seq_axes if seq_par else None
            if kvs is None and sq is None and cfg.seq_shard_kv and spec.window is None:
                # flash-decode layout: KV heads don't divide TP, so shard
                # the cache sequence over 'model' instead of replicating.
                sq = "model"
            c = {"k": (bspec, sq, kvs, None), "v": (bspec, sq, kvs, None), "pos_k": (bspec, sq)}
        if spec.cross_attn:
            hs = "model" if cfg.n_heads % tp == 0 else None
            c["ck"] = (bspec, None, hs, None)
            c["cv"] = (bspec, None, hs, None)
        return c

    return [layer_spec(spec) for spec in M.layer_specs(cfg)]


# ------------------------------------------------------------- input structs
class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype, with no data."""
    shape: tuple
    dtype: torch.dtype


def batch_struct(cfg: M.ModelConfig, seq: int, batch: int) -> dict:
    """Shapes and dtypes of one training/prefill batch: ``seq`` positions
    (the vision stub's prefix among them) and one more token."""
    text = seq
    b = {}
    if cfg.frontend == "vision_stub":
        text = seq - cfg.frontend_len
        b["patch_embeds"] = ShapeDtype((batch, cfg.frontend_len, cfg.d_model),
                                       M._dtype(cfg.compute_dtype))
    if cfg.kind == "encdec":
        b["audio_frames"] = ShapeDtype((batch, cfg.frontend_len, cfg.d_model),
                                       M._dtype(cfg.compute_dtype))
    b["tokens"] = ShapeDtype((batch, text + 1), torch.int32)
    return b


def batch_specs(cfg: M.ModelConfig, mesh, batch: int) -> dict:
    dp = _fit(batch, _dp(mesh_axes(mesh)), mesh)
    b = {"tokens": (dp, None)}
    if cfg.frontend == "vision_stub":
        b["patch_embeds"] = (dp, None, None)
    if cfg.kind == "encdec":
        b["audio_frames"] = (dp, None, None)
    return b


def placements(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements, one per mesh axis in the mesh's
    order: ``Shard(d)`` where dim d's entry names the axis, else
    ``Replicate()``."""
    where = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in mesh_axes(mesh))


def activation_policy(cfg: M.ModelConfig, mesh, batch: int) -> dict:
    """The reference's activation layouts ({name: placements}): the
    hidden state and logits split over the DP axes (logits' vocab over
    'model' when it divides), and the ``seq_parallel`` and
    ``seq_shard_kv`` layouts where those knobs are on."""
    dp = _fit(batch, _dp(mesh_axes(mesh)), mesh)
    pol = {
        "hidden": (dp, None, None),
        "logits": (dp, None, "model" if cfg.vocab_size % mesh_axes(mesh)["model"] == 0 else None),
    }
    if cfg.seq_parallel:
        pol["hidden_sp"] = (dp, "model", None)
    if cfg.seq_shard_kv:
        pol["kv_sp"] = (dp, "model", None, None)
        pol["kvpos_sp"] = (dp, "model")
        pol["scores_sp"] = (dp, None, None, "model")
    return {k: placements(v, mesh) for k, v in pol.items()}


def make_train_step(cfg: M.ModelConfig, ocfg: OptConfig, mesh=None, batch=None):
    """``train_step(state, batch_data) -> (state, loss)``: ``lm_loss``,
    its gradients by ``torch.autograd``, then the optimizer's update
    applied in place (``optim.opt_step``, Adafactor stacked by ``cfg``'s
    blocks).  ``state`` is ``{"params", "opt"}`` (``launch.train.build_state``),
    written in place and returned; ``loss`` is a 0-d float32 tensor.

    Under a mesh (a ``DeviceMesh``) every rank holds the whole state and
    its share of the batch along the data axes (every dim but
    ``model``): the gradients and the loss are averaged over those axes,
    one all-reduce per axis, and the MoE takes its expert-parallel form
    over ``model`` where ``cfg.moe_ep`` asks (``models.model._moe``).
    ``batch`` is the reference's, which sizes its activation layout; the
    port has none and does not read it."""
    axes = dp_axes(mesh) if mesh is not None else ()

    def mean_over_data(t):
        for a in axes:
            dist.all_reduce(t, group=mesh.get_group(a))
        for a in axes:
            t /= mesh.shape[mesh.mesh_dim_names.index(a)]
        return t

    def train_step(state, batch_data):
        params = state["params"]
        flat = flatten(params)
        loss = M.lm_loss(params, cfg, batch_data, mesh)
        grads = torch.autograd.grad(loss, list(flat.values()), materialize_grads=True)
        loss = loss.detach()
        if axes:
            for g in grads:
                mean_over_data(g)
            mean_over_data(loss)
        by_path = dict(zip(flat, grads))
        opt_step(map_tree(lambda path, _: by_path[path], params), params, state["opt"], ocfg, cfg)
        return state, loss

    return train_step


def make_prefill_step(cfg: M.ModelConfig):
    """``prefill_step(params, batch_data, caches) -> (next_tok (B, 1)
    int32, caches)`` over ``batch_data["tokens"][:, :-1]`` (the training
    layout of S + 1 tokens), the vision stub's ``patch_embeds`` before
    them where the config has one, and the encoder-decoder's
    ``audio_frames`` (B, frontend_len, D) as the encoder's input."""
    def prefill_step(params, batch_data, caches):
        kw = {}
        if cfg.frontend == "vision_stub":
            kw["embeds"] = batch_data["patch_embeds"]
        if cfg.kind == "encdec":
            kw["enc_frames"] = batch_data["audio_frames"]
        logits, caches = M.forward(params, cfg, batch_data["tokens"][:, :-1],
                                   caches=caches, mode="prefill", **kw)
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32), caches

    return prefill_step


def make_serve_step(cfg: M.ModelConfig):
    """``serve_step(params, caches, tokens (B, 1), pos (B,)) -> (next_tok
    (B, 1) int32, caches)``: one decode tick for the whole batch, the
    caches written in place."""
    def serve_step(params, caches, tokens, pos):
        positions = pos[:, None].expand(tokens.shape).to(torch.int32)
        logits, caches = M.forward(params, cfg, tokens, positions=positions,
                                   caches=caches, mode="decode")
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32), caches

    return serve_step


# ------------------------------------------------------------ cell assembly
@dataclasses.dataclass
class Cell:
    """One (arch × shape × mesh) dry-run unit: the port's step ``fn`` and
    its arguments ``args``, fake tensors of ``mode`` (run ``fn`` under
    it), at the shapes one rank holds.  ``parts`` names the arguments'
    trees (``state`` or ``params``, ``batch``, ``cache``); ``specs`` holds
    the reference layout's specs of the state (``param_specs`` /
    ``state_specs``); ``layout`` says how the rank's share was cut."""
    arch_id: str
    shape_name: str
    kind: str
    fn: Any
    args: tuple
    model_cfg: M.ModelConfig
    mode: Any
    parts: dict
    specs: Any
    layout: dict
    ocfg: Optional[OptConfig] = None


def _dryrun_model_cfg(spec: ArchSpec, shape_name: str, mesh,
                      overrides: Optional[dict] = None, shape: Optional[tuple] = None
                      ) -> M.ModelConfig:
    seq, batch, kind = shape or SHAPES[shape_name]
    over = dict(
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="dots" if kind == "train" else "none",
        moe_ep=bool(spec.model.n_experts) and batch >= 16,
    )
    over.update(overrides or {})
    return dataclasses.replace(spec.model, **over)


def fake_device() -> torch.device:
    """``cuda`` where fake CUDA tensors work whole (a view's storage
    too, which a CPU-only build of torch refuses), else ``cpu``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    try:
        with FakeTensorMode():
            torch.empty(2, device="cuda")[1:].untyped_storage()
        return torch.device("cuda")
    except RuntimeError:
        return torch.device("cpu")


def build_cell(spec: ArchSpec, shape_name: str, mesh, ocfg: Optional[OptConfig] = None,
               overrides: Optional[dict] = None, shape: Optional[tuple] = None) -> Cell:
    """The port's step and fake arguments for one cell over ``mesh`` (a
    ``DeviceMesh``, over a fake world for the dry run), in the port's
    layout: the whole parameters (and optimizer state) on the rank, the
    batch split over the data axes by :func:`_fit`, the caches the same
    way, and where ``_fit`` gives None (batch 1) the whole cache, as the
    port has no sequence parallelism.  The fake tensors lie on
    :func:`fake_device`; ``shape``: ``(seq, batch, kind)`` in place of
    ``SHAPES[shape_name]``.  Allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    seq, batch, kind = shape or SHAPES[shape_name]
    cfg = _dryrun_model_cfg(spec, shape_name, mesh, overrides, shape)
    if ocfg is None and kind == "train":
        big = cfg.param_count()[0] > 50e9
        ocfg = OptConfig(kind="adafactor" if big else "adamw",
                         moment_dtype="bfloat16" if big else "float32")
    dev = fake_device()
    axes = mesh_axes(mesh)
    dp = _fit(batch, _dp(axes), mesh)
    split = math.prod(axes[a] for a in ((dp,) if isinstance(dp, str) else dp or ()))
    local = batch // split
    layout = {"device": dev.type, "batch_local": local, "batch_split_over": dp,
              "params": "whole on every rank",
              "cache": None if kind == "train" else
              ("split like the batch" if dp else "whole on the rank (no sequence parallelism)")}
    mode = FakeTensorMode(allow_non_fake_inputs=True)  # init_params' numpy constants
    with mode:
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        params = map_tree(lambda _, t: t.to(dev), params)
        pspecs = param_specs(params, cfg, mesh)
        if kind != "train" and cfg.serve_params_tp_only:
            pspecs = tp_only(pspecs)

        def fake(struct, n):
            return torch.zeros((n, *struct.shape[1:]), dtype=struct.dtype, device=dev)

        if kind == "train":
            params = map_tree(lambda _, t: t.requires_grad_(True), params)
            state = {"params": params, "opt": init_opt_state(params, ocfg, cfg)}
            bdata = {k: fake(v, local) for k, v in batch_struct(cfg, seq, batch).items()}
            fn = make_train_step(cfg, ocfg, mesh, batch)
            args = (state, bdata)
            parts = {"state": state, "batch": bdata}
            specs = state_specs(state, pspecs, cfg)
        else:
            enc_len = cfg.frontend_len if cfg.kind == "encdec" else 0
            caches = M.init_cache(cfg, local, seq, dtype=M._dtype(cfg.compute_dtype),
                                  device=dev, enc_len=enc_len)
            if kind == "prefill":
                bdata = {k: fake(v, local) for k, v in batch_struct(cfg, seq, batch).items()}
                fn = make_prefill_step(cfg)
                args = (params, bdata, caches)
            else:  # decode
                bdata = {"tokens": torch.zeros((local, 1), dtype=torch.int32, device=dev),
                         "pos": torch.zeros((local,), dtype=torch.int32, device=dev)}
                fn = make_serve_step(cfg)
                args = (params, caches, bdata["tokens"], bdata["pos"])
            parts = {"params": params, "batch": bdata, "cache": caches}
            specs = pspecs
    return Cell(arch_id=spec.arch_id, shape_name=shape_name, kind=kind, fn=fn, args=args,
                model_cfg=cfg, mode=mode, parts=parts, specs=specs, layout=layout, ocfg=ocfg)


def bytes_under_specs(tree, specs, mesh) -> int:
    """The bytes per device of ``tree`` laid out by ``specs`` (a spec
    tree of the same structure) over ``mesh``: each leaf's bytes over
    the product of the axes its spec names."""
    sizes = mesh_axes(mesh)

    def per_device(t, spec):
        if isinstance(t, dict):
            return sum(per_device(t[k], spec[k]) for k in t)
        if isinstance(t, list):
            return sum(per_device(a, b) for a, b in zip(t, spec))
        shards = math.prod(sizes[a] for e in spec for a in (e if isinstance(e, tuple) else (e,))
                           if a is not None)
        return t.numel() * t.element_size() // shards

    return per_device(tree, specs)
