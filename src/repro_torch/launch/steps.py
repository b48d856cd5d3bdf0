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

The training state takes the specs' layout: under ``make_train_step``'s
``specs`` each rank stores its block of every parameter, gradient and
optimizer moment (``distributed.sharded``), the experts of the
expert-parallel MoE as its E/ep slice, and its share of the batch.  The
compute over ``model`` follows the same specs (tensor parallelism,
``distributed.tensor_parallel``): q heads, ``d_ff``, ``d_inner`` and the
vocabulary are cut where the specs cut them, in the train step and in
the prefill and decode steps under a mesh with ``specs``, whose caches
hold the rank's rows, heads and channels (:func:`cache_blocks`).  Their
sequences are cut where :func:`cache_specs` cuts them: at a batch no
data axis divides, the GQA and MLA caches over the data axes, and under
``seq_shard_kv`` the GQA caches whose KV heads do not divide ``model``
(no window) and the MLA caches over ``model``; each rank holds its block
of the slots and a decode tick merges the group's partial softmaxes
(``distributed.sequence``).  ``seq_parallel`` cuts the stream between
layers on its sequence over ``model`` in the train and prefill steps
(Megatron-SP, ``models.model``), whose norms, ``pos_embed`` and other
leaves left whole over ``model`` then have partial gradients, summed
over it (:func:`partial_grad_paths`); the decode step keeps the
replicated stream.  ``repro.launch.shardctx`` has no counterpart: its ``constrain`` pins a
traced activation to a layout, where each of the port's ranks holds
local tensors, so :func:`activation_policy` gives the layout as DTensor
placements and nothing applies it.  Next tokens are int32, by
``torch.argmax`` (the first index on ties, as ``jnp.argmax``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch._tree import at, flatten, map_tree
from repro_torch.configs.common import SHAPES, ArchSpec
from repro_torch.distributed import sequence, sharded
from repro_torch.launch.mesh import dp_axes, mesh_axes
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state, opt_step
from repro_torch.optim.optimizers import leaf_groups


# ----------------------------------------------------------- spec assignment
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
            return at(pspecs, rest)
        kind, _, sub = rest.partition("/")
        if kind == "step":
            return ()
        if sub in param_paths:          # m, and AdamW's v
            return at(pspecs, sub)
        name, stat = sub.rsplit("/", 1)  # Adafactor's {"vr", "vc"} or {"v"}
        stacked, paths = groups[name]
        base = (None, *at(pspecs, paths[0])) if stacked else at(pspecs, paths[0])
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


def partial_grad_paths(pspecs, mesh, seq_parallel: bool = False) -> list:
    """The parameters whose gradient each rank of a ``model`` group
    holds a part of, to be summed over the group
    (``tensor_parallel.partial_grad``): leaves the specs leave whole
    inside a layer whose heads they cut (MLA's ``w_dkv``/``w_kr``, GQA's
    ``wk``/``wv`` where the KV heads do not divide), and under
    ``seq_parallel`` every leaf the specs leave whole over ``model`` (the
    rank's block of the sequence reads it).  Empty where the compute is
    not cut over ``model``."""
    from repro_torch.distributed import tensor_parallel as TP
    if TP.model_group(mesh, pspecs) is None:
        return []
    return [path for path, spec in sharded.spec_paths(pspecs).items()
            if TP.partial_grad(path, spec, pspecs, mesh, seq_parallel)]


def make_loss_and_grads(cfg: M.ModelConfig, mesh=None, specs=None):
    """``loss_and_grads(params, batch_data) -> (loss, {path: gradient})``
    of :func:`make_train_step`, every reduction over the mesh made: the
    parts of :func:`partial_grad_paths` summed over ``model``, then each
    gradient all-reduced over the data axes its leaf is not cut over and
    divided by their size, and the loss averaged over them.  ``specs``
    are the parameters' (``param_specs``)."""
    axes = dp_axes(mesh) if mesh is not None else ()
    fs = sharded.spec_paths(specs) if specs is not None else {}
    partial = set(partial_grad_paths(specs, mesh, cfg.seq_parallel))
    plan = M.sharding(cfg, mesh, specs) if specs is not None else None

    def mean_over(t, over):     # a group of one leaves t as it is
        over = [a for a in over if mesh_axes(mesh)[a] > 1]
        sharded.all_reduce_over(t, over, mesh)
        for a in over:
            t /= mesh_axes(mesh)[a]
        return t

    def loss_and_grads(params, batch_data):
        flat = flatten(params)
        loss = M.lm_loss(params, cfg, batch_data, mesh, plan)
        grads = torch.autograd.grad(loss, list(flat.values()), materialize_grads=True)
        loss = loss.detach()
        for path, g in zip(flat, grads):
            if path in partial:
                sharded.all_reduce_over(g, ("model",), mesh)
        if axes:
            for path, g in zip(flat, grads):
                cut = [a for d in (sharded.cut_axes(fs[path], mesh) if fs else ()) for a in d]
                mean_over(g, [a for a in axes if a not in cut])
            mean_over(loss, axes)
        return loss, dict(zip(flat, grads))

    return loss_and_grads


def make_train_step(cfg: M.ModelConfig, ocfg: OptConfig, mesh=None, batch=None, specs=None):
    """``train_step(state, batch_data) -> (state, loss)``: ``lm_loss``,
    its gradients by ``torch.autograd``, then the optimizer's update
    applied in place (``optim.opt_step``, Adafactor stacked by ``cfg``'s
    blocks).  ``state`` is ``{"params", "opt"}`` (``launch.train.build_state``),
    written in place and returned; ``loss`` is a 0-d float32 tensor.

    Under a mesh (a ``DeviceMesh``) each rank holds its share of the
    batch along the data axes (every dim but ``model``), the loss is
    averaged over them, and the MoE takes its expert-parallel form over
    ``model`` where ``cfg.moe_ep`` asks (``models.model._moe``).  With
    ``specs`` (:func:`train_specs`, the state's ``state_specs``) the
    state is each rank's blocks (``build_state(..., mesh=)``): every leaf
    is gathered where its layer runs, a leaf cut over ``model`` over the
    data axes only, as the rank computes with its block (tensor
    parallelism); its gradient comes back as the block, reduce-scattered
    over the data axes its spec names (``distributed.sharded.gather``),
    and the optimizer updates the blocks.  The gradient of a leaf whole
    on every rank but read by the rank's heads only is a part, summed
    over ``model`` (:func:`partial_grad_paths`); a leaf of the
    replicated stream has the same gradient on every rank of the group
    and is not summed.  With ``cfg.seq_parallel`` the stream between
    layers is the rank's block of the sequence, and every leaf whole over
    ``model`` has a part of the gradient, summed.  Without ``specs``
    every rank holds the whole state and computes replicated over
    ``model``.  Either way a gradient
    is then all-reduced over the data axes its leaf is not cut over, and
    divided by their size (:func:`make_loss_and_grads`).  ``batch`` is
    the reference's, which sizes its activation layout; the port has
    none and does not read it."""
    pspecs = specs["params"] if specs is not None else None
    loss_and_grads = make_loss_and_grads(cfg, mesh, pspecs)

    def train_step(state, batch_data):
        params = state["params"]
        loss, by_path = loss_and_grads(params, batch_data)
        opt_step(map_tree(lambda path, _: by_path[path], params), params, state["opt"], ocfg, cfg,
                 pspecs, mesh)
        return state, loss

    return train_step


@functools.lru_cache(maxsize=None)
def state_shapes(cfg: M.ModelConfig, ocfg: Optional[OptConfig] = None) -> dict:
    """The whole parameters (``models.model.init_params``), or with
    ``ocfg`` the whole ``{"params", "opt"}`` train state, as meta tensors
    of their shapes and dtypes: drawn on fake tensors, nothing allocated,
    once per configuration (kimi-k2 draws its 23040 experts one at a
    time); the tree is shared, so read it only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        tree = {"params": params, "opt": init_opt_state(params, ocfg, cfg)} if ocfg else params
    return map_tree(lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def train_specs(cfg: M.ModelConfig, ocfg: OptConfig, mesh) -> dict:
    """The train state's specs over ``mesh``: :func:`state_specs` of the
    whole state under :func:`param_specs`."""
    whole = state_shapes(cfg, ocfg)
    return state_specs(whole, param_specs(whole["params"], cfg, mesh), cfg)


def _next_token(logits, plan):
    """The greedy next token of each row of ``logits`` (..., V, or the
    rank's V/tp columns where ``plan`` cuts the head), int32: the first
    index of the largest."""
    if plan is not None and plan.head_tp is not None:
        from repro_torch.distributed import tensor_parallel as TP
        return TP.vocab_parallel_argmax(logits, plan.head_tp).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _serving_plan(cfg: M.ModelConfig, mesh, specs, batch, s_max, decode: bool = False):
    """The serving steps' :class:`models.model.Sharding` (the leaves'
    gathers, each layer's sequence cut of the caches :func:`cache_specs`
    lays out for the global ``batch`` of ``s_max`` positions, and the
    stream's sequence cut of ``seq_parallel`` in the prefill step, not in
    the ``decode`` step) and each layer's slots in the rank's cache (None
    for a cache with no sequence)."""
    if specs is None:
        return None, None
    if batch is None or s_max is None:
        raise ValueError("serving steps over a mesh with specs need the global batch "
                         "and s_max: the caches' layout depends on both")
    plan = M.sharding(cfg, mesh, specs, cache_specs(cfg, mesh, batch), s_max, decode=decode)
    slots = [cut.block if cut is not None else
             None if spec.kind == "mamba" else M.cache_length(spec, s_max)
             for cut, spec in zip(plan.seq, M.layer_specs(cfg))]
    return plan, slots


def _check_slots(slots, caches) -> None:
    """Raise unless each layer's cache holds the slots the plan gives it:
    caches laid out for another batch or ``s_max`` would be read as the
    whole sequence, or as another block of it."""
    if slots is None:
        return
    for j, (n, c) in enumerate(zip(slots, caches)):
        t = c.get("k", c.get("c_kv"))
        if n is not None and t.shape[1] != n:
            raise ValueError(f"layer {j}'s cache holds {t.shape[1]} slots where the steps' "
                             f"batch and s_max give the rank {n} (launch.steps.cache_blocks)")


def make_prefill_step(cfg: M.ModelConfig, mesh=None, specs=None, batch=None, s_max=None):
    """``prefill_step(params, batch_data, caches) -> (next_tok (B, 1)
    int32, caches)`` over ``batch_data["tokens"][:, :-1]`` (the training
    layout of S + 1 tokens), the vision stub's ``patch_embeds`` before
    them where the config has one, and the encoder-decoder's
    ``audio_frames`` (B, frontend_len, D) as the encoder's input.  Under
    ``mesh`` with ``specs`` (``param_specs``, or :func:`tp_only` of them)
    ``params`` are the rank's blocks and the compute is cut over
    ``model`` as in training; the caches are the rank's
    (:func:`cache_blocks` of the global ``batch`` and ``s_max``: where
    their sequence is cut, the rank keeps its block of the prefill's
    layout) and the batch its share along the data axes; ``batch`` and
    ``s_max`` are then required, and a cache of other slots raises.
    With ``cfg.seq_parallel`` the stream between layers is the rank's
    block of the prompt (``models.model``)."""
    plan, slots = _serving_plan(cfg, mesh, specs, batch, s_max)

    def prefill_step(params, batch_data, caches):
        _check_slots(slots, caches)
        kw = {}
        if cfg.frontend == "vision_stub":
            kw["embeds"] = batch_data["patch_embeds"]
        if cfg.kind == "encdec":
            kw["enc_frames"] = batch_data["audio_frames"]
        logits, caches = M.forward(params, cfg, batch_data["tokens"][:, :-1],
                                   caches=caches, mode="prefill", mesh=mesh, plan=plan, **kw)
        return _next_token(logits[:, -1:], plan), caches

    return prefill_step


def make_serve_step(cfg: M.ModelConfig, mesh=None, specs=None, batch=None, s_max=None):
    """``serve_step(params, caches, tokens (B, 1), pos (B,)) -> (next_tok
    (B, 1) int32, caches)``: one decode tick for the whole batch, the
    caches written in place; ``mesh``, ``specs``, ``batch`` and ``s_max``
    as in :func:`make_prefill_step`.  Where a layer's cache is cut on
    its sequence, the slot's owner writes the token and the group's
    partial softmaxes are merged (``distributed.sequence``).  The stream
    stays replicated under ``seq_parallel``: the reference's sequence
    constraint on one position changes no value."""
    plan, slots = _serving_plan(cfg, mesh, specs, batch, s_max, decode=True)

    def serve_step(params, caches, tokens, pos):
        _check_slots(slots, caches)
        positions = pos[:, None].expand(tokens.shape).to(torch.int32)
        logits, caches = M.forward(params, cfg, tokens, positions=positions,
                                   caches=caches, mode="decode", mesh=mesh, plan=plan)
        return _next_token(logits[:, -1], plan)[:, None], caches

    return serve_step


def cache_blocks(cfg: M.ModelConfig, mesh, batch: int, s_max: int, dtype=torch.bfloat16,
                 device=None, enc_len: int = 0) -> list:
    """The rank's decode caches over ``mesh`` for a global ``batch``:
    :func:`models.model.init_cache`'s for the rows, KV heads,
    cross-attention heads and Mamba channels that :func:`cache_specs`'
    batch and ``model`` entries give the rank, and for its block of each
    layer's slots where the sequence entry cuts them
    (``sequence.block_len``: the last blocks padded, their pad slots at
    position int32 max)."""
    sizes = mesh_axes(mesh)
    layers = cache_specs(cfg, mesh, batch)
    entries = {k: e for layer in layers for k, e in layer.items()}

    def parts(entry):
        return math.prod(sizes[a] for a in sharded.entry_axes(entry))

    def local(n, entry):
        return n // parts(entry)

    lengths = [sequence.block_len(M.cache_length(spec, s_max), parts(sequence.seq_entry(c)))
               for c, spec in zip(layers, M.layer_specs(cfg))]
    return M.init_cache(
        cfg, local(batch, next(iter(entries.values()))[0]), s_max,     # dim 0: the batch
        dtype=dtype, device=device, enc_len=enc_len,
        n_kv_heads=local(cfg.n_kv_heads, entries["k"][2]) if "k" in entries else None,
        n_heads=local(cfg.n_heads, entries["ck"][2]) if "ck" in entries else None,
        d_inner=local(cfg.d_inner, entries["h"][1]) if "h" in entries else None,
        lengths=lengths)


# ------------------------------------------------------------ cell assembly
@dataclasses.dataclass
class Cell:
    """One (arch × shape × mesh) dry-run unit: the port's step ``fn`` and
    its arguments ``args``, fake tensors of ``mode`` (run ``fn`` under
    it), at the shapes one rank holds.  ``parts`` names the arguments'
    trees (``state`` or ``params``, ``batch``, ``cache``); ``specs`` holds
    the reference layout's specs of the state (``param_specs`` /
    ``state_specs``) and ``whole`` the state (or parameters) whole, as
    fake tensors no rank holds (a serving cell's caches too, in
    ``whole_cache``, with their ``cache_specs``); ``layout`` says how the
    rank's share was cut."""
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
    whole: Any = None
    whole_cache: Any = None
    cache_specs: Any = None


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
    layout: a train cell's state as the rank's blocks by
    :func:`state_specs` and the sharded step; a serving cell's
    parameters as the rank's blocks by :func:`param_specs` (or
    :func:`tp_only` of them under ``serve_params_tp_only``) and the
    sharded prefill or decode step; both compute over ``model`` as the
    specs cut it.  The batch is split over the data axes by :func:`_fit`,
    the caches by :func:`cache_blocks` (the batch, ``model`` and the
    sequence where :func:`cache_specs` cuts them: a batch-1 cell's
    sequence over the data axes, and over ``model`` under
    ``seq_shard_kv``); a train or prefill cell's stream between layers
    the rank's block of the sequence under ``seq_parallel``.  The fake
    tensors lie on :func:`fake_device`; ``shape``: ``(seq, batch, kind)``
    in place of ``SHAPES[shape_name]``.  Allocates nothing."""
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
    sp = cfg.seq_parallel and kind != "decode" and axes["model"] > 1
    layout = {"device": dev.type, "batch_local": local, "batch_split_over": dp,
              "stream": ("the rank's block of the sequence over 'model' between layers "
                         "(seq_parallel), gathered where each block reads it" if sp else
                         "replicated over 'model'"),
              "params": ("the rank's block of every leaf of the state by state_specs (the data "
                         "axes and 'model' where a dim divides; the experts' E/ep slice under "
                         "moe_ep), gathered over the data axes where each layer runs, the "
                         "compute cut over 'model' as the specs cut the leaves"
                         if kind == "train" else
                         "the rank's block of every parameter by "
                         f"{'tp_only(param_specs)' if cfg.serve_params_tp_only else 'param_specs'}"
                         ", gathered over the data axes where each layer runs, the compute cut "
                         "over 'model' as the specs cut the leaves"),
              "cache": None if kind == "train" else
              ("the rank's KV heads and channels by cache_specs, and its block of the GQA "
               "and MLA caches' sequence over the data axes (batch 1)" if dp is None else
               "the rank's rows, KV heads and channels by cache_specs"
               + (", and its block of the MLA caches' sequence and that of the GQA caches "
                  "of a global layer whose KV heads do not divide 'model' over 'model' "
                  "(seq_shard_kv)"
                  if cfg.seq_shard_kv else ""))}
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        whole = map_tree(lambda _, t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                         state_shapes(cfg, ocfg if kind == "train" else None))
        params = whole["params"] if kind == "train" else whole
        pspecs = param_specs(params, cfg, mesh)
        if kind != "train" and cfg.serve_params_tp_only:
            pspecs = tp_only(pspecs)

        def fake(struct, n):
            return torch.zeros((n, *struct.shape[1:]), dtype=struct.dtype, device=dev)

        if kind == "train":
            specs = state_specs(whole, pspecs, cfg)
            state = sharded.shard_state(whole, specs, mesh)
            map_tree(lambda _, t: t.requires_grad_(True), state["params"])
            bdata = {k: fake(v, local) for k, v in batch_struct(cfg, seq, batch).items()}
            fn = make_train_step(cfg, ocfg, mesh, batch, specs=specs)
            args = (state, bdata)
            parts = {"state": state, "batch": bdata}
        else:
            params = sharded.shard_state(params, pspecs, mesh)
            enc_len = cfg.frontend_len if cfg.kind == "encdec" else 0
            cdt = M._dtype(cfg.compute_dtype)
            caches = cache_blocks(cfg, mesh, batch, seq, dtype=cdt, device=dev, enc_len=enc_len)
            whole_cache = M.init_cache(cfg, batch, seq, dtype=cdt, device=dev, enc_len=enc_len)
            if kind == "prefill":
                bdata = {k: fake(v, local) for k, v in batch_struct(cfg, seq, batch).items()}
                fn = make_prefill_step(cfg, mesh, pspecs, batch=batch, s_max=seq)
                args = (params, bdata, caches)
            else:  # decode
                bdata = {"tokens": torch.zeros((local, 1), dtype=torch.int32, device=dev),
                         "pos": torch.zeros((local,), dtype=torch.int32, device=dev)}
                fn = make_serve_step(cfg, mesh, pspecs, batch=batch, s_max=seq)
                args = (params, caches, bdata["tokens"], bdata["pos"])
            parts = {"params": params, "batch": bdata, "cache": caches}
            specs = pspecs
    return Cell(arch_id=spec.arch_id, shape_name=shape_name, kind=kind, fn=fn, args=args,
                model_cfg=cfg, mode=mode, parts=parts, specs=specs, layout=layout, ocfg=ocfg,
                whole=whole, whole_cache=None if kind == "train" else whole_cache,
                cache_specs=None if kind == "train" else cache_specs(cfg, mesh, batch))


def bytes_under_specs(tree, specs, mesh) -> int:
    """The bytes per device of ``tree`` laid out by ``specs`` (a spec
    tree of the same structure) over ``mesh``: each leaf's block, every
    dim cut into the product of the axes its entry names, rounded up
    where that does not divide it (the partitioner pads the last blocks:
    a cache's sequence)."""
    sizes = mesh_axes(mesh)

    def per_device(t, spec):
        if isinstance(t, dict):
            return sum(per_device(t[k], spec[k]) for k in t)
        if isinstance(t, list):
            return sum(per_device(a, b) for a, b in zip(t, spec))
        block = t.numel()
        for n, e in zip(t.shape, spec):
            if block:
                block = block // n * -(-n // math.prod(sizes[a] for a in sharded.entry_axes(e)))
        return block * t.element_size()

    return per_device(tree, specs)
