"""AdamW and Adafactor on the port's parameter trees, the counterpart of
``repro.optim.optimizers``: the same configuration, schedule, clip and
arithmetic, computed in place.

The reference's optimizer sees *stacked* leaves: every layer of a
``(pattern, repeats)`` group holds each weight with a leading ``repeats``
axis (``repro.models.model.init_params``), where the port keeps one dict
per layer.  AdamW is elementwise, so only ``global_norm`` spans leaves.
Adafactor is not: it factors the last two axes of a stacked leaf, so a
stacked norm vector ``(repeats, D)`` keeps row statistics ``vr
(repeats,)`` and column statistics ``vc (D,)`` shared by the group's
layers, and it clips the update's RMS once per stacked leaf.  From the
model's configuration (``model``, a ``ModelConfig``), the port stacks
each group's layers the same way for Adafactor's statistics and clip,
and keeps Adafactor's second moments per stacked leaf, named by the
reference's tree path (``groups/<g>/<i>/attn/wq``, ``embed``):
:func:`leaf_groups`.

State: ``{"m": a tree like the parameters, "v": a tree like them
(AdamW) or {stacked name: {"vr", "vc"} or {"v"}} (Adafactor), "step":
int32}``, on the parameters' device.  :func:`opt_update` and
:func:`opt_step` write it in place under ``torch.no_grad()``, one leaf at
a time, so the old and new state are never held together.

Blocks: with ``specs`` (``launch.steps.param_specs`` of the whole
parameters) and ``mesh``, the parameters, gradients and state are each
rank's blocks (``distributed.sharded``).  AdamW is elementwise and runs
as it is.  The sums that span a leaf are summed over the axes that cut
it: ``global_norm`` counts each leaf once, all-reducing its blocks'
squares over the axes its spec names only; Adafactor decides what to
factor on the whole stacked shape, and its row and column means and its
clip's mean are partial sums all-reduced over the axes that cut the
reduced dims, over the whole size (``sharded.partial_mean``); its ``vr``
and ``vc`` are blocks too, laid out as ``state_specs`` says.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._tree import flatten, map_tree
from repro_torch.distributed import sharded


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"        # 'adamw' | 'adafactor'
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999          # adafactor: decay for factored 2nd moment
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"   # 'bfloat16' halves 1st-moment memory


# ------------------------------------------------------------------ trees
def _layer_places(blocks) -> list:
    """(group, position in the pattern) of every layer, in the order the
    blocks apply them."""
    return [(g, i) for g, (pattern, reps) in enumerate(blocks)
            for _ in range(reps) for i in range(len(pattern))]


def leaf_groups(tree, model) -> dict:
    """The leaves the reference's optimizer sees: {name: (stacked, [paths
    of the port's leaves, in repeat order])}.  The layers of
    ``tree["layers"]`` (and ``tree["enc"]["layers"]``) are stacked by
    their group of ``model.blocks`` and place in the pattern, named by
    the reference's tree path ``groups/<g>/<i>/...``
    (``enc/groups/0/0/...``); a stacked leaf keeps its leading repeats
    axis even when the group repeats once.  Every other leaf stands
    alone."""
    places = {"layers": _layer_places(model.blocks)}
    if model.kind == "encdec":
        places["enc/layers"] = [(0, 0)] * model.n_enc_layers
    out = {}
    for path in flatten(tree):
        name, stacked = path, False
        for head, where in places.items():
            if path.startswith(head + "/"):
                j, rest = path[len(head) + 1:].split("/", 1)
                g, i = where[int(j)]
                name = f"{head[:-len('layers')]}groups/{g}/{i}/{rest}"
                stacked = True
        out.setdefault(name, (stacked, []))[1].append(path)
    return out


def _stack(flat, paths, stacked):
    ts = [flat[p] for p in paths]
    return torch.stack(ts) if stacked else ts[0]


# --------------------------------------------------------------- schedule
def schedule_lr(cfg: OptConfig, step):
    """Linear warmup + cosine decay, float32, from the int ``step``."""
    step = torch.as_tensor(step).float()
    # (step+1): the first step must not see lr=0 (off-by-one guard)
    warm = ((step + 1.0) / max(1, cfg.warmup_steps)).clamp(max=1.0)
    prog = ((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps)).clamp(0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, specs=None, mesh=None):
    """sqrt of the sum of every leaf's squares, in float32.  With
    ``specs`` the leaves are blocks: the squares of the leaves cut over
    the same axes are summed, then all-reduced over those axes, so that a
    leaf replicated over an axis counts once."""
    flat = flatten(tree)
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in flat.values()))
    fs = sharded.spec_paths(specs)
    parts = {}
    for path, x in flat.items():
        axes = tuple(a for d in sharded.cut_axes(fs[path], mesh) for a in d)
        s = torch.sum(torch.square(x.float()))
        parts[axes] = parts[axes] + s if axes in parts else s
    return torch.sqrt(sum(sharded.all_reduce_over(s, axes, mesh) for axes, s in parts.items()))


# --------------------------------------------------------------- init
def _factored_dims(shape):
    """Last two non-trivial dims get factored; else None (vector-like)."""
    if len(shape) < 2 or shape[-1] <= 1 or shape[-2] <= 1:
        return None
    return len(shape) - 2, len(shape) - 1


def _moments(params, mdt):
    return map_tree(lambda _, p: torch.zeros_like(p, dtype=mdt), params)


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=next(iter(flatten(params).values())).device)


def adamw_init(params, cfg: OptConfig):
    """m in ``cfg.moment_dtype``, v in float32: the reference's comment
    says ``moment_dtype`` halves the first moment, and though its init
    draws v in that dtype too, its update stores v in float32 (only m is
    cast), so from the first step on its v is float32."""
    return {"m": _moments(params, getattr(torch, cfg.moment_dtype)),
            "v": _moments(params, torch.float32), "step": _step0(params)}


def _stacked_spec(fs, paths, stacked):
    spec = fs[paths[0]]
    return (None, *spec) if stacked else spec


def adafactor_init(params, cfg: OptConfig, model, specs=None, mesh=None):
    """m like the parameters; float32 second moments per stacked leaf:
    ``vr`` and ``vc`` over its last two axes, or a whole ``v`` (blocks of
    them with ``specs``; what to factor is decided on the whole stacked
    shape)."""
    flat = flatten(params)
    fs = sharded.spec_paths(specs) if specs is not None else None
    v = {}
    for name, (stacked, paths) in leaf_groups(params, model).items():
        p = flat[paths[0]]
        shape = ((len(paths),) if stacked else ()) + tuple(p.shape)
        whole = shape if fs is None else sharded.whole_shape(
            shape, _stacked_spec(fs, paths, stacked), mesh)
        z = dict(dtype=torch.float32, device=p.device)
        if _factored_dims(whole) is None:
            v[name] = {"v": torch.zeros(shape, **z)}
        else:
            v[name] = {"vr": torch.zeros(shape[:-1], **z),
                       "vc": torch.zeros(shape[:-2] + shape[-1:], **z)}
    return {"m": _moments(params, getattr(torch, cfg.moment_dtype)), "v": v,
            "step": _step0(params)}


def init_opt_state(params, cfg: OptConfig, model, specs=None, mesh=None):
    """The zero state of ``cfg.kind``; ``model`` (a ``ModelConfig``)
    gives Adafactor the reference's stacking (:func:`leaf_groups`).  With
    ``specs``, of blocks of ``params`` (see the module's docstring)."""
    if cfg.kind == "adafactor":
        return adafactor_init(params, cfg, model, specs, mesh)
    return adamw_init(params, cfg)


# --------------------------------------------------------------- updates
def _adamw_update(g, p, m, v, lr, cfg: OptConfig, step):
    g = g.float()
    m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    t = step.float() + 1.0
    mh = m1 / (1 - cfg.b1 ** t)
    vh = v1 / (1 - cfg.b2 ** t)
    upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    return -lr * upd, m1, v1


def _adafactor_update(g, p, m, v, lr, cfg: OptConfig, step, spec=None, mesh=None):
    """One (stacked) leaf, or its block under ``spec``; writes ``v``'s
    statistics in place."""
    g = g.float()
    t = step.float() + 1.0
    beta2 = 1.0 - t ** -0.8  # Adafactor's schedule-free decay
    g2 = g * g + 1e-30
    cut = [()] * g.dim() if spec is None else sharded.cut_axes(spec, mesh)
    whole = g.shape if spec is None else sharded.whole_shape(g.shape, spec, mesh)
    if _factored_dims(whole) is None:
        v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
        pre = g / (torch.sqrt(v["v"]) + cfg.eps)
    else:
        mean = sharded.partial_mean
        vr = beta2 * v["vr"] + (1 - beta2) * mean(g2, -1, cut[-1], whole[-1], mesh)
        vc = beta2 * v["vc"] + (1 - beta2) * mean(g2, -2, cut[-2], whole[-2], mesh)
        v["vr"].copy_(vr)
        v["vc"].copy_(vc)
        rfac = vr / mean(vr, -1, cut[-2], whole[-2], mesh, keepdim=True).clamp_min(1e-30)
        pre = g * torch.rsqrt(rfac[..., None] + cfg.eps) * torch.rsqrt(vc[..., None, :] + cfg.eps)
    # update clipping (RMS <= 1) per Adafactor, once per stacked leaf
    every = tuple(a for axes in cut for a in axes)
    rms = torch.sqrt(sharded.partial_mean(pre * pre, None, every, math.prod(whole), mesh)
                     + 1e-30)
    pre = pre / torch.clamp(rms, min=1.0)
    m1 = cfg.b1 * m.float() + (1 - cfg.b1) * pre
    upd = m1 + cfg.weight_decay * p.float()
    return -lr * upd, m1


@torch.no_grad()
def _leaf_updates(grads, params, state, cfg: OptConfig, model, specs=None, mesh=None):
    """Yield (parameter paths, their float32 updates) leaf by leaf,
    writing the moments as it goes; then advance the step."""
    step = state["step"]
    lr = schedule_lr(cfg, step)
    scale = None
    if cfg.grad_clip:
        gn = global_norm(grads, specs, mesh)
        scale = torch.clamp(cfg.grad_clip / gn.clamp_min(1e-9), max=1.0)

    def clipped(g):
        return g if scale is None else g * scale.to(g.dtype)

    mdt = getattr(torch, cfg.moment_dtype)
    fg, fp, fm = flatten(grads), flatten(params), flatten(state["m"])
    if cfg.kind == "adafactor":
        fs = sharded.spec_paths(specs) if specs is not None else None
        for name, (stacked, paths) in leaf_groups(params, model).items():
            spec = None if fs is None else _stacked_spec(fs, paths, stacked)
            u, m1 = _adafactor_update(clipped(_stack(fg, paths, stacked)),
                                      _stack(fp, paths, stacked), _stack(fm, paths, stacked),
                                      state["v"][name], lr, cfg, step, spec, mesh)
            for r, path in enumerate(paths):
                fm[path].copy_((m1[r] if stacked else m1).to(mdt))
            yield paths, list(u) if stacked else [u]
    else:
        fv = flatten(state["v"])
        for path, g in fg.items():
            u, m1, v1 = _adamw_update(clipped(g), fp[path], fm[path], fv[path], lr, cfg, step)
            fm[path].copy_(m1.to(mdt))
            fv[path].copy_(v1)
            yield [path], [u]
    step += 1


def opt_update(grads, params, state, cfg: OptConfig, model, specs=None, mesh=None):
    """Returns (updates, state): float32 updates in a tree like the
    parameters, after the grad clip and the lr schedule; ``state``'s
    moments and step are written in place.  ``model`` gives Adafactor the
    reference's stacking (:func:`leaf_groups`); ``specs`` and ``mesh``
    say the trees are blocks (see the module's docstring)."""
    ups = {}
    for paths, us in _leaf_updates(grads, params, state, cfg, model, specs, mesh):
        ups.update(zip(paths, us))
    return map_tree(lambda path, _: ups[path], params), state


@torch.no_grad()
def apply_updates(params, updates):
    """``(p.float() + u).to(p.dtype)`` written into each parameter."""
    fu = flatten(updates)
    for path, p in flatten(params).items():
        p.copy_((p.float() + fu[path]).to(p.dtype))
    return params


@torch.no_grad()
def opt_step(grads, params, state, cfg: OptConfig, model, specs=None, mesh=None):
    """:func:`opt_update` then :func:`apply_updates`, leaf by leaf: each
    update is applied and dropped before the next is computed.  Returns
    ``state``."""
    fp = flatten(params)
    for paths, us in _leaf_updates(grads, params, state, cfg, model, specs, mesh):
        for path, u in zip(paths, us):
            p = fp[path]
            p.copy_((p.float() + u).to(p.dtype))
    return state
