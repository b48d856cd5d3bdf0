"""State carried across between the JAX package and the port.

The "weights" of this system are its configurations, chain states and
the LLM scaffold's parameters and training state.  These helpers take
them from the plain Python/numpy forms both packages share, so the same
inputs reach both without this package importing JAX or ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import map_tree
from repro_torch.core.annealing import SAConfig
from repro_torch.models.model import ENC_SPEC, LayerSpec, ModelConfig
from repro_torch.objectives import SUITE
from repro_torch.objectives import functions as F
from repro_torch.objectives.base import Objective
from repro_torch.service.engine import EngineConfig
from repro_torch.service.request import SARequest
from repro_torch.service.scheduler import SchedulerConfig

_BY_NAME = {
    "schwefel": F.schwefel, "rastrigin": F.rastrigin, "ackley": F.ackley,
    "griewank": F.griewank, "exponential": F.exponential, "salomon": F.salomon,
}


def _from_dict(cls, d: dict, drop=()):
    names = {f.name for f in dataclasses.fields(cls)}
    d = {k: v for k, v in d.items() if k not in drop}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown {cls.__name__} fields {sorted(extra)}")
    return cls(**d)


def sa_config_from_dict(d: dict) -> SAConfig:
    """An ``SAConfig`` from ``dataclasses.asdict`` of a reference config;
    unknown keys raise."""
    return _from_dict(SAConfig, d)


def model_config_from_dict(d: dict) -> ModelConfig:
    """A ``ModelConfig`` from ``dataclasses.asdict`` of a reference config,
    whose ``blocks`` hold each ``LayerSpec`` as a dict; unknown keys
    raise."""
    blocks = tuple((tuple(_from_dict(LayerSpec, s) for s in pattern), reps)
                   for pattern, reps in d["blocks"])
    return _from_dict(ModelConfig, {**d, "blocks": blocks})


def sa_request_from_dict(d: dict) -> SARequest:
    """An ``SARequest`` from ``dataclasses.asdict`` of a reference request;
    unknown keys raise, and the request is validated as the reference's
    is."""
    return _from_dict(SARequest, d)


def engine_config_from_dict(d: dict, device=None) -> EngineConfig:
    """An ``EngineConfig`` from ``dataclasses.asdict`` of a reference
    config.  The reference-only fields ``use_pallas`` and ``interpret``
    are dropped, ``device`` takes their place (default: the card), and
    unknown keys raise."""
    d = dict(d)
    if isinstance(d.get("scheduler"), dict):
        d["scheduler"] = _from_dict(SchedulerConfig, d["scheduler"])
    return _from_dict(EngineConfig, {**d, "device": device},
                      drop=("use_pallas", "interpret"))


def objective_from_ref(name: str, dim: int = None) -> Objective:
    """The port's objective for a reference name: a paper suite key
    (``"F2"``, ``"F0_b"``, ...; ``dim`` omitted) or a registry objective
    at ``dim`` (``"schwefel", 16``).  Same box, f_opt, x_opt, decomposable
    structure and kernel_id as the reference's."""
    if name in SUITE:
        obj = SUITE[name]()
        if dim is not None and dim != obj.dim:
            raise ValueError(f"suite problem {name} has dim {obj.dim}, "
                             f"not {dim}")
        return obj
    if name in _BY_NAME and dim is not None:
        return _BY_NAME[name](dim)
    raise ValueError(f"{name!r} is not a registry objective with a dim nor "
                     f"a suite key; expected one of {sorted(_BY_NAME)} with "
                     "a dim, or a key of SUITE")


def chains_from_numpy(x, fx, device=None, dtype=torch.float32):
    """(chains, dim) states and (chains,) values -> tensors of ``dtype``
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(x), dtype=dtype, device=dev),
            torch.as_tensor(np.asarray(fx), dtype=dtype, device=dev))


def chains_to_numpy(x, fx):
    """The inverse of :func:`chains_from_numpy`."""
    return x.detach().cpu().numpy(), fx.detach().cpu().numpy()


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _tree(t, fn):
    return {k: _tree(v, fn) for k, v in t.items()} if isinstance(t, dict) else fn(t)


def _split_groups(groups, blocks, what, device) -> list:
    """The reference's scanned groups (each leaf with a leading
    ``repeats`` axis) as one dict per layer, in the order the blocks
    apply them.  Every layer holds ``norm1``, whose leading axis gives
    the group's repeats."""
    shapes = [(len(pattern), reps) for pattern, reps in blocks]
    found = [(len(g), len(np.asarray(g[0]["norm1"]))) for g in groups]
    if found != shapes:
        raise ValueError(f"the pytree's groups hold (layers, repeats) {found}; "
                         f"{what}'s blocks are {shapes}")
    return [_tree(group[i], lambda a: _tensor(np.asarray(a)[r], device))
            for (n, reps), group in zip(shapes, groups)
            for r in range(reps) for i in range(n)]


def model_params_from_jax(params, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters (``models.model.init_params``' layout) from
    the reference's ``init_params`` pytree, its leaves as numpy arrays
    (bfloat16 ones as ``ml_dtypes``' type), on ``device`` (default: the
    card) in the leaves' dtype.  Each ``params["groups"][g][i]`` leaf
    carries a leading ``repeats`` axis from the reference's vmapped init;
    it is split into one dict per layer, in the order the blocks apply
    them, and so is the encoder's one group of ``n_enc_layers`` repeats
    (``params["enc"]["groups"]``).  Every leaf of a layer comes across
    (Mamba's, cross-attention's ``normc`` and ``cross``; a layer with no
    MLP has no ``norm2``), nested dicts (an MoE layer's
    ``mlp["shared"]``) stay nested, and each leaf keeps its dtype: the
    MoE router stays float32 under bf16 weights.  Top-level keys other
    than the reference's raise."""
    dev = resolve_device(device)
    known = {"embed", "final_norm", "lm_head", "pos_embed", "groups", "enc"}
    if set(params) - known:
        raise ValueError(f"unknown top-level parameters {sorted(set(params) - known)}")
    out = {k: _tensor(params[k], dev) for k in ("embed", "final_norm", "lm_head", "pos_embed")
           if k in params}
    out["layers"] = _split_groups(params["groups"], cfg.blocks, cfg.name, dev)
    if "enc" in params:
        enc = params["enc"]
        out["enc"] = {"layers": _split_groups(enc["groups"], (((ENC_SPEC,), cfg.n_enc_layers),),
                                              f"{cfg.name}'s encoder", dev),
                      "final_norm": _tensor(enc["final_norm"], dev),
                      "pos_embed": _tensor(enc["pos_embed"], dev)}
    return out


def _vstates(tree, path="") -> dict:
    """Adafactor's second moments of the reference's state: {tree path:
    {"vr", "vc"} or {"v"}} at every stacked leaf."""
    if isinstance(tree, dict) and tree and set(tree) <= {"vr", "vc", "v"} \
            and not isinstance(next(iter(tree.values())), (dict, list, tuple)):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_vstates(v, f"{path}/{k}" if path else str(k)))
    return out


def opt_state_from_jax(opt, cfg: ModelConfig, device=None) -> dict:
    """The port's optimizer state (``optim.init_opt_state``'s layout) from
    the reference's, on ``device`` (default: the card): the moments ``m``
    (and AdamW's ``v``) split into one dict per layer as the parameters
    are, AdamW's ``v`` in float32 (the reference's after its first
    update, ``optim.adamw_init``), Adafactor's second moments kept per
    stacked leaf under the reference's tree path (``groups/0/1/attn/wq``:
    ``vr``, ``vc`` or ``v``), and ``step`` as an int32 scalar."""
    dev = resolve_device(device)
    adafactor = isinstance(opt["v"]["final_norm"], dict)
    v = ({name: {k: _tensor(a, dev) for k, a in st.items()}
          for name, st in _vstates(opt["v"]).items()} if adafactor
         else map_tree(lambda _, t: t.float(), model_params_from_jax(opt["v"], cfg, dev)))
    return {"m": model_params_from_jax(opt["m"], cfg, dev), "v": v,
            "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=dev)}


def train_state_from_jax(state, cfg: ModelConfig, device=None, mesh=None) -> dict:
    """``launch.train.build_state``'s ``{"params", "opt"}`` from the
    reference's training state: the parameters as leaves that require
    grad, and :func:`opt_state_from_jax`.  Under ``mesh`` (a
    ``DeviceMesh``) this rank's blocks of them, as ``build_state(...,
    mesh=)`` holds them: each whole leaf cut by the state's specs
    (``launch.steps.state_specs``)."""
    params = model_params_from_jax(state["params"], cfg, device)
    out = {"params": params, "opt": opt_state_from_jax(state["opt"], cfg, device)}
    if mesh is not None:
        from repro_torch.distributed import sharded
        from repro_torch.launch.steps import param_specs, state_specs
        out = sharded.shard_state(out, state_specs(out, param_specs(params, cfg, mesh), cfg),
                                  mesh)
    map_tree(lambda _, t: t.requires_grad_(True), out["params"])
    return out
