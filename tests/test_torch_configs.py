"""The port's architecture registry (``repro_torch.configs``) and model
configuration (``repro_torch.models.model``) against the reference's: the
same ten architectures, field for field, with the same parameter
counts."""
from __future__ import annotations

import dataclasses

import pytest

from repro import configs as RC
from repro.models.model import ModelConfig as RefModelConfig
from repro_torch import configs as TC
from repro_torch.interop import model_config_from_dict
from repro_torch.models.model import LayerSpec, ModelConfig


def test_registry_ids_and_shapes():
    assert TC.ARCH_IDS == RC.ARCH_IDS and len(TC.ARCH_IDS) == 10
    assert TC.SHAPES == RC.SHAPES
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(RefModelConfig)]


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_arch_matches_reference(arch):
    ref, port = RC.get_arch(arch), TC.get_arch(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.model.param_count() == ref.model.param_count()
    assert all(type(v) is int for v in port.model.param_count())
    assert (port.model.n_layers, port.model.d_inner, port.model.dt_rank_eff) == \
        (ref.model.n_layers, ref.model.d_inner, ref.model.dt_rank_eff)
    for kind in ("attn", "mla", "mamba"):
        assert port.model.blocks_have(kind) == ref.model.blocks_have(kind)
    assert list(port.shapes()) == list(ref.shapes())
    small_p, small_r = TC.shrink(port.model), RC.shrink(ref.model)
    assert dataclasses.asdict(small_p) == dataclasses.asdict(small_r)
    assert small_p.param_count() == small_r.param_count()
    # The per-arch module names the same spec.
    mod = __import__(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}",
                     fromlist=["ARCH"])
    assert mod.ARCH is port and mod.MODEL is port.model


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_model_config_from_dict_round_trips(arch):
    ref = RC.get_arch(arch).model
    cfg = model_config_from_dict(dataclasses.asdict(ref))
    assert cfg == TC.get_arch(arch).model
    assert all(isinstance(s, LayerSpec) for p, _ in cfg.blocks for s in p)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


def test_model_config_from_dict_rejects_unknown_keys():
    d = dataclasses.asdict(RC.get_arch("stablelm-1.6b").model)
    with pytest.raises(ValueError, match="unknown ModelConfig fields"):
        model_config_from_dict({**d, "n_loops": 3})
    d["blocks"] = (({"kind": "attn", "depth": 2},), 1),
    with pytest.raises(ValueError, match="unknown LayerSpec fields"):
        model_config_from_dict(d)
