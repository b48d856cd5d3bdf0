"""The training driver's presets, the counterpart of ``PRESETS`` and
``preset_config`` in ``repro.launch.train`` (the serving driver reads
them).  The driver itself, with the data pipeline, the optimizer and
checkpoints, waits for the training slice of the port (ROADMAP.md
section A, item 3).
"""
from __future__ import annotations

from repro_torch.models.model import LayerSpec, ModelConfig

PRESETS = {
    # name -> (ModelConfig kwargs, seq, batch)  (vocab kept modest for CPU)
    "smoke": (dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                   d_ff=512, vocab_size=512, n_layers=2), 128, 4),
    "20m": (dict(d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
                 d_ff=1536, vocab_size=8192, n_layers=6), 256, 4),
    "100m": (dict(d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                  d_ff=3072, vocab_size=32768, n_layers=12), 512, 8),
}


def preset_config(name: str) -> tuple[ModelConfig, int, int]:
    """(config, seq, batch) of a preset: ``n_layers`` dense global
    attention layers, ``max_seq = seq``."""
    kw, seq, batch = PRESETS[name]
    kw = dict(kw)  # PRESETS must survive repeated calls
    n_layers = kw.pop("n_layers")
    spec = LayerSpec(kind="attn", window=None, mlp="dense")
    cfg = ModelConfig(name=f"preset-{name}", blocks=(((spec,), n_layers),),
                      max_seq=seq, **kw)
    return cfg, seq, batch
