"""The 10 assigned architectures (exact configs from the assignment table),
the port's own copy of ``repro.configs.archs``.

Sources noted per-arch; where the upstream model differs in minutiae from the
assignment line, the assignment line wins (it defines the graded cells).
Substrate simplifications (GELU->SwiGLU for whisper/granite, LayerNorm->
RMSNorm) are uniform across archs and noted in DESIGN.md.
"""
from __future__ import annotations

from repro_torch.configs.common import ArchSpec, dense_blocks
from repro_torch.models.model import LayerSpec, ModelConfig

_A = {}


def _reg(spec: ArchSpec):
    _A[spec.arch_id] = spec
    return spec


# ------------------------------------------------------------ gemma3-4b
# 34L, 5:1 local:global interleave, window 1024, GQA 8H/kv4, 128k ctx.
_L = LayerSpec(kind="attn", window=1024, mlp="dense")
_G = LayerSpec(kind="attn", window=None, mlp="dense")
_reg(ArchSpec(
    arch_id="gemma3-4b",
    model=ModelConfig(
        name="gemma3-4b", d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab_size=262144,
        blocks=(((_L, _L, _L, _L, _L, _G), 5), ((_L, _L, _L, _L), 1)),
        rope_theta=10000.0, max_seq=131072,
    ),
    long_ok=True,  # only 6 global layers hold the full 512k cache
    source="hf:google/gemma-3-4b (assignment table)",
))

# ---------------------------------------------------------- stablelm-1.6b
_reg(ArchSpec(
    arch_id="stablelm-1.6b",
    model=ModelConfig(
        name="stablelm-1.6b", d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=5632, vocab_size=100352,
        blocks=dense_blocks(24),
    ),
    long_ok=False,  # pure full attention -> long_500k skipped (DESIGN §5)
    source="hf:stabilityai/stablelm-2-1_6b",
))

# ------------------------------------------------------------ granite-20b
_reg(ArchSpec(
    arch_id="granite-20b",
    model=ModelConfig(
        name="granite-20b", d_model=6144, n_heads=48, n_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
        blocks=dense_blocks(52),
    ),
    long_ok=False,
    source="arXiv:2405.04324 (MQA kv=1)",
))

# ----------------------------------------------------------- internlm2-20b
_reg(ArchSpec(
    arch_id="internlm2-20b",
    model=ModelConfig(
        name="internlm2-20b", d_model=6144, n_heads=48, n_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92544,
        blocks=dense_blocks(48),
    ),
    long_ok=False,
    source="arXiv:2403.17297",
))

# --------------------------------------------------------- falcon-mamba-7b
_M = LayerSpec(kind="mamba", mlp="dense")
_reg(ArchSpec(
    arch_id="falcon-mamba-7b",
    model=ModelConfig(
        name="falcon-mamba-7b", d_model=4096, n_heads=1, n_kv_heads=1,
        head_dim=64, d_ff=0, vocab_size=65024,
        # mamba1 block has no separate MLP: d_ff=0 -> use pure mamba layers
        blocks=(((LayerSpec(kind="mamba", mlp="none"),), 64),),
        d_state=16, d_conv=4, expand=2, dt_rank=256,
    ),
    long_ok=True,  # O(1) recurrent state
    source="arXiv:2410.05355 (mamba1)",
))

# ------------------------------------------------------------ jamba-v0.1
# 1:7 attn:mamba interleave; MoE every other layer (16 experts, top-2).
_Jm_d = LayerSpec(kind="mamba", mlp="dense")
_Jm_e = LayerSpec(kind="mamba", mlp="moe")
_Ja_d = LayerSpec(kind="attn", window=None, mlp="dense")
_reg(ArchSpec(
    arch_id="jamba-v0.1-52b",
    model=ModelConfig(
        name="jamba-v0.1-52b", d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=65536,
        blocks=(((_Jm_d, _Jm_e, _Jm_d, _Jm_e, _Ja_d, _Jm_e, _Jm_d, _Jm_e), 4),),
        n_experts=16, top_k=2, d_ff_expert=14336,
        d_state=16, d_conv=4, expand=2, dt_rank=256,
    ),
    long_ok=True,  # only 4 attention layers hold caches (1:7 hybrid)
    source="arXiv:2403.19887",
))

# ----------------------------------------------------------- internvl2-2b
_reg(ArchSpec(
    arch_id="internvl2-2b",
    model=ModelConfig(
        name="internvl2-2b", d_model=2048, n_heads=16, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=92553,
        blocks=dense_blocks(24),
        frontend="vision_stub", frontend_len=1024,
    ),
    long_ok=False,
    source="arXiv:2404.16821 (InternViT stub + InternLM2-2B backbone)",
))

# ------------------------------------------------------------ whisper-base
_W = LayerSpec(kind="attn", window=None, mlp="dense", cross_attn=True)
_reg(ArchSpec(
    arch_id="whisper-base",
    model=ModelConfig(
        name="whisper-base", d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865,
        blocks=(((_W,), 6),),
        kind="encdec", n_enc_layers=6,
        use_rope=False, max_seq=65536,  # extended decoder position table
        frontend="audio_stub", frontend_len=1500,
    ),
    long_ok=False,  # 448-token natural decoder ctx; 500k senseless
    source="arXiv:2212.04356 (conv frontend stubbed)",
))

# -------------------------------------------------------- deepseek-v2-lite
_Dd = LayerSpec(kind="mla", mlp="dense")
_De = LayerSpec(kind="mla", mlp="moe")
_reg(ArchSpec(
    arch_id="deepseek-v2-lite-16b",
    model=ModelConfig(
        name="deepseek-v2-lite-16b", d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102400,
        blocks=(((_Dd,), 1), ((_De,), 26)),
        n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
        kv_lora=512, d_nope=128, d_rope=64,
    ),
    long_ok=False,  # MLA compresses memory but attention is still full
    source="arXiv:2405.04434 (MLA kv_lora=512; 2 shared + 64 routed top-6)",
))

# ------------------------------------------------------------- kimi-k2-1t
_Kd = LayerSpec(kind="attn", window=None, mlp="dense")
_Ke = LayerSpec(kind="attn", window=None, mlp="moe")
_reg(ArchSpec(
    arch_id="kimi-k2-1t-a32b",
    model=ModelConfig(
        name="kimi-k2-1t-a32b", d_model=7168, n_heads=64, n_kv_heads=8,
        head_dim=112, d_ff=18432, vocab_size=163840,
        blocks=(((_Kd,), 1), ((_Ke,), 60)),
        n_experts=384, top_k=8, n_shared=1, d_ff_expert=2048,
    ),
    long_ok=False,
    source="arXiv:2501.kimi2 (paper-table; GQA kv=8 per assignment)",
))

ARCHS = dict(_A)
ARCH_IDS = tuple(ARCHS.keys())


def get_arch(arch_id: str) -> ArchSpec:
    return ARCHS[arch_id]
