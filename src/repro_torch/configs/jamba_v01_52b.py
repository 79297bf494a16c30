"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887; hf].

Jamba block: 8 layers, attention at in-block index 4 (1:7 attn:mamba),
MoE FFN on every other layer (odd indices) -> 16 MoE layers over 32.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_BLOCK = tuple(
    LayerSpec(kind="attn" if i == 4 else "mamba", moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,  # per-expert FFN width
    vocab_size=65536,
    pattern=_BLOCK,
    pattern_reps=4,
    n_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    long_context_ok=True,  # hybrid: only 4/32 layers carry a full KV cache
    source="arXiv:2403.19887; hf",
)
