"""olmoe-1b-7b — MoE 64e top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig, moe_pattern

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert FFN width
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    source="arXiv:2409.02060; hf",
    **moe_pattern(16),
)
