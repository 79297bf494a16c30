"""phi3.5-moe-42b-a6.6b — MoE 16e top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs.base import ModelConfig, moe_pattern

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,  # per-expert FFN width
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    **moe_pattern(32),
)
