"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
    **dense_pattern(64),
)
