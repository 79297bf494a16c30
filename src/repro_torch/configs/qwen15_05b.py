"""qwen1.5-0.5b — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    **dense_pattern(24),
)
