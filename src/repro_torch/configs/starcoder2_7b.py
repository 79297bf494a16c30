"""starcoder2-7b — GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    source="arXiv:2402.19173; hf",
    **dense_pattern(32),
)
