"""qwen2-vl-7b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a stub per the assignment: ``input_specs()`` provides
precomputed patch embeddings that are overlaid on the sequence front.
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    frontend="vision",
    frontend_tokens=256,
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191; hf",
    **dense_pattern(28),
)
