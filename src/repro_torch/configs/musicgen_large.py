"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec frontend is a stub per the assignment: ``input_specs()`` provides
precomputed frame embeddings in place of token embeddings.
"""
from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    source="arXiv:2306.05284; hf",
    **dense_pattern(48),
)
