"""gemma3-27b — 5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt; unverified].

62 layers = 10 x (5 local + 1 global) + 2 local remainder; local window 1024.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024)
_GLOBAL = LayerSpec(kind="attn", window=None)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    pattern_reps=10,
    remainder=(_LOCAL, _LOCAL),
    qk_norm=True,
    tie_embeddings=True,
    long_context_ok=True,  # 52/62 layers have a 1k-window KV cache
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt; unverified",
)
