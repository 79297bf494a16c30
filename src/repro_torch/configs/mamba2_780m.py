"""mamba2-780m — SSD (state-space duality), attention-free [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,  # no FFN: mamba2 blocks only
    vocab_size=50280,
    pattern=(LayerSpec(kind="mamba", ffn=False),),
    pattern_reps=48,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    long_context_ok=True,  # O(1) recurrent state
    source="arXiv:2405.21060; unverified",
)
