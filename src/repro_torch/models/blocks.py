"""Layer application: attention mixer with a dense gated FFN.

Mamba mixers and MoE FFNs arrive with the other architectures (slice 4 of
ROADMAP.md); until then they raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import mlp, rmsnorm

_LATER = "comes with the other architectures in slice 4 of ROADMAP.md"


def check_supported(spec: LayerSpec) -> None:
    if spec.kind != "attn":
        raise NotImplementedError(f"{spec.kind!r} layers: {_LATER}")
    if spec.moe:
        raise NotImplementedError(f"MoE FFN layers: {_LATER}")


def apply_layer(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Dict,
    x,
    *,
    positions,
    mode: str,  # "prefill" | "decode"
    cache: Optional[Dict],
    pos,
    compute_dtype,
    kv_dtype=None,
) -> Tuple:
    """Returns (x, new_cache)."""
    check_supported(spec)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        y, new_cache = attention.attn_decode(
            cfg, spec, p["attn"], h, cache, pos, compute_dtype
        )
    elif mode == "prefill":
        y, new_cache = attention.attn_full(
            cfg, spec, p["attn"], h, positions, compute_dtype,
            return_cache=True, kv_dtype=kv_dtype,
        )
    else:
        raise ValueError(f"unknown mode {mode!r} (training comes in slice 3)")
    x = x + y
    if spec.ffn:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(cfg, p["mlp"], h, compute_dtype)
    return x, new_cache
