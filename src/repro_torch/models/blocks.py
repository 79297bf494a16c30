"""Layer application: an attention or Mamba2 mixer, then (where the layer
has one) a dense gated FFN or a top-k MoE FFN (with a shared expert beside
it, where the layer has one), in train, prefill and decode modes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention, mamba2, moe
from repro_torch.models.layers import mlp, rmsnorm

MODES = ("train", "prefill", "decode")


def apply_layer(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Dict,
    x,
    *,
    positions,
    mode: str,  # "train" | "prefill" | "decode"
    cache: Optional[Dict],
    pos,
    compute_dtype,
    q_chunk: int = 2048,
    kv_dtype=None,
    attn_stages: int = 1,
    kv_repeat: int = 1,
    layer: int = -1,
) -> Tuple:
    """Returns (x, new_cache, aux): ``new_cache`` is None in train mode,
    ``aux`` the FFN's auxiliary loss: the MoE's load-balance loss, a zero
    f32 scalar for a dense FFN.  ``kv_repeat`` replicates attention's KV
    heads (and its cache's).  A MoE layer with a shared expert (``p["shared"]``,
    Granite's) adds the routed experts' output to the shared one's;
    ``residual_scale`` scales both residual branches; ``layer`` is the
    layer's index, for the MoE's span."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        if mode == "decode":
            y, new_cache = attention.attn_decode(
                cfg, spec, p["attn"], h, cache, pos, compute_dtype, kv_repeat=kv_repeat
            )
        else:
            y, new_cache = attention.attn_full(
                cfg, spec, p["attn"], h, positions, compute_dtype,
                return_cache=(mode == "prefill"), kv_dtype=kv_dtype, q_chunk=q_chunk,
                attn_stages=attn_stages, kv_repeat=kv_repeat,
            )
    elif mode == "decode":
        y, new_cache = mamba2.mamba_decode(cfg, p["mamba"], h, cache, compute_dtype)
    else:
        y, new_cache = mamba2.mamba_full(
            cfg, p["mamba"], h, compute_dtype, return_cache=(mode == "prefill")
        )
    x = _residual(cfg, x, y)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if spec.moe:
            # a shared expert's output is where the routed experts' land
            shared = mlp(cfg, p["shared"], h, compute_dtype) if "shared" in p else None
            y, aux = moe.moe_ffn(cfg, p["moe"], h, compute_dtype, shared=shared,
                                 layer=layer)
        else:
            y = mlp(cfg, p["mlp"], h, compute_dtype)
        x = _residual(cfg, x, y)
    return x, new_cache, aux


def _residual(cfg: ModelConfig, x, y):
    return x + y if cfg.residual_scale == 1.0 else x + y * cfg.residual_scale
