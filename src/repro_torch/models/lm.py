"""Parameter shapes and seeded initialization of the causal LM.

The tree has the JAX package's stacked layout, so weights carry across
unchanged: ``{"embed": {"tok"[, "unembed"]}, "pattern": (stacked layer
params per pattern position,), "remainder": (layer params,),
"final_norm"}``.  The forward pass for serving is layer by layer in
``repro_torch.serve.instance``; training comes in slice 3 of ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
from repro_torch.models.blocks import check_supported


@dataclasses.dataclass(frozen=True)
class Shape:
    """One parameter: its shape, its initializer (as
    ``repro.sharding.partition.ParamSpec`` names them), and a dtype that
    overrides the model's (norms stay f32)."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | fanin
    dtype: Optional[torch.dtype] = None


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> Dict:
    check_supported(spec)
    d, H, kvH, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    attn = {
        "wq": Shape((d, H * hd), "fanin"),
        "wk": Shape((d, kvH * hd), "fanin"),
        "wv": Shape((d, kvH * hd), "fanin"),
        "wo": Shape((H * hd, d), "fanin"),
    }
    if cfg.qkv_bias:
        attn["bq"] = Shape((H * hd,), "zeros")
        attn["bk"] = Shape((kvH * hd,), "zeros")
        attn["bv"] = Shape((kvH * hd,), "zeros")
    if cfg.qk_norm:
        attn["q_norm"] = Shape((hd,), "ones", torch.float32)
        attn["k_norm"] = Shape((hd,), "ones", torch.float32)
    out = {"ln1": Shape((d,), "ones", torch.float32), "attn": attn}
    if spec.ffn:
        out["ln2"] = Shape((d,), "ones", torch.float32)
        out["mlp"] = {
            "w_gate": Shape((d, f), "fanin"),
            "w_up": Shape((d, f), "fanin"),
            "w_down": Shape((f, d), "fanin"),
        }
    return out


def param_shapes(cfg: ModelConfig) -> Dict:
    def stack(s: Shape) -> Shape:
        return dataclasses.replace(s, shape=(cfg.pattern_reps,) + s.shape)

    embed = {"tok": Shape((cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        embed["unembed"] = Shape((cfg.d_model, cfg.vocab_size), "fanin")
    return {
        "embed": embed,
        "pattern": tuple(tree_map(stack, _layer_shapes(cfg, s)) for s in cfg.pattern),
        "remainder": tuple(_layer_shapes(cfg, s) for s in cfg.remainder),
        "final_norm": Shape((cfg.d_model,), "ones", torch.float32),
    }


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None):
    """Random weights from a numpy ``Generator``: N(0, 0.02) for ``normal``,
    N(0, 1/fan_in) for ``fanin`` (fan-in = the second-to-last dim), as
    ``repro.sharding.partition.ParamSpec.initialize`` scales them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def build(s: Shape) -> torch.Tensor:
        dt = s.dtype or dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        scale = 0.02
        if s.init == "fanin" and len(s.shape) >= 2:
            scale = s.shape[-2] ** -0.5
        a = rng.standard_normal(s.shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(device=dev, dtype=dt)

    return tree_map(build, param_shapes(cfg))
