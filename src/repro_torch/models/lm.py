"""Parameter shapes and seeded initialization of the causal LM.

The tree has the JAX package's stacked layout, so weights carry across
unchanged: ``{"embed": {"tok"[, "unembed"]}, "pattern": (stacked layer
params per pattern position,), "remainder": (layer params,),
"final_norm"}``.  The forward pass for serving is layer by layer in
``repro_torch.serve.instance``; training comes in slice 3 of ROADMAP.md.
Attention and Mamba2 layers are both here (``repro.models.mamba2.mamba_specs``
for the latter); MoE FFNs come with slice 4.
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
    init: str = "normal"  # normal | zeros | ones | fanin | log_uniform
    dtype: Optional[torch.dtype] = None


def _attn_shapes(cfg: ModelConfig) -> Dict:
    d, H, kvH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
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
    return attn


def _mamba_shapes(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di, N, H, G, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups, cfg.conv_kernel
    f32 = torch.float32
    if cfg.mamba_split_proj:
        proj = {
            "w_z": Shape((d, di), "fanin"),
            "w_x": Shape((d, di), "fanin"),
            "w_B": Shape((d, G * N), "fanin"),
            "w_C": Shape((d, G * N), "fanin"),
            "w_dt": Shape((d, H), "fanin"),
            "conv_x_w": Shape((K, di)),
            "conv_x_b": Shape((di,), "zeros"),
            "conv_B_w": Shape((K, G * N)),
            "conv_B_b": Shape((G * N,), "zeros"),
            "conv_C_w": Shape((K, G * N)),
            "conv_C_b": Shape((G * N,), "zeros"),
        }
    else:
        conv_dim = di + 2 * G * N
        proj = {
            "in_proj": Shape((d, 2 * di + 2 * G * N + H), "fanin"),
            "conv_w": Shape((K, conv_dim)),
            "conv_b": Shape((conv_dim,), "zeros"),
        }
    # the reference pins these four to f32 whatever the model's dtype
    return {
        **proj,
        "A_log": Shape((H,), "log_uniform", f32),
        "D": Shape((H,), "ones", f32),
        "dt_bias": Shape((H,), "zeros", f32),
        "norm_w": Shape((di,), "ones", f32),
        "out_proj": Shape((di, d), "fanin"),
    }


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> Dict:
    check_supported(spec)
    d, f = cfg.d_model, cfg.d_ff
    out = {"ln1": Shape((d,), "ones", torch.float32)}
    if spec.kind == "attn":
        out["attn"] = _attn_shapes(cfg)
    else:
        out["mamba"] = _mamba_shapes(cfg)
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
    ``repro.sharding.partition.ParamSpec.initialize`` scales them, and
    log U[1, 16) for ``log_uniform`` (Mamba2's ``A_log``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def build(s: Shape) -> torch.Tensor:
        dt = s.dtype or dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "log_uniform":
            a = np.log(rng.uniform(1.0, 16.0, s.shape)).astype(np.float32)
            return torch.from_numpy(a).to(device=dev, dtype=dt)
        scale = 0.02
        if s.init == "fanin" and len(s.shape) >= 2:
            scale = s.shape[-2] ** -0.5
        a = rng.standard_normal(s.shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(device=dev, dtype=dt)

    return tree_map(build, param_shapes(cfg))
