"""GQA attention for serving: prefill over a prompt, then cached decode.

Prefill runs the flash attention kernel and decode the flash-decoding
kernel (``repro_torch.kernels``); on CPU tensors each wrapper runs its plain
PyTorch version.  The projections stay ``torch.matmul``.  Shapes and cache
layout follow ``repro.models.attention``: the cache is ``(B, kvH, Sc, hd)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, rmsnorm


def _project_qkv(cfg: ModelConfig, p: Dict, x, positions, compute_dtype):
    B, S, _ = x.shape
    H, kvH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.matmul(x, p["wq"].to(compute_dtype))
    k = torch.matmul(x, p["wk"].to(compute_dtype))
    v = torch.matmul(x, p["wv"].to(compute_dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, kvH, hd)
    v = v.reshape(B, S, kvH, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    return q, k, v


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(batch, head, position) int8 KV quantization."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.float()


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return q.to(dtype) * scale[..., None].to(dtype)


def attn_full(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    compute_dtype,
    return_cache: bool = False,
    kv_dtype=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Causal (optionally windowed) attention over a full prompt."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _project_qkv(cfg, p, x, positions, compute_dtype)
    kc = k.transpose(1, 2).contiguous()  # (B, kvH, S, hd)
    vc = v.transpose(1, 2).contiguous()
    out = flash_attention(
        q.transpose(1, 2).contiguous(), kc, vc, causal=True, window=spec.window,
    )  # (B, H, S, hd)
    y = out.transpose(1, 2).reshape(B, S, H * hd)
    y = torch.matmul(y, p["wo"].to(compute_dtype))

    cache = None
    if return_cache:
        if spec.window is not None and spec.window < S:
            W = spec.window
            # keep slot invariant "abs position p lives at slot p % W"
            j = torch.arange(W, device=x.device)
            a = j + W * ((S - 1 - j) // W)  # latest position congruent to j
            kc = kc.index_select(2, a)
            vc = vc.index_select(2, a)
        if kv_dtype is not None and kv_dtype == torch.int8:
            kq, ks = quantize_kv(kc)
            vq, vs = quantize_kv(vc)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            if kv_dtype is not None:
                kc, vc = kc.to(kv_dtype), vc.to(kv_dtype)
            cache = {"k": kc, "v": vc}
    return y, cache


def attn_decode(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict,
    pos: int,  # number of tokens already consumed
    compute_dtype,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  The new K/V are written into ``cache`` IN PLACE
    (the reference returns an updated copy; a serving cache belongs to one
    generation, so the port saves the copy) and ``cache`` is returned."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, compute_dtype)

    Sc = cache["k"].shape[2]
    slot = pos % Sc if spec.window is not None else pos
    # The reference writes with jax.lax.dynamic_update_slice, which CLAMPS
    # the start index: a prefill cache has exactly S slots and never grows,
    # so every decode step past it overwrites slot Sc-1 (and the mask below
    # marks every slot valid).  Torch indexing does not clamp; mirror it.
    slot = min(slot, Sc - 1)
    k_new = k.transpose(1, 2)  # (B, kvH, 1, hd)
    v_new = v.transpose(1, 2)
    if cache["k"].dtype == torch.int8:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        cache["k"][:, :, slot : slot + 1] = kq
        cache["v"][:, :, slot : slot + 1] = vq
        cache["k_scale"][:, :, slot : slot + 1] = ks
        cache["v_scale"][:, :, slot : slot + 1] = vs
        out = decode_attention(
            q.reshape(B, H, hd), cache["k"], cache["v"], pos,
            cache["k_scale"], cache["v_scale"],
        )
    else:
        cache["k"][:, :, slot : slot + 1] = k_new.to(cache["k"].dtype)
        cache["v"][:, :, slot : slot + 1] = v_new.to(cache["v"].dtype)
        out = decode_attention(q.reshape(B, H, hd), cache["k"], cache["v"], pos)
    y = out.to(compute_dtype).reshape(B, 1, H * hd)
    y = torch.matmul(y, p["wo"].to(compute_dtype))
    return y, cache
