"""GQA attention: full (train), prefill over a prompt, and cached decode.

Training runs the model's own math, as the reference does: masked softmax
over einsums (:func:`_sdpa_block`), differentiable, chunked over queries
when the sequence is longer than ``q_chunk``.  Prefill runs the flash
attention kernel and decode the flash-decoding kernel
(``repro_torch.kernels``); on CPU tensors each wrapper runs its plain
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
from repro_torch.sharding.partition import constrain

NEG_INF = -1e30


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
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


def _repeat_kv(k, v, kv_repeat: int):
    """Replicate KV heads so the head dim divides the TP axis (memory for
    shardability: the standard GQA trick when kv_heads < model-axis size).
    Each head repeats in place, as ``jnp.repeat`` does."""
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=2)
        v = v.repeat_interleave(kv_repeat, dim=2)
    return k, v


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(batch, head, position) int8 KV quantization."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.float()


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return q.to(dtype) * scale[..., None].to(dtype)


def _sdpa_block(q, k, v, qpos, kpos, window, scale):
    """q: (B,Sq,kvH,G,hd)  k/v: (B,Sk,kvH,hd)  -> (B,Sq,kvH,G,hd).

    Scores in f32 (the reference's ``preferred_element_type``), masks from
    absolute positions, so one primitive serves full-causal, windowed and
    chunked calls."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def _scale(cfg: ModelConfig) -> float:
    return cfg.hd**-0.5 if cfg.attn_scale is None else cfg.attn_scale


def _attn_train(spec, q, k, v, q_chunk, attn_stages, scale):
    """The reference's train-mode attention: one block when ``S <=
    q_chunk``, else query chunks, staged so that stage g reads keys below
    its last query only (and, for a window, none older than its first query
    minus the window, rounded down to a chunk)."""
    B, S, kvH, hd = k.shape
    G = q.shape[2] // kvH
    qg = q.reshape(B, S, kvH, G, hd)
    kpos = torch.arange(S, device=q.device)
    if S <= q_chunk:
        return _sdpa_block(qg, k, v, kpos, kpos, spec.window, scale)
    if S % q_chunk:
        raise ValueError(f"seq {S} not divisible by q_chunk {q_chunk}")
    nq = S // q_chunk
    outs = []
    for g in range(attn_stages):
        lo_c, hi_c = g * nq // attn_stages, (g + 1) * nq // attn_stages
        k_hi = hi_c * q_chunk
        if spec.window is not None:
            k_lo = max(0, ((lo_c * q_chunk - spec.window) // q_chunk) * q_chunk)
        else:
            k_lo = 0
        for c in range(lo_c, hi_c):
            qpos = c * q_chunk + torch.arange(q_chunk, device=q.device)
            outs.append(_sdpa_block(
                qg[:, c * q_chunk:(c + 1) * q_chunk], k[:, k_lo:k_hi], v[:, k_lo:k_hi],
                qpos, kpos[k_lo:k_hi], spec.window, scale,
            ))
    return torch.cat(outs, dim=1)


def attn_full(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    compute_dtype,
    return_cache: bool = False,
    kv_dtype=None,
    q_chunk: int = 2048,
    attn_stages: int = 1,
    kv_repeat: int = 1,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Causal (optionally windowed) attention over a full sequence.  With
    ``return_cache`` (prefill) it runs the flash attention kernel; without
    (training, as the reference's ``return_cache=(mode == "prefill")``) it
    runs :func:`_attn_train` under autograd.  ``kv_repeat`` replicates the
    KV heads (and the cache's) before attention."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    kvH = cfg.n_kv_heads * kv_repeat
    if H % kvH:
        raise ValueError(f"kv_repeat {kv_repeat} breaks GQA grouping ({H} heads, {kvH} kv heads)")
    q, k, v = _project_qkv(cfg, p, x, positions, compute_dtype)
    k, v = _repeat_kv(k, v, kv_repeat)
    if not return_cache:
        out = _attn_train(spec, q, k, v, q_chunk, attn_stages, _scale(cfg))
        y = torch.matmul(out.reshape(B, S, H * hd), p["wo"].to(compute_dtype))
        return constrain(y, "batch", None, None), None
    # the kernel reads the (B, S, H, hd) projections through (B, H, S, hd)
    # views and writes its output the same way, so no copy is made here
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
        window=spec.window, scale=_scale(cfg), out=out.transpose(1, 2),
    )
    y = constrain(torch.matmul(out.reshape(B, S, H * hd), p["wo"].to(compute_dtype)),
                  "batch", None, None)

    cache = None
    if return_cache:
        # (B, kvH, S, hd), contiguous: decode writes into it; one copy each
        kc, vc = k.transpose(1, 2), v.transpose(1, 2)
        if spec.window is not None and spec.window < S:
            W = spec.window
            # keep slot invariant "abs position p lives at slot p % W"
            j = torch.arange(W, device=x.device)
            a = j + W * ((S - 1 - j) // W)  # latest position congruent to j
            kc = kc.index_select(2, a)
            vc = vc.index_select(2, a)
        else:
            kc, vc = kc.contiguous(), vc.contiguous()
        if kv_dtype is not None and kv_dtype == torch.int8:
            kq, ks = quantize_kv(kc)
            vq, vs = quantize_kv(vc)
            cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            if kv_dtype is not None:
                kc, vc = kc.to(kv_dtype), vc.to(kv_dtype)
            cache = {"k": kc, "v": vc}
        cache = {
            key: constrain(val, "batch", "kv_heads", "kv_seq", None)
            if val.dim() == 4
            else constrain(val, "batch", "kv_heads", "kv_seq")
            for key, val in cache.items()
        }
    return y, cache


def attn_decode(
    cfg: ModelConfig,
    spec: LayerSpec,
    p: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict,
    pos: int,  # number of tokens already consumed
    compute_dtype,
    kv_repeat: int = 1,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  The new K/V are written into ``cache`` IN PLACE
    (the reference returns an updated copy; a serving cache belongs to one
    generation, so the port saves the copy) and ``cache`` is returned.  An
    int8 cache (with ``k_scale``/``v_scale``) takes the new K/V quantized and
    is read by K3's int8 instance."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, compute_dtype)
    k, v = _repeat_kv(k, v, kv_repeat)

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
            cache["k_scale"], cache["v_scale"], scale=_scale(cfg),
        )
    else:
        cache["k"][:, :, slot : slot + 1] = k_new.to(cache["k"].dtype)
        cache["v"][:, :, slot : slot + 1] = v_new.to(cache["v"].dtype)
        cache["k"] = constrain(cache["k"], "batch", "kv_heads", "kv_seq", None)
        cache["v"] = constrain(cache["v"], "batch", "kv_heads", "kv_seq", None)
        out = decode_attention(q.reshape(B, H, hd), cache["k"], cache["v"], pos,
                               scale=_scale(cfg))
    y = out.to(compute_dtype).reshape(B, 1, H * hd)
    y = torch.matmul(y, p["wo"].to(compute_dtype))
    return constrain(y, "batch", None, None), cache
