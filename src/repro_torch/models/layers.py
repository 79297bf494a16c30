"""Shared primitive layers: RMS norm, rotary embeddings, gated MLP, and the
token embedding (tied or separate unembedding)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_freqs(hd_half: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(hd_half, dtype=torch.float32, device=device) / hd_half
    return 1.0 / (theta**exps)


def apply_rope(
    x: torch.Tensor,  # (B, S, H, hd)
    positions: torch.Tensor,  # (B, S) int or (3, B, S) for M-RoPE
    theta: float,
    mrope: bool = False,
) -> torch.Tensor:
    """Half-rotation RoPE; M-RoPE splits the rotary half-dim into (t,h,w)
    sections of proportion (1/2, 1/4, 1/4) rotated by per-axis positions."""
    half = x.shape[-1] // 2
    inv = rope_freqs(half, theta, device=x.device)  # (half,)
    if mrope:
        if positions.dim() == 2:  # text-only: reuse positions for all sections
            positions = positions.expand(3, *positions.shape)
        s_t = half // 2
        s_h = (half - s_t) // 2
        s_w = half - s_t - s_h
        # which position stream drives each frequency
        sect = torch.tensor([0] * s_t + [1] * s_h + [2] * s_w, device=positions.device)
        pos_sel = positions.index_select(0, sect)  # (half, B, S)
        ang = (pos_sel.to(torch.float32) * inv[:, None, None]).movedim(0, -1)  # (B, S, half)
    else:
        ang = positions.to(torch.float32)[..., None] * inv  # (B, S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)  # (B, S, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    h = torch.matmul(x, p["w_gate"].to(compute_dtype))
    u = torch.matmul(x, p["w_up"].to(compute_dtype))
    h = F.silu(h.float()).to(compute_dtype) * u
    return torch.matmul(h, p["w_down"].to(compute_dtype))


def embed(cfg: ModelConfig, p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # F.embedding, not indexing: its backward on CUDA sums each row's
    # gradients in a fixed order, while indexing's (index_put_ with
    # accumulate) is deterministic only under use_deterministic_algorithms;
    # a resumed training run must repeat the straight run's steps
    out = F.embedding(tokens.long(), p["tok"].to(compute_dtype))
    if cfg.name.startswith("gemma"):
        out = out * torch.tensor(cfg.d_model**0.5, dtype=compute_dtype)
    return out


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, p["tok"].to(compute_dtype).t())  # (V, d)
    return torch.matmul(x, p["unembed"].to(compute_dtype))
