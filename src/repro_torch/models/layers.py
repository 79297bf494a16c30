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
    positions: torch.Tensor,  # (B, S) int
    theta: float,
    mrope: bool = False,
) -> torch.Tensor:
    """Half-rotation RoPE."""
    if mrope:
        raise NotImplementedError(
            "M-RoPE comes with qwen2-vl in the architecture slice (ROADMAP slice 4)"
        )
    half = x.shape[-1] // 2
    inv = rope_freqs(half, theta, device=x.device)  # (half,)
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
    out = p["tok"].to(compute_dtype)[tokens.long()]
    if cfg.name.startswith("gemma"):
        out = out * torch.tensor(cfg.d_model**0.5, dtype=compute_dtype)
    return out


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, p["tok"].to(compute_dtype).t())  # (V, d)
    return torch.matmul(x, p["unembed"].to(compute_dtype))
