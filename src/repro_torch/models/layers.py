"""Shared primitive layers: RMS norm, rotary embeddings, gated MLP, and the
token embedding (tied or separate unembedding), vocab-parallel under
sharding rules."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import collectives
from repro_torch.sharding.partition import as_axes, constrain, current_rules, logical_to_spec


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
    h = constrain(h, "batch", None, "model")
    return torch.matmul(h, p["w_down"].to(compute_dtype))


def _sharded_lookup(rules, w, tokens, compute_dtype):
    """Masked lookup + sum over the vocab-sharding axes (the reference's
    ``_shardmap_lookup``): each rank looks up the tokens in its own rows of
    the table, zeroes the others and the ranks' rows are summed, after an
    all-gather of an FSDP-sharded model dim.  Only (B, S, d) activation
    bytes cross ranks, never the table."""
    mesh = rules.mesh
    wspec = logical_to_spec(("vocab", "fsdp"), w.shape, rules)
    tspec = logical_to_spec(("batch", None), tokens.shape, rules)
    v_axes = as_axes(wspec[0])

    def local(wl, tl):
        for ax in as_axes(wspec[1]):
            wl = collectives.all_gather(wl, mesh, ax, 1)
        wl = wl.to(compute_dtype)
        Vl = wl.shape[0]
        rel = tl.long() - collectives.axis_index(mesh, v_axes) * Vl
        ok = (rel >= 0) & (rel < Vl)
        out = torch.where(ok[..., None], F.embedding(rel.clamp(0, Vl - 1), wl), 0.0)
        return (collectives.all_reduce(out, mesh, v_axes),)

    (out,) = collectives.shard_map(local, mesh, (wspec, tspec), (tspec + (None,),))(w, tokens)
    return out


def embed(cfg: ModelConfig, p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The token embedding.  Under rules whose ``vocab`` axis shards the
    table it is the vocab-parallel lookup (:func:`_sharded_lookup`);
    otherwise ``F.embedding``, not indexing: its backward on CUDA sums each
    row's gradients in a fixed order, while indexing's (index_put_ with
    accumulate) is deterministic only under use_deterministic_algorithms;
    a resumed training run must repeat the straight run's steps."""
    w = p["tok"]
    rules = current_rules()
    if rules is not None and logical_to_spec(("vocab", "fsdp"), w.shape, rules)[0] is not None:
        out = _sharded_lookup(rules, w, tokens, compute_dtype)
    else:
        out = F.embedding(tokens.long(), w.to(compute_dtype))
    if cfg.name.startswith("gemma"):
        out = out * torch.tensor(cfg.d_model**0.5, dtype=compute_dtype)
    if cfg.embed_scale != 1.0:
        out = out * cfg.embed_scale
    return constrain(out, "batch", None, None)


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.matmul(x, p["tok"].to(compute_dtype).t())  # (V, d)
    else:
        logits = torch.matmul(x, p["unembed"].to(compute_dtype))
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return constrain(logits, "batch", None, "vocab")
