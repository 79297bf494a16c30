"""Top-k MoE with capacity-based dispatch, on one device.

The reference's local path (``repro.models.moe._moe_local``): route in f32,
give each (token, choice) pair a slot in its expert in token-major order up
to the capacity, scatter into an (E, C, d) buffer, run every expert's gated
MLP on its buffer, gather and combine by the gates.  Pairs past an
expert's capacity are dropped, exactly where the reference drops them.
Each cast and each order follows the reference, so the routing, the drops
and (in f32) the tokens match it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, min(c, n_tokens * cfg.top_k))


def _route(cfg: ModelConfig, router_w, xf):
    """xf: (T, d) -> gates (T, k), idx (T, k), probs (T, E), all but idx f32.
    ``jax.lax.top_k`` takes the lower index on a tie and ``torch.topk``
    promises no order: ties are not expected in f32 and are not broken
    alike."""
    logits = torch.matmul(xf.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, idx, probs


def _positions(idx, E: int, C: int):
    """Slot positions within each expert for (T, k) routed pairs, in
    token-major order: (flat_e, flat_pos clamped to C - 1, keep)."""
    T, k = idx.shape
    oh = F.one_hot(idx.reshape(T * k), E)
    pos = torch.cumsum(oh, dim=0) - oh
    flat_pos = (pos * oh).sum(dim=-1)
    flat_e = idx.reshape(T * k)
    keep = flat_pos < C
    return flat_e, flat_pos.clamp(max=C - 1), keep


def _aux_loss(cfg: ModelConfig, probs, idx):
    """The load-balance loss E * sum_e f_e * P_e / k."""
    oh = F.one_hot(idx, cfg.n_experts).float()  # (T, k, E)
    f_e = oh.sum(dim=1).mean(dim=0)
    P_e = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(f_e * P_e) / cfg.top_k


def _expert_mlp(h_in, wg, wu, wd):
    """Every expert's gated MLP on its (C, d) buffer: (E, C, d) -> (E, C, d)."""
    h = torch.bmm(h_in, wg)
    u = torch.bmm(h_in, wu)
    h = F.silu(h.float()).to(h_in.dtype) * u
    return torch.bmm(h, wd)


def _moe_local(cfg: ModelConfig, p: Dict, x, compute_dtype):
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(cfg, T)
    xf = x.reshape(T, d)
    gates, idx, probs = _route(cfg, p["router"], xf)
    flat_e, flat_pos, keep = _positions(idx, E, C)

    # a dropped pair adds zeros at slot C - 1; kept pairs have unique
    # slots, so the scatter-add is exact
    xr = xf[:, None, :].expand(T, k, d).reshape(T * k, d)
    rows = torch.where(keep[:, None], xr, 0.0)
    buf = torch.zeros((E, C, d), dtype=compute_dtype, device=x.device)
    buf = buf.index_put((flat_e, flat_pos), rows.to(compute_dtype), accumulate=True)
    out = _expert_mlp(
        buf,
        p["w_gate"].to(compute_dtype),
        p["w_up"].to(compute_dtype),
        p["w_down"].to(compute_dtype),
    )
    vals = out[flat_e, flat_pos]
    w = torch.where(keep, gates.reshape(T * k), 0.0).to(compute_dtype)
    y = (vals * w[:, None]).reshape(T, k, d).sum(dim=1)
    return y.reshape(B, S, d), _aux_loss(cfg, probs, idx)


def moe_ffn(cfg: ModelConfig, p: Dict, x, compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux loss), always by the local path."""
    # the reference's shard_map paths (a2a, replicated) wait for ROADMAP.md item 5
    return _moe_local(cfg, p, x, compute_dtype)
