"""AdamW with global-norm clipping and optional int8 gradient compression
(error-feedback), the counterpart of ``repro.train.optim``.

Everything is f32: the moments, the norm, the schedule.  ``count`` is an
int32 0-d tensor on the parameters' device, as the reference keeps it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.treeutil import flatten_state
from repro_torch.interop import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> Dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt: Dict, params) -> Tuple[Any, Dict, Dict]:
    """Returns (new_params, new_opt, {"grad_norm", "lr"}); parameters keep
    their own dtype, decay applies to leaves with ``ndim >= 2`` only."""
    grads = tree_map(lambda g: g.float(), grads)
    # summed in jax.tree.leaves order (dict keys sorted), as the reference
    # sums: a tree restored from a checkpoint lists its keys sorted and a
    # built one in insertion order, and f32 addition depends on the order
    gnorm = torch.sqrt(sum(torch.sum(g * g) for _, g in flatten_state(grads)[0]) + 1e-16)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / gnorm, max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    count = opt["count"] + 1
    lr = _schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    new_m = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, opt["m"], grads)
    new_v = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, opt["v"], grads)

    def upd(p, m, v):
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    new_opt = {"m": new_m, "v": new_v, "count": count}
    return new_params, new_opt, {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------- int8 gradient compression
def compress_int8(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization: returns (q, scale, new_err)."""
    g = g.float() + err
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g - deq


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
