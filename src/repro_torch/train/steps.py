"""Training step: cross entropy, microbatched gradient accumulation, AdamW;
the counterpart of ``repro.train.steps``.

The step is autograd over the model's PyTorch ops: the reference
differentiates its jnp model with ``jax.value_and_grad`` and reaches no
Pallas kernel in training, so neither does this step.  Under
``sharding.axis_rules`` over a ``DeviceMesh`` the same step runs on every
rank with the model's explicit-collective regions (the vocab-parallel
embedding, the MoE's expert parallelism) split between ranks; their
gradients come back as global views, so every rank applies the same update.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import torch_dtype, tree_leaves, tree_map
from repro_torch.models import lm
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: str = "full"  # full | dots | dots_no_batch
    compute_dtype: str = "bfloat16"
    num_microbatches: int = 1
    aux_coeff: float = 0.01
    q_chunk: int = 2048
    kv_repeat: int = 1  # KV-head replication so GQA scores shard on the TP axis
    attn_stages: int = 1  # staged causal K-slicing in chunked attention
    unroll_scans: bool = False  # the reference's scan lowering; not passed on
    optim: AdamWConfig = AdamWConfig()


def default_microbatches(
    cfg: ModelConfig, global_batch: int, n_data_shards: int, seq_len: int = 4096,
    model_shards: int = 16,
) -> int:
    """Pick grad-accum so rematted scan carries + CE logits fit HBM/chip."""
    per_dev = max(global_batch // max(n_data_shards, 1), 1)
    reps_total = cfg.pattern_reps + len(cfg.remainder)
    # non-divisible vocab (e.g. mamba2's 50280 on 16 shards) -> replicated logits
    vocab_loc = (
        cfg.vocab_size / model_shards
        if cfg.vocab_size % model_shards == 0
        else cfg.vocab_size
    )
    budget = 8e9
    for mb in (1, 2, 4, 8, 16):
        if per_dev % mb and mb != 1:
            continue
        tok = (per_dev / mb) * seq_len
        carries = reps_total * tok * cfg.d_model * 2  # bf16 saved block inputs
        logits = 3 * tok * vocab_loc * 4  # f32 logits + CE temps
        if carries + logits <= budget:
            return mb
    return min(16, per_dev) or 1


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions.  The target logit is gathered: the
    reference's masked sum (which keeps GSPMD from replicating vocab-sharded
    logits) adds exact zeros besides it, so both give the same value; the
    port's logits are global views, never vocab-sharded."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - tgt)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainStepConfig):
    compute_dtype = torch_dtype(tcfg.compute_dtype)

    def loss_fn(params, batch):
        logits, aux = lm.forward(
            cfg,
            params,
            batch,
            remat=tcfg.remat,
            compute_dtype=compute_dtype,
            q_chunk=tcfg.q_chunk,
            kv_repeat=tcfg.kv_repeat,
            attn_stages=tcfg.attn_stages,
        )
        loss = softmax_xent(logits, batch["targets"])
        return loss + tcfg.aux_coeff * aux, {"loss": loss, "aux": aux}

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), the grads a tree like ``params`` (zeros for unused leaves)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        total, metrics = loss_fn(tracked, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), tree_map(lambda _: next(it), params)


def _mb_split(key: str, x: torch.Tensor, n_mb: int):
    """``x`` cut into ``n_mb`` microbatches along the batch axis: 0, but 1
    for ``positions`` (M-RoPE's are (3, B, S))."""
    ax = 1 if key == "positions" else 0
    if x.shape[ax] % n_mb:
        raise ValueError(f"{key}: batch {tuple(x.shape)} does not split into {n_mb} microbatches")
    return x.chunk(n_mb, dim=ax)


def make_train_step(cfg: ModelConfig, tcfg: TrainStepConfig):
    """``train_step(params, opt, batch) -> (params, opt, metrics)``; ``batch``
    holds torch tensors on the parameters' device."""
    loss_fn = make_loss_fn(cfg, tcfg)
    n_mb = tcfg.num_microbatches

    def train_step(params, opt, batch: Dict[str, torch.Tensor]):
        if n_mb <= 1:
            (_, metrics), grads = _value_and_grad(loss_fn, params, batch)
        else:
            parts = {k: _mb_split(k, v, n_mb) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = 0.0
            for i in range(n_mb):
                (_, m), g = _value_and_grad(loss_fn, params, {k: v[i] for k, v in parts.items()})
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
                loss_sum = loss_sum + m["loss"]
            grads = tree_map(lambda g: g / n_mb, grads)
            metrics = {"loss": loss_sum / n_mb,
                       "aux": torch.zeros((), dtype=torch.float32, device=loss_sum.device)}

        params, opt, om = adamw_update(tcfg.optim, grads, opt, params)
        metrics.update(om)
        return params, opt, metrics

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None):
    """Seeded params (``lm.init_params``) and their AdamW state, on
    ``device`` (None: the GPU)."""
    params = lm.init_params(cfg, seed=seed, dtype=dtype, device=resolve_device(device))
    return params, adamw_init(params)
