"""Serving steps: prefill (build cache + first token) and decode (one new
token against an existing KV/SSM cache), the counterpart of
``repro.serve.steps``.  ``launch.specs.build_cell`` wraps them for the
``prefill_*`` / ``decode_*`` cells.

Each step runs the port's ``lm.prefill`` / ``lm.decode_step``: on the card
attention goes through K2 in prefill and K3 in decode (its int8 instance
when ``kv_dtype`` is ``"int8"``).  The tensors may be global views under
``sharding.axis_rules`` (the model's explicit-collective regions then run
on every rank) or plain single-device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import torch_dtype
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class ServeStepConfig:
    """The reference's nine fields and defaults.  ``kv_block``,
    ``attn_stages``, ``q_chunk``, ``unroll_scans`` and ``unroll_inner`` only
    shape the reference's jnp attention loops and scans (K2 and K3 plan
    their own tiles, the layer loop is a Python loop), so the steps do not
    pass them on; ``launch.specs.build_cell`` still records them."""

    compute_dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"
    kv_repeat: int = 1  # KV-head replication so heads divide the TP axis
    kv_block: int = 2048  # flash-decoding block length (the reference's jnp loop)
    attn_stages: int = 1  # staged causal K-slicing in chunked prefill
    q_chunk: int = 512
    greedy: bool = True
    unroll_scans: bool = False  # layer scans (decode: in-place cache aliasing)
    unroll_inner: Optional[bool] = None  # attention block loops (cost runs)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token of each sequence: argmax of the last position's f32
    logits (the first index on a tie, as ``jnp.argmax``), int32."""
    return torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, scfg: ServeStepConfig):
    """``prefill_step(params, batch) -> (next_tok (B,) int32, caches)``."""
    compute_dtype = torch_dtype(scfg.compute_dtype)
    kv_dtype = torch_dtype(scfg.kv_dtype)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches, _ = lm.prefill(cfg, params, batch, compute_dtype=compute_dtype,
                                       kv_repeat=scfg.kv_repeat, kv_dtype=kv_dtype)
        return _greedy(logits), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, scfg: ServeStepConfig):
    """``decode_step(params, caches, batch, pos) -> (next_tok, caches)``; the
    caches are updated in place and returned restacked."""
    compute_dtype = torch_dtype(scfg.compute_dtype)

    @torch.no_grad()
    def decode_step(params, caches, batch, pos):
        logits, caches, _ = lm.decode_step(cfg, params, batch, caches, pos,
                                           compute_dtype=compute_dtype,
                                           kv_repeat=scfg.kv_repeat)
        return _greedy(logits), caches

    return decode_step
