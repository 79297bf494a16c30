"""Per-cell (architecture x input-shape x mesh) step plans, the counterpart
of ``repro.launch.specs``.

``input_specs`` returns ``meta``-device stand-ins for every model input
(shape and dtype, no allocation); ``build_cell`` wires a step function to
its abstract arguments and the placements trees of the current rules.
Where the reference hands ``jax.jit`` its shardings, a :class:`CellPlan`
carries DTensor placements (one per mesh dim, None without rules).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.interop import dtype_name, torch_dtype
from repro_torch.launch.mesh import data_shards
from repro_torch.models import lm
from repro_torch.serve.steps import ServeStepConfig, make_decode_step, make_prefill_step
from repro_torch.sharding.partition import axis_sizes, named_sharding
from repro_torch.train.steps import TrainStepConfig, default_microbatches, make_train_step


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: the reference's ``jax.ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def make_rules(cfg: ModelConfig, shape: InputShape, multi_pod: bool) -> Dict:
    dp = ("pod", "data") if multi_pod else ("data",)
    train = shape.kind == "train"
    rules = {
        "batch": dp,
        "model": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "capacity": dp,
        "fsdp": ("data",) if train else None,
        # KV caches shard on (replicated) heads, see kv_policy; kv_seq
        # sharding is kept as an experiment knob (default off)
        "kv_seq": None,
    }
    return rules


def kv_policy(cfg: ModelConfig, shape: InputShape, model_shards: int = 16) -> Dict:
    """KV-head replication factor + cache dtype for serve cells.

    Replicating KV heads r-fold makes the head dim divide the TP axis
    (qwen3: 8->16), keeping the cache sharded and update-slices local.
    Archs whose head counts can never divide (28H/4kv, 36H/4kv) fall back to
    replicated heads + int8 KV quantization for the 32k decode cell.
    """
    H, kvH = cfg.n_heads, cfg.n_kv_heads
    if kvH == 0:
        return {"kv_repeat": 1, "kv_dtype": "bfloat16"}
    r = 1
    if kvH % model_shards != 0:
        for cand in range(2, H // kvH + 1):
            eff = kvH * cand
            if H % eff == 0 and eff % model_shards == 0:
                r = cand
                break
    dtype = "bfloat16"
    if (kvH * r) % model_shards != 0 and shape.kind == "decode":
        dtype = "int8"  # unshardable heads: quantize the replicated cache
    return {"kv_repeat": r, "kv_dtype": dtype}


def input_specs(
    cfg: ModelConfig,
    shape: InputShape,
    compute_dtype=torch.bfloat16,
    kv_dtype=torch.bfloat16,
    kv_repeat: int = 1,
) -> Dict[str, Any]:
    """Abstract inputs for the step function of this cell (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model

    def lm_batch(seq, with_targets):
        if cfg.frontend == "audio":
            b = {"frame_embeds": sds((B, seq, d), compute_dtype)}
        else:
            b = {"tokens": sds((B, seq), torch.int32)}
            if cfg.frontend == "vision" and seq > 1:
                b["patch_embeds"] = sds((B, cfg.frontend_tokens, d), compute_dtype)
                b["positions"] = sds((3, B, seq), torch.int32)
        if with_targets:
            b["targets"] = sds((B, seq), torch.int32)
        return b

    if shape.kind == "train":
        return {"batch": lm_batch(S, True)}
    if shape.kind == "prefill":
        return {"batch": lm_batch(S, False)}
    # decode: one new token against a cache of S
    return {
        "batch": lm_batch(1, False),
        "caches": lm.abstract_cache(cfg, B, S, kv_dtype, compute_dtype, kv_repeat),
        "pos": sds((), torch.int32),
    }


def input_shardings(cfg: ModelConfig, shape: InputShape, kv_dtype=torch.bfloat16,
                    kv_repeat: int = 1):
    """Placements tree matching input_specs (call under axis_rules)."""
    B = shape.global_batch

    def lm_batch_sh(seq, with_targets):
        if cfg.frontend == "audio":
            b = {"frame_embeds": named_sharding(("batch", None, None), (B, seq, cfg.d_model))}
        else:
            b = {"tokens": named_sharding(("batch", None), (B, seq))}
            if cfg.frontend == "vision" and seq > 1:
                b["patch_embeds"] = named_sharding(
                    ("batch", None, None), (B, cfg.frontend_tokens, cfg.d_model))
                b["positions"] = named_sharding((None, "batch", None), (3, B, seq))
        if with_targets:
            b["targets"] = named_sharding(("batch", None), (B, seq))
        return b

    if shape.kind == "train":
        return {"batch": lm_batch_sh(shape.seq_len, True)}
    if shape.kind == "prefill":
        return {"batch": lm_batch_sh(shape.seq_len, False)}
    return {
        "batch": lm_batch_sh(1, False),
        "caches": lm.cache_shardings(cfg, B, shape.seq_len, kv_dtype, kv_repeat=kv_repeat),
        "pos": named_sharding(()),
    }


@dataclasses.dataclass
class CellPlan:
    """Everything needed to run (or, later, trace) one (arch x shape x mesh)
    cell: the step, its ``meta`` arguments and their placements (the
    rules' layout; ``fn`` itself takes plain tensors, see
    ``repro_torch.sharding``)."""

    fn: Any
    args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    meta: Dict


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    multi_pod: bool,
    overrides: Optional[Dict] = None,
    cfg: Optional[ModelConfig] = None,
    shape: Optional[InputShape] = None,
) -> CellPlan:
    """Construct the plan for one cell.  Call it inside
    ``axis_rules(mesh, make_rules(...))``, or the placements are None.
    ``shape`` overrides ``SHAPES[shape_name]`` (a cell cut to a card's
    size keeps its name and kind)."""
    overrides = dict(overrides or {})
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    pad_heads = int(overrides.pop("pad_heads", 0))
    if pad_heads:
        # zero-padded extra attention heads: mathematically identical output,
        # makes the head dim divisible by the TP axis
        cfg = dataclasses.replace(cfg, name=cfg.name, n_heads=pad_heads, head_dim=cfg.hd)
    if overrides.pop("mamba_split_proj", 0):
        cfg = dataclasses.replace(cfg, mamba_split_proj=True)
    attn_stages = int(overrides.pop("attn_stages", 1))
    unroll_scans = bool(overrides.pop("unroll_scans", False))
    compute_dtype = torch_dtype(overrides.pop("compute_dtype", "bfloat16"))
    pol = kv_policy(cfg, shape, axis_sizes(mesh).get("model", 1))
    kv_dtype = torch_dtype(overrides.pop("kv_dtype", pol["kv_dtype"]))
    kv_repeat = int(overrides.pop("kv_repeat", pol["kv_repeat"]))

    specs = input_specs(cfg, shape, compute_dtype, kv_dtype, kv_repeat)
    shard = input_shardings(cfg, shape, kv_dtype, kv_repeat)
    meta: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "kind": shape.kind,
        "compute_dtype": dtype_name(compute_dtype),
        "kv_dtype": dtype_name(kv_dtype),
        "kv_repeat": kv_repeat,
    }

    if shape.kind == "train":
        abstract_params = lm.abstract_params(cfg, torch.float32)
        param_sh = lm.param_shardings(cfg)
        opt_abs = {"m": abstract_params, "v": abstract_params, "count": sds((), torch.int32)}
        opt_sh = {"m": param_sh, "v": param_sh, "count": named_sharding(())}
        n_mb = overrides.pop(
            "num_microbatches",
            default_microbatches(
                cfg, shape.global_batch, data_shards(mesh), shape.seq_len,
                axis_sizes(mesh).get("model", 1),
            ),
        )
        tcfg = TrainStepConfig(
            remat=overrides.pop("remat", "full"),
            compute_dtype=dtype_name(compute_dtype),
            num_microbatches=int(n_mb),
            q_chunk=int(overrides.pop("q_chunk", 2048)),
            kv_repeat=kv_repeat,
            attn_stages=attn_stages,
            unroll_scans=unroll_scans,
        )
        meta.update(remat=tcfg.remat, num_microbatches=tcfg.num_microbatches,
                    q_chunk=tcfg.q_chunk)
        return CellPlan(
            fn=make_train_step(cfg, tcfg),
            args=(abstract_params, opt_abs, specs["batch"]),
            in_shardings=(param_sh, opt_sh, shard["batch"]),
            out_shardings=(param_sh, opt_sh, None),
            donate_argnums=(0, 1),
            meta=meta,
        )

    abstract_params = lm.abstract_params(cfg, torch.bfloat16)
    param_sh = lm.param_shardings(cfg)
    ui = overrides.pop("unroll_inner", None)
    scfg = ServeStepConfig(
        compute_dtype=dtype_name(compute_dtype),
        kv_dtype=dtype_name(kv_dtype),
        kv_repeat=kv_repeat,
        kv_block=int(overrides.pop("kv_block", 2048)),
        attn_stages=attn_stages,
        q_chunk=int(overrides.pop("q_chunk", 512)),
        unroll_scans=unroll_scans,
        unroll_inner=None if ui is None else bool(ui),
    )
    meta.update(q_chunk=scfg.q_chunk)

    if shape.kind == "prefill":
        return CellPlan(
            fn=make_prefill_step(cfg, scfg),
            args=(abstract_params, specs["batch"]),
            in_shardings=(param_sh, shard["batch"]),
            out_shardings=None,
            donate_argnums=(),
            meta=meta,
        )

    return CellPlan(
        fn=make_decode_step(cfg, scfg),
        args=(abstract_params, specs["caches"], specs["batch"], specs["pos"]),
        in_shardings=(param_sh, shard["caches"], shard["batch"], shard["pos"]),
        out_shardings=(None, shard["caches"]),
        donate_argnums=(1,),
        meta=meta,
    )


def modeled_memory(cfg: ModelConfig, shape: InputShape, mesh, meta: Dict) -> Dict:
    """Analytic per-device memory model (the reference's, term for term),
    judged against one H100's HBM (``launch.hw``).  It models the layout
    the rules describe (parameters split over ``shards``), not what the
    port holds: its ranks run the dense layers on whole, replicated
    tensors (``repro_torch.sharding``)."""
    from repro_torch.models.moe import capacity

    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    dp = data_shards(mesh)
    train = shape.kind == "train"
    B, S = shape.global_batch, shape.seq_len
    P = cfg.param_count()

    shards = dp * m if train else m  # fsdp x tp in train; tp only in serve
    param_bytes = P * (4 if train else 2) / shards
    opt_bytes = P * 8 / shards if train else 0.0  # adam m+v f32
    grad_bytes = P * 4 / shards if train else 0.0

    # KV / SSM caches (serve only)
    cache_bytes = 0.0
    if shape.kind != "train":
        kv_rep = meta.get("kv_repeat", 1)
        kv_dt = 1 if meta.get("kv_dtype") == "int8" else 2
        b_loc = max(B // dp, 1)
        for s in lm.layer_sequence(cfg):
            if s.kind == "attn":
                kvh = cfg.n_kv_heads * kv_rep
                kvh_loc = kvh / m if kvh % m == 0 else kvh
                Sc = min(s.window, S) if s.window else S
                cache_bytes += 2 * b_loc * kvh_loc * Sc * cfg.hd * kv_dt
                if kv_dt == 1:  # int8 scales
                    cache_bytes += 2 * b_loc * kvh_loc * Sc * 4
            else:
                h_loc = cfg.ssm_heads / m if cfg.ssm_heads % m == 0 else cfg.ssm_heads
                cache_bytes += b_loc * h_loc * cfg.ssm_head_dim * cfg.ssm_state * 4
                cache_bytes += b_loc * (cfg.conv_kernel - 1) * (
                    cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                ) / m * 2

    # transient activations
    act = 0.0
    reps_total = cfg.pattern_reps + len(cfg.remainder)
    if train:
        mb = max(meta.get("num_microbatches", 1), 1)
        tok = (B // dp) * S / mb
        act += reps_total * tok * cfg.d_model * 2  # remat carries
        act += 3 * tok * (cfg.vocab_size / m if cfg.vocab_size % m == 0 else cfg.vocab_size) * 4
        if cfg.n_experts:
            t_dev = tok / m
            act += 3 * cfg.n_experts * capacity(cfg, int(max(t_dev, 1))) * cfg.d_model * 2
        q = min(meta.get("q_chunk", 2048), S)
        kvh = cfg.n_kv_heads * meta.get("kv_repeat", 1)
        kvh_loc = max(kvh / m, 1) if kvh and kvh % m == 0 else kvh
        g = cfg.n_heads / max(kvh, 1)
        act += 2 * (B // dp) / mb * kvh_loc * g * q * S * 4  # score block fwd+bwd
    elif shape.kind == "prefill":
        b_loc = max(B // dp, 1)
        act += 6 * b_loc * S * cfg.d_model * 2
        q = min(meta.get("q_chunk", 512), S)
        if cfg.n_heads:
            kvh = cfg.n_kv_heads * meta.get("kv_repeat", 1)
            kvh_loc = kvh / m if kvh % m == 0 else kvh
            g = cfg.n_heads / max(kvh, 1)
            act += b_loc * kvh_loc * g * q * S * 4
    else:  # decode: per-block transients + logits
        b_loc = max(B // dp, 1)
        act += 0.5e9  # block buffers, norms, residuals
        act += b_loc * cfg.vocab_size * 4

    total = param_bytes + opt_bytes + grad_bytes + cache_bytes + act
    return {
        "param_bytes": param_bytes,
        "opt_bytes": opt_bytes + grad_bytes,
        "cache_bytes": cache_bytes,
        "activation_bytes": act,
        "total_bytes": total,
        "fits_hbm": bool(total < 0.92 * hw_bytes()),
    }


def hw_bytes() -> int:
    from repro_torch.launch import hw

    return hw.HBM_BYTES


def cell_skip_reason(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.long_context_ok:
        return (
            "long_500k requires sub-quadratic attention; "
            f"{arch} is pure full/GQA attention (see DESIGN.md §Arch-applicability)"
        )
    return None
