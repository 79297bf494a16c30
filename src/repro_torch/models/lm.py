"""The causal LM: parameter shapes and seeded initialization, the stacked
train forward, and the serving stack (prefill, decode).

The tree has the JAX package's stacked layout, so weights carry across
unchanged: ``{"embed": {"tok"[, "unembed"]}, "pattern": (stacked layer
params per pattern position,), "remainder": (layer params,),
"final_norm"}``.  :func:`forward` runs the pattern rep by rep over those
stacked leaves, where the reference scans over them (``jax.lax.scan``), so
gradients land in the stacked leaves; training wraps each rep and each
remainder layer in activation checkpointing as the reference wraps them in
``jax.checkpoint``.  Serving runs layer by layer (:func:`serve_layers`):
``repro_torch.serve.instance.generate`` drives it over a restore's
per-layer tree, :func:`prefill` / :func:`decode_step` over stacked params.
Attention and Mamba2 layers, dense and MoE FFNs, the audio frontend
(``frame_embeds`` in place of the token embedding) and the vision one
(``patch_embeds`` overlaid on the sequence front, M-RoPE positions) are
all here, as in the reference's ``_embed_inputs``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models import blocks, moe
from repro_torch.models.frontends import overlay_patches
from repro_torch.models.layers import embed, rmsnorm, unembed
from repro_torch.sharding.partition import (
    ParamSpec,
    abstract_from_specs,
    map_specs,
    shardings_from_specs,
)

DEFAULT_COMPUTE = torch.bfloat16

# remat name -> the aten ops whose outputs the recomputation keeps (the
# reference's jax.checkpoint_policies: dots_saveable saves every matrix
# product, dots_with_no_batch_dims_saveable those without batch dims)
REMAT_POLICIES = {
    "full": None,  # save nothing, recompute everything
    "dots": ("mm", "bmm"),
    "dots_no_batch": ("mm",),
}


def _attn_specs(cfg: ModelConfig) -> Dict:
    d, H, kvH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = {
        "wq": ParamSpec((d, H * hd), ("fsdp", "model"), "fanin"),
        "wk": ParamSpec((d, kvH * hd), ("fsdp", "model"), "fanin"),
        "wv": ParamSpec((d, kvH * hd), ("fsdp", "model"), "fanin"),
        "wo": ParamSpec((H * hd, d), ("model", "fsdp"), "fanin"),
    }
    if cfg.qkv_bias:
        attn["bq"] = ParamSpec((H * hd,), ("model",), "zeros")
        attn["bk"] = ParamSpec((kvH * hd,), ("model",), "zeros")
        attn["bv"] = ParamSpec((kvH * hd,), ("model",), "zeros")
    if cfg.qk_norm:
        attn["q_norm"] = ParamSpec((hd,), (None,), "ones", torch.float32)
        attn["k_norm"] = ParamSpec((hd,), (None,), "ones", torch.float32)
    return attn


def _mamba_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di, N, H, G, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups, cfg.conv_kernel
    f32 = torch.float32
    fm, m = ("fsdp", "model"), ("model",)
    if cfg.mamba_split_proj:
        # shard-aligned streams: no slicing of a sharded fused dim
        proj = {
            "w_z": ParamSpec((d, di), fm, "fanin"),
            "w_x": ParamSpec((d, di), fm, "fanin"),
            "w_B": ParamSpec((d, G * N), fm, "fanin"),
            "w_C": ParamSpec((d, G * N), fm, "fanin"),
            "w_dt": ParamSpec((d, H), fm, "fanin"),
            "conv_x_w": ParamSpec((K, di), (None, "model")),
            "conv_x_b": ParamSpec((di,), m, "zeros"),
            "conv_B_w": ParamSpec((K, G * N), (None, "model")),
            "conv_B_b": ParamSpec((G * N,), m, "zeros"),
            "conv_C_w": ParamSpec((K, G * N), (None, "model")),
            "conv_C_b": ParamSpec((G * N,), m, "zeros"),
        }
    else:
        conv_dim = di + 2 * G * N
        proj = {
            "in_proj": ParamSpec((d, 2 * di + 2 * G * N + H), fm, "fanin"),
            "conv_w": ParamSpec((K, conv_dim), (None, "model")),
            "conv_b": ParamSpec((conv_dim,), m, "zeros"),
        }
    # the reference pins these four to f32 whatever the model's dtype
    return {
        **proj,
        "A_log": ParamSpec((H,), (None,), "log_uniform", f32),
        "D": ParamSpec((H,), (None,), "ones", f32),
        "dt_bias": ParamSpec((H,), (None,), "zeros", f32),
        "norm_w": ParamSpec((di,), m, "ones", f32),
        "out_proj": ParamSpec((di, d), ("model", "fsdp"), "fanin"),
    }


def _layer_specs(cfg: ModelConfig, spec: LayerSpec) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    out = {"ln1": ParamSpec((d,), (None,), "ones", torch.float32)}
    if spec.kind == "attn":
        out["attn"] = _attn_specs(cfg)
    else:
        out["mamba"] = _mamba_specs(cfg)
    if spec.ffn:
        out["ln2"] = ParamSpec((d,), (None,), "ones", torch.float32)
        if spec.moe:
            # the reference's moe_specs: fan-in over the second-to-last dim
            E = cfg.n_experts
            out["moe"] = {
                "router": ParamSpec((d, cfg.routed_experts), (None, None), "fanin",
                                    torch.float32),
                **{k: ParamSpec(shp, moe.W_LOGICAL[k], "fanin") for k, shp in (
                    ("w_gate", (E, d, f)), ("w_up", (E, d, f)), ("w_down", (E, f, d)))},
            }
            if cfg.shared_ff:
                out["shared"] = _mlp_specs(d, cfg.shared_ff)
        else:
            out["mlp"] = _mlp_specs(d, f)
    return out


def _mlp_specs(d: int, f: int) -> Dict:
    return {
        "w_gate": ParamSpec((d, f), ("fsdp", "model"), "fanin"),
        "w_up": ParamSpec((d, f), ("fsdp", "model"), "fanin"),
        "w_down": ParamSpec((f, d), ("model", "fsdp"), "fanin"),
    }


def _stack_specs(tree, reps: int):
    return map_specs(tree, lambda s: dataclasses.replace(
        s, shape=(reps,) + s.shape, logical=(None,) + s.logical))


def param_specs(cfg: ModelConfig) -> Dict:
    """Every parameter's :class:`ParamSpec` (shape, logical axes, init,
    dtype), in the reference's stacked tree; the logical axes are the
    reference's, leaf for leaf."""
    embed = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "fsdp"))}
    if not cfg.tie_embeddings:
        embed["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("fsdp", "vocab"), "fanin")
    return {
        "embed": embed,
        "pattern": tuple(_stack_specs(_layer_specs(cfg, s), cfg.pattern_reps)
                         for s in cfg.pattern),
        "remainder": tuple(_layer_specs(cfg, s) for s in cfg.remainder),
        "final_norm": ParamSpec((cfg.d_model,), (None,), "ones", torch.float32),
    }


def abstract_params(cfg: ModelConfig, dtype=torch.float32):
    return abstract_from_specs(param_specs(cfg), dtype)


def param_shardings(cfg: ModelConfig):
    return shardings_from_specs(param_specs(cfg))


def _cache_layer_specs(cfg: ModelConfig, spec: LayerSpec, batch: int, cache_len: int,
                       kv_dtype, compute_dtype, kv_repeat: int = 1) -> Dict:
    """One layer's cache, as the reference's ``blocks.cache_specs_for_layer``."""
    if spec.kind == "attn":
        Sc = min(spec.window, cache_len) if spec.window else cache_len
        kvH = cfg.n_kv_heads * kv_repeat
        ax = ("batch", "kv_heads", "kv_seq", None)
        kv = ParamSpec((batch, kvH, Sc, cfg.hd), ax, "zeros", kv_dtype)
        out = {"k": kv, "v": kv}
        if kv_dtype == torch.int8:
            sc = ParamSpec((batch, kvH, Sc), ax[:3], "zeros", torch.float32)
            out["k_scale"] = sc
            out["v_scale"] = sc
        return out
    out = {"ssm": ParamSpec((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                            ("batch", "heads", None, None), "zeros", torch.float32)}
    gn = cfg.ssm_groups * cfg.ssm_state
    conv = ("batch", None, "model")
    K1 = cfg.conv_kernel - 1
    if cfg.mamba_split_proj:
        for key, c in (("conv_x", cfg.d_inner), ("conv_B", gn), ("conv_C", gn)):
            out[key] = ParamSpec((batch, K1, c), conv, "zeros", compute_dtype)
    else:
        out["conv"] = ParamSpec((batch, K1, cfg.d_inner + 2 * gn), conv, "zeros", compute_dtype)
    return out


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int, kv_dtype=torch.bfloat16,
                compute_dtype=None, kv_repeat: int = 1) -> Dict:
    """The serving caches' specs, stacked as the reference's ``cache_specs``
    (``{"pattern", "remainder"}``)."""
    compute_dtype = compute_dtype or DEFAULT_COMPUTE
    layer = partial(_cache_layer_specs, cfg, batch=batch, cache_len=cache_len,
                    kv_dtype=kv_dtype, compute_dtype=compute_dtype, kv_repeat=kv_repeat)
    return {
        "pattern": tuple(_stack_specs(layer(spec=s), cfg.pattern_reps) for s in cfg.pattern),
        "remainder": tuple(layer(spec=s) for s in cfg.remainder),
    }


def init_cache(cfg, batch, cache_len, kv_dtype=torch.bfloat16, compute_dtype=None,
               kv_repeat: int = 1, device=None):
    specs = cache_specs(cfg, batch, cache_len, kv_dtype, compute_dtype, kv_repeat)
    dev = resolve_device(device)
    return map_specs(specs, lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev))


def abstract_cache(cfg, batch, cache_len, kv_dtype=torch.bfloat16, compute_dtype=None,
                   kv_repeat: int = 1):
    return abstract_from_specs(
        cache_specs(cfg, batch, cache_len, kv_dtype, compute_dtype, kv_repeat), None)


def cache_shardings(cfg, batch, cache_len, kv_dtype=torch.bfloat16, compute_dtype=None,
                    kv_repeat: int = 1):
    return shardings_from_specs(
        cache_specs(cfg, batch, cache_len, kv_dtype, compute_dtype, kv_repeat))


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None):
    """Random weights from a numpy ``Generator``: N(0, 0.02) for ``normal``,
    N(0, 1/fan_in) for ``fanin`` (fan-in = the second-to-last dim), as
    ``repro.sharding.partition.ParamSpec.initialize`` scales them, and
    log U[1, 16) for ``log_uniform`` (Mamba2's ``A_log``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def build(s: ParamSpec) -> torch.Tensor:
        dt = s.dtype or dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "log_uniform":
            a = np.log(rng.uniform(1.0, 16.0, s.shape)).astype(np.float32)
            return torch.from_numpy(a).to(device=dev, dtype=dt)
        scale = 0.02
        if s.init == "fanin" and len(s.shape) >= 2:
            scale = s.shape[-2] ** -0.5
        a = rng.standard_normal(s.shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(device=dev, dtype=dt)

    return map_specs(param_specs(cfg), build)


# ------------------------------------------------------------------ forward
def _remat(fn, remat: Optional[str]):
    """``fn`` under activation checkpointing with the named policy (None is
    "full", as in the reference)."""
    name = remat or "full"
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; expected one of {sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[name]
    if saved is None:
        return partial(checkpoint, fn, use_reentrant=False)
    ops = {getattr(torch.ops.aten, n).default for n in saved}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return partial(checkpoint, fn, use_reentrant=False,
                   context_fn=partial(create_selective_checkpoint_contexts, policy))


def _unstack(tree, n: int):
    """Rep ``r``'s slice ``a[r]`` of every stacked leaf, for each r.  One
    ``unbind`` per leaf: its backward stacks the reps' gradients once,
    where ``n`` selects would each scatter into a zeroed full-size leaf."""
    cols = [a.unbind(0) for a in tree_leaves(tree)]

    def rep(r):
        it = iter(cols)
        return tree_map(lambda _: next(it)[r], tree)

    return [rep(r) for r in range(n)]


def _stack(trees):
    """Per-rep trees -> one tree of leaves stacked along a leading axis."""
    cols = iter([torch.stack(c) for c in zip(*(tree_leaves(t) for t in trees))])
    return tree_map(lambda _: next(cols), trees[0])


def layer_sequence(cfg: ModelConfig) -> List[LayerSpec]:
    """Every layer's spec, in the order the stack runs them."""
    return [s for _ in range(cfg.pattern_reps) for s in cfg.pattern] + list(cfg.remainder)


def _per_layer(cfg: ModelConfig, tree) -> List:
    """A stacked tree (params or caches: ``{"pattern", "remainder"}``) as one
    entry per layer, in :func:`layer_sequence` order."""
    reps = [_unstack(p, cfg.pattern_reps) for p in tree["pattern"]]
    n = len(cfg.pattern)
    return [reps[i][r] for r in range(cfg.pattern_reps) for i in range(n)] + list(
        tree["remainder"]
    )


def _restack(cfg: ModelConfig, per_layer: List) -> Dict:
    """The inverse of :func:`_per_layer`."""
    n, cut = len(cfg.pattern), cfg.pattern_reps * len(cfg.pattern)
    return {
        "pattern": tuple(_stack(per_layer[i:cut:n]) for i in range(n)),
        "remainder": tuple(per_layer[cut:]),
    }


def _embed_inputs(cfg: ModelConfig, params, batch: Dict, compute_dtype):
    if cfg.frontend == "audio":
        x = batch["frame_embeds"].to(compute_dtype)
    else:
        x = embed(cfg, params["embed"], batch["tokens"], compute_dtype)
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            x = overlay_patches(x, batch["patch_embeds"].to(compute_dtype))
    positions = batch.get("positions")
    if positions is None:
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def forward(
    cfg: ModelConfig,
    params,
    batch: Dict,
    *,
    compute_dtype=DEFAULT_COMPUTE,
    remat: Optional[str] = None,
    q_chunk: int = 2048,
    attn_stages: int = 1,
    kv_repeat: int = 1,
    unroll: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train forward (the reference's ``forward(mode="train")``):
    returns (logits, aux_loss).  ``batch`` holds torch tensors: ``tokens``
    (B, S), or ``frame_embeds`` (B, S, d) for the audio frontend; for the
    vision frontend optionally ``patch_embeds`` (B, P, d); optionally
    ``positions``, (B, S) or (3, B, S) for M-RoPE.  The pattern runs rep
    by rep over the stacked leaves, each rep and each remainder layer under
    ``remat``.  ``kv_repeat`` replicates each KV head that many times (GQA
    heads made to divide a tensor-parallel axis; the result is the same).
    ``unroll`` only steers the reference's ``jax.lax.scan`` lowering: the
    port's layer loop is a Python loop already, so it changes nothing."""
    del unroll
    x, positions = _embed_inputs(cfg, params, batch, compute_dtype)
    apply = partial(
        blocks.apply_layer,
        cfg,
        positions=positions,
        mode="train",
        cache=None,
        pos=None,
        compute_dtype=compute_dtype,
        q_chunk=q_chunk,
        attn_stages=attn_stages,
        kv_repeat=kv_repeat,
    )

    def body(x, p_rep):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, p in zip(cfg.pattern, p_rep):
            x, _, a = apply(spec, p, x)
            aux = aux + a
        return x, aux

    def rem_body(x, p, spec):
        x, _, a = apply(spec, p, x)
        return x, a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    p_reps = [_unstack(p, cfg.pattern_reps) for p in params["pattern"]]
    body = _remat(body, remat)
    for r in range(cfg.pattern_reps):
        x, a = body(x, tuple(p[r] for p in p_reps))
        aux = aux + a
    # remainder layers are rematted too, as in the reference
    rem_body = _remat(rem_body, remat)
    for spec, p in zip(cfg.remainder, params["remainder"]):
        x, a = rem_body(x, p, spec)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params["embed"], x, compute_dtype), aux


# ------------------------------------------------------------------ serving
def serve_layers(cfg: ModelConfig, layer_params, x, positions, *, mode: str, caches,
                 pos, compute_dtype, kv_repeat: int = 1, kv_dtype=None) -> Tuple[torch.Tensor, List]:
    """The serving stack, prefill or decode, one layer after another (on the
    card attention runs K2 in prefill and K3 in decode).  ``layer_params(i)``
    gives layer ``i``'s params as it is about to run, so a caller can wait
    for each layer's restore; ``caches`` is the per-layer list that prefill
    returned (None in prefill).  Returns (x, per-layer caches)."""
    new_caches = []
    for i, spec in enumerate(layer_sequence(cfg)):
        x, c, _ = blocks.apply_layer(
            cfg, spec, layer_params(i), x, positions=positions, mode=mode,
            cache=None if caches is None else caches[i], pos=pos, compute_dtype=compute_dtype,
            kv_repeat=kv_repeat, kv_dtype=kv_dtype, layer=i,
        )
        new_caches.append(c)
    return x, new_caches


def _last_logits(cfg: ModelConfig, params, x, compute_dtype):
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params["embed"], x, compute_dtype)


def prefill(cfg: ModelConfig, params, batch: Dict, *, compute_dtype=DEFAULT_COMPUTE,
            q_chunk: int = 2048, unroll: bool = False, kv_repeat: int = 1, kv_dtype=None,
            attn_stages: int = 1):
    """Returns (the last position's logits, caches, aux), the caches in the
    reference's stacked layout.  ``kv_dtype`` is the caches' dtype (None:
    the compute dtype); at ``torch.int8`` each attention layer writes its
    cache quantized, with per-slot f32 scales, and :func:`decode_step`
    then attends through K3's int8 instance.  ``kv_repeat`` replicates KV
    heads in the caches too.  ``q_chunk``, ``attn_stages`` and ``unroll``
    only shape the reference's jnp attention and scans: K2 tiles the prompt
    itself and the layer loop is a Python loop, so they change nothing."""
    del q_chunk, unroll, attn_stages
    x, positions = _embed_inputs(cfg, params, batch, compute_dtype)
    layers = _per_layer(cfg, params)
    x, caches = serve_layers(cfg, layers.__getitem__, x, positions, mode="prefill",
                             caches=None, pos=None, compute_dtype=compute_dtype,
                             kv_repeat=kv_repeat, kv_dtype=kv_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _last_logits(cfg, params, x, compute_dtype), _restack(cfg, caches), aux


def decode_step(cfg: ModelConfig, params, batch: Dict, caches: Dict, pos, *,
                compute_dtype=DEFAULT_COMPUTE, unroll: bool = False,
                unroll_inner: Optional[bool] = None, kv_repeat: int = 1, kv_block: int = 2048):
    """One token step.  ``batch`` holds (B, 1) tokens or (B, 1, d) frame
    embeds; ``pos`` is the number of tokens already in the cache (attention
    rotates at ``pos``, as the reference's ``attn_decode`` does).  Each
    attention layer's new K/V are written into ``caches`` in place (as
    ``attention.attn_decode`` does) and the caches come back restacked.
    The caches' dtype (bf16, f32 or int8 with scales) is whatever
    :func:`prefill` wrote; ``kv_repeat`` must be the one they were written
    with.  ``unroll``, ``unroll_inner`` and ``kv_block`` only shape the
    reference's jnp loops: K3 plans its own splits, so they change nothing."""
    del unroll, unroll_inner, kv_block
    x, _ = _embed_inputs(cfg, params, batch, compute_dtype)
    layers = _per_layer(cfg, params)
    x, new_caches = serve_layers(cfg, layers.__getitem__, x, None, mode="decode",
                                 caches=_per_layer(cfg, caches), pos=int(pos),
                                 compute_dtype=compute_dtype, kv_repeat=kv_repeat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _last_logits(cfg, params, x, compute_dtype), _restack(cfg, new_caches), aux
