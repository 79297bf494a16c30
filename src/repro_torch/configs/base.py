"""Config dataclasses for architectures and input shapes.

Every assigned architecture is expressed as a ``ModelConfig`` whose layer
stack is a repeating ``pattern`` of ``LayerSpec``s (scanned) plus an optional
unrolled ``remainder``.  This keeps the lowered HLO size O(len(pattern))
instead of O(n_layers), which is what makes 256/512-device SPMD dry-run
compiles tractable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a pattern block."""

    kind: str = "attn"  # "attn" | "mamba"
    window: Optional[int] = None  # sliding-window size; None = global attention
    moe: bool = False  # MoE FFN instead of dense FFN
    ffn: bool = True  # mamba layers in some hybrids have no FFN


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # moe | hybrid | vlm | dense | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # layer pattern (repeated) + remainder (unrolled/stacked separately)
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    pattern_reps: int = 1
    remainder: Tuple[LayerSpec, ...] = ()
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    # --- MoE ---
    n_experts: int = 0  # experts held here: the expert tensors' leading dim
    top_k: int = 0
    # slots an expert takes per token share; None: dropless, every pair kept
    capacity_factor: Optional[float] = 1.25
    router_experts: int = 0  # the router's width when it routes over more (0: n_experts)
    expert_offset: int = 0  # the router's index of the first expert held here
    shared_ff: int = 0  # width of a shared expert beside the routed ones (0: none)
    # --- attention details ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False  # multimodal rotary (3 sections: t/h/w)
    rope: bool = True  # False: no position embedding (NoPE)
    attn_scale: Optional[float] = None  # the score scale; None: hd ** -0.5
    # --- mamba2 / SSD ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_kernel: int = 4
    # shard-aligned split of the fused zxbcdt projection + per-stream convs:
    # slicing a model-sharded fused dim at non-shard boundaries makes GSPMD
    # emit collective-permute realignments every layer (§Perf, mamba2 cell)
    mamba_split_proj: bool = False
    # the gated norm: rmsnorm(y) * silu(z) when True (the JAX package's),
    # rmsnorm(y * silu(z)) when False (mamba_ssm's RMSNormGated default)
    norm_before_gate: bool = True
    # --- modality frontend (stub: precomputed embeddings) ---
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_tokens: int = 256  # patches/frames overlaid at sequence front
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # muP-style multipliers (Granite): the embedding times embed_scale, each
    # layer's mixer and FFN outputs times residual_scale, logits / logits_scaling
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logits_scaling: float = 1.0
    long_context_ok: bool = False  # eligible for the long_500k cell
    source: str = ""  # provenance tag from the assignment

    def __post_init__(self):
        n_pattern = len(self.pattern) * self.pattern_reps + len(self.remainder)
        if n_pattern != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern covers {n_pattern} layers, "
                f"config says {self.n_layers}"
            )
        if self.expert_offset < 0 or self.expert_offset + self.n_experts > self.routed_experts:
            raise ValueError(
                f"{self.name}: experts {self.expert_offset}..{self.expert_offset + self.n_experts}"
                f" held of a router over {self.routed_experts}"
            )

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def routed_experts(self) -> int:
        """The router's width: every expert of the layer, held here or not."""
        return self.router_experts or self.n_experts

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_layers(self) -> int:
        per = sum(1 for s in self.pattern if s.kind == "attn") * self.pattern_reps
        return per + sum(1 for s in self.remainder if s.kind == "attn")

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline terms)."""
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # unembed
        specs = list(self.pattern) * self.pattern_reps + list(self.remainder)
        for s in specs:
            n += self._layer_params(s)
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        specs = list(self.pattern) * self.pattern_reps + list(self.remainder)
        for s in specs:
            n += self._layer_params(s, active_only=True)
        n += self.d_model
        return n

    def _layer_params(self, s: LayerSpec, active_only: bool = False) -> int:
        d, f = self.d_model, self.d_ff
        n = 0
        if s.kind == "attn":
            q = self.n_heads * self.hd
            kv = self.n_kv_heads * self.hd
            n += d * (q + 2 * kv) + q * d  # qkv + out
            if self.qkv_bias:
                n += q + 2 * kv
            n += 2 * d  # pre norms
        elif s.kind == "mamba":
            di, N, H, G = self.d_inner, self.ssm_state, self.ssm_heads, self.ssm_groups
            zx = 2 * di + 2 * G * N + H
            n += d * zx  # in_proj
            n += (di + 2 * G * N) * self.conv_kernel  # conv
            n += 3 * H  # A_log, D, dt_bias
            n += di * d  # out_proj
            n += d + di  # pre norm + gated norm
        if s.ffn:
            e = max(self.n_experts, 1) if s.moe else 1
            per_expert = 3 * d * f  # gated MLP
            if s.moe:
                n += d * self.routed_experts  # router
                k = self.top_k if active_only else e
                n += k * per_expert
                n += 3 * d * self.shared_ff
            else:
                n += per_expert
            n += d  # ffn pre-norm
        return n

    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        scale_pat = tuple(
            dataclasses.replace(s, window=min(s.window, 8) if s.window else None)
            for s in self.pattern
        )
        scale_rem = tuple(
            dataclasses.replace(s, window=min(s.window, 8) if s.window else None)
            for s in self.remainder
        )
        reps = min(self.pattern_reps, 2)
        n_layers = len(self.pattern) * reps + len(self.remainder)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            pattern=scale_pat,
            remainder=scale_rem,
            pattern_reps=reps,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            frontend_tokens=4 if self.frontend else 256,
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def dense_pattern(n_layers: int, window: Optional[int] = None) -> dict:
    return dict(pattern=(LayerSpec(kind="attn", window=window),), pattern_reps=n_layers)


def moe_pattern(n_layers: int) -> dict:
    return dict(pattern=(LayerSpec(kind="attn", moe=True),), pattern_reps=n_layers)
