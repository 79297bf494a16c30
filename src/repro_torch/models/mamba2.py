"""Mamba2 / SSD (state-space duality) blocks: chunked scan + O(1) decode.

The counterpart of ``repro.models.mamba2``, with its layouts at every
function's boundary: ``x (B, S, H, P)``, ``a (B, S, H)``, ``Bm``/``Cm
(B, S, G, N)``, the state ``(B, H, P, N)`` in f32.  :func:`ssd` is the plain
chunked form (arXiv:2405.21060 listing 1); the prefill's scan in
:func:`mamba_full` goes through the SSD-scan kernel
(``repro_torch.kernels.ssd_scan``), whose CPU path is :func:`ssd` again.
Training (``return_cache=False``) differentiates :func:`ssd` itself, as the
reference differentiates its jnp ``ssd``.

Both projection layouts are here: the fused ``in_proj`` (the default) and
the ``mamba_split_proj`` streams, each with its own causal conv and cache.
The conv cache holds the last ``K - 1`` rows of the zero-padded,
pre-activation conv input, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import chunk_len, ssd_scan
from repro_torch.models.layers import rmsnorm
from repro_torch.sharding.partition import constrain


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x.  (F.softplus
    returns x itself above 20; the two differ below f32 resolution there,
    but this keeps the port's arithmetic the reference's.)"""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s dtype rule: operands promote to a common type."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[i,j] = sum_{j < t <= i} x[t]; -inf above diag."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd(
    x: torch.Tensor,  # (b, s, h, p) — inputs already scaled by dt
    a: torch.Tensor,  # (b, s, h) — dt * A (negative)
    Bm: torch.Tensor,  # (b, s, g, n)
    Cm: torch.Tensor,  # (b, s, g, n)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, pdim = x.shape
    g, n = Bm.shape[-2:]
    chunk = chunk_len(chunk, s)
    c = s // chunk
    rep = h // g

    xr = x.reshape(b, c, chunk, h, pdim)
    ar = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2).float()  # (b,h,c,l)
    # jnp.repeat(..., rep, axis): head h reads group h // rep
    Bh = Bm.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)  # (b,c,l,h,n)
    Ch = Cm.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)

    a_cs = torch.cumsum(ar, dim=-1)  # (b,h,c,l)

    # 1. intra-chunk (diagonal) term
    L = torch.exp(segsum(ar)).to(x.dtype)  # (b,h,c,l,l)
    Y_diag = _einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, L, xr)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs).to(x.dtype)  # (b,h,c,l)
    states = _einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xr)

    # 3. inter-chunk recurrence
    if init_state is None:
        init_state = torch.zeros((b, h, pdim, n), dtype=states.dtype, device=x.device)
    dt = torch.promote_types(init_state.dtype, states.dtype)
    states = torch.cat([init_state[:, None].to(dt), states.to(dt)], dim=1)  # (b,c+1,h,p,n)
    chunk_sum = a_cs[..., -1]  # (b,h,c)
    padded = F.pad(chunk_sum, (1, 0))
    decay_chunk = torch.exp(segsum(padded)).to(x.dtype)  # (b,h,c+1,c+1)
    new_states = _einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states_in, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output
    state_decay = torch.exp(a_cs).to(x.dtype)  # (b,h,c,l)
    Y_off = _einsum("bclhn,bchpn,bhcl->bclhp", Ch, states_in, state_decay)

    return (Y_diag + Y_off).reshape(b, s, h, pdim), final_state


def _split_zxbcdt(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di : di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N :]
    return z, xBC, dt


def _causal_conv(xs, w, b, K, S, compute_dtype):
    """Depthwise causal conv + SiLU.  Returns the activation and the last
    ``K - 1`` rows of the zero-padded input (the decode cache)."""
    pad = F.pad(xs, (0, 0, K - 1, 0))
    out = sum(pad[:, i : i + S, :] * w[i].to(compute_dtype) for i in range(K))
    out = out + b.to(compute_dtype)
    return F.silu(out.float()).to(compute_dtype), pad[:, -(K - 1) :, :]


def _gated_out(cfg, p, y, z, compute_dtype):
    # the gated norm (RMSNorm(y) * silu(z), or RMSNorm(y * silu(z)) where
    # the config says the gate comes first), then the output projection
    gate = F.silu(z.float()).to(compute_dtype)
    if cfg.norm_before_gate:
        y = rmsnorm(y, p["norm_w"], cfg.norm_eps) * gate
    else:
        y = rmsnorm(y * gate, p["norm_w"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"].to(compute_dtype))


def _proj(x, w, compute_dtype):
    return torch.matmul(x, w.to(compute_dtype))


def mamba_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,  # (B, S, d)
    compute_dtype,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, _ = x.shape
    di, N, G, H, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads, cfg.conv_kernel
    P = cfg.ssm_head_dim

    if cfg.mamba_split_proj:
        z = _proj(x, p["w_z"], compute_dtype)
        xs = _proj(x, p["w_x"], compute_dtype)
        Bs = _proj(x, p["w_B"], compute_dtype)
        Cs = _proj(x, p["w_C"], compute_dtype)
        dt = _proj(x, p["w_dt"], compute_dtype)
        xs, pad_x = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"], K, S, compute_dtype)
        Bs, pad_B = _causal_conv(Bs, p["conv_B_w"], p["conv_B_b"], K, S, compute_dtype)
        Cs, pad_C = _causal_conv(Cs, p["conv_C_w"], p["conv_C_b"], K, S, compute_dtype)
        x_in = constrain(xs.reshape(B, S, H, P), "batch", None, "heads", None)
        Bm = Bs.reshape(B, S, G, N)
        Cm = Cs.reshape(B, S, G, N)
    else:
        zxbcdt = _proj(x, p["in_proj"], compute_dtype)
        z, xBC, dt = _split_zxbcdt(cfg, zxbcdt)
        # causal depthwise conv over (x, B, C) features
        conv, pad = _causal_conv(xBC, p["conv_w"], p["conv_b"], K, S, compute_dtype)
        x_in = conv[..., :di].reshape(B, S, H, P)
        Bm = conv[..., di : di + G * N].reshape(B, S, G, N)
        Cm = conv[..., di + G * N :].reshape(B, S, G, N)
        x_in = constrain(x_in, "batch", None, "heads", None)

    dt = softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,)

    xdt = x_in * dt[..., None].to(compute_dtype)
    if return_cache:
        # the kernel takes a as (B, H, S) and reads B, C and a as strided views
        y, final_state = ssd_scan(xdt, (dt * A).transpose(1, 2), Bm, Cm, chunk=cfg.ssm_chunk)
    else:  # training: the plain chunked form under autograd, as the reference
        y, final_state = ssd(xdt, dt * A, Bm, Cm, cfg.ssm_chunk)
    y = y + x_in * p["D"].to(compute_dtype)[:, None]
    out = constrain(_gated_out(cfg, p, y.reshape(B, S, di), z, compute_dtype),
                    "batch", None, None)

    cache = None
    if return_cache:
        # f32 from ssd_scan
        cache = {"ssm": constrain(final_state, "batch", "heads", None, None)}
        if cfg.mamba_split_proj:
            cache["conv_x"] = pad_x.to(compute_dtype)
            cache["conv_B"] = pad_B.to(compute_dtype)
            cache["conv_C"] = pad_C.to(compute_dtype)
        else:
            cache["conv"] = pad.to(compute_dtype)
    return out, cache


def mamba_decode(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict,  # {"ssm": (B,H,P,N) f32, "conv": (B,K-1,conv_dim)}
    compute_dtype,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step; returns a new cache (the old one is not written)."""
    B = x.shape[0]
    di, N, G, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    P = cfg.ssm_head_dim

    def conv_step(feat, state, w, b):
        win = torch.cat([state, feat[:, None]], dim=1)  # (B, K, c)
        out = torch.einsum("bkc,kc->bc", win, w.to(compute_dtype)) + b.to(compute_dtype)
        return F.silu(out.float()).to(compute_dtype), win[:, 1:]

    new_conv = {}
    if cfg.mamba_split_proj:
        z = _proj(x, p["w_z"], compute_dtype)
        xs = _proj(x, p["w_x"], compute_dtype)[:, 0]
        Bs = _proj(x, p["w_B"], compute_dtype)[:, 0]
        Cs = _proj(x, p["w_C"], compute_dtype)[:, 0]
        dt = _proj(x, p["w_dt"], compute_dtype)
        xs, new_conv["conv_x"] = conv_step(xs, cache["conv_x"], p["conv_x_w"], p["conv_x_b"])
        Bs, new_conv["conv_B"] = conv_step(Bs, cache["conv_B"], p["conv_B_w"], p["conv_B_b"])
        Cs, new_conv["conv_C"] = conv_step(Cs, cache["conv_C"], p["conv_C_w"], p["conv_C_b"])
        x_in = xs.reshape(B, H, P)
        Bm = Bs.reshape(B, G, N)
        Cm = Cs.reshape(B, G, N)
    else:
        zxbcdt = _proj(x, p["in_proj"], compute_dtype)
        z, xBC, dt = _split_zxbcdt(cfg, zxbcdt)
        conv, new_conv["conv"] = conv_step(xBC[:, 0], cache["conv"], p["conv_w"], p["conv_b"])
        x_in = conv[:, :di].reshape(B, H, P)
        Bm = conv[:, di : di + G * N].reshape(B, G, N)
        Cm = conv[:, di + G * N :].reshape(B, G, N)
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)

    dt = softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)  # (B,H)

    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, Bh.float(), x_in.float())
    state = cache["ssm"] * dA[..., None, None] + upd  # (B,H,P,N) f32
    state = constrain(state, "batch", "heads", None, None)

    y = torch.einsum("bhpn,bhn->bhp", state.to(compute_dtype), Ch)
    y = y + x_in * p["D"].to(compute_dtype)[:, None]
    out = _gated_out(cfg, p, y.reshape(B, 1, di), z, compute_dtype)
    return out, {"ssm": state, **new_conv}
