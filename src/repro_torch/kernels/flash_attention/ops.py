"""Causal / sliding-window flash attention for prefill.

:func:`flash_attention` takes the TPU kernel's layout, ``q (B, H, S, hd)``
and ``k``/``v (B, kvH, S, hd)`` (GQA when kvH < H), f32 or bf16.  A CUDA
tensor goes to the hand-written kernel (``csrc/flash_attention.cu``), which
masks ragged S instead of requiring S to divide into blocks and reads
strided views, so a caller need not copy its projections into this layout;
a CPU tensor goes to :func:`flash_attention_plain`, a dense masked softmax
in f32; a ``meta`` tensor is checked as on the card and gets an empty
result.  :func:`cost` counts the function's least work, which a recorder of
``repro_torch.launch.hlo_analysis`` takes in place of the ops that run.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import native
from repro_torch.launch.hlo_analysis import costed

LAUNCHES = native.LaunchCounter("flash_attention")
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, scale=None):
    """Plain PyTorch version: dense masked softmax attention in f32."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = hd**-0.5 if scale is None else scale
    k = k.repeat_interleave(G, dim=1).float()
    v = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v).to(q.dtype)


def pairs(S: int, causal: bool = True, window: Optional[int] = None) -> int:
    """The (query, key) pairs the kernel scores: key j for query i where
    (not causal or j <= i) and (no window or i - j < window)."""
    w = S if window is None else min(window, S)
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    return S * S - (S - w) * (S - w + 1) // 2


def cost(q, k, v, *, causal: bool = True, window: Optional[int] = None, scale=None,
         out=None):
    """(flops, bytes): q, k and v read once and the output written once;
    QK^T and PV over the scored pairs, 4 hd flops a pair and head."""
    B, H, S, hd = q.shape
    return 4 * hd * pairs(S, causal, window) * B * H, 2 * q.nbytes + k.nbytes + v.nbytes


@costed("flash_attention", cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, S, hd) x (B, kvH, S, hd)^2 -> (B, H, S, hd), written into
    ``out`` when it is given.

    On the card q, k, v and ``out`` may be strided views (the (B, S, H, hd)
    projections transposed, say) whose last dimension is contiguous and
    whose rows start 16-byte aligned.  The kernel is compiled for hd 64,
    128, 192 and 256; another head dim up to 256 runs zero-padded to the
    next of them (a copy of q, k and v), a wider one on the generic
    instance (any row alignment), which refuses only a head dim whose
    accumulator passes a block's shared memory
    (``native.padded_head_dim``)."""
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
        return o if out is None else out.copy_(o)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, S, hd = q.shape
    kvH = k.shape[1]
    hp = native.padded_head_dim("flash_attention", hd)
    if out is None:
        out = torch.empty_like(q)
    dt = _DTYPES.get(q.dtype)
    dev = q.device
    if (dt is None or k.dtype != q.dtype or v.dtype != q.dtype or out.dtype != q.dtype
            or k.device != dev or v.device != dev or out.device != dev
            or k.shape != (B, kvH, S, hd) or v.shape != k.shape or out.shape != q.shape
            or H % kvH or (window is not None and window <= 0)):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}, out {tuple(out.shape)} {out.dtype}, window "
            f"{window} (same device and dtype f32/bf16, H % kvH == 0)"
        )
    if dev.type == "meta":  # shapes only: the checks above, no launch
        return out
    scale = hd**-0.5 if scale is None else scale
    if hp != hd:
        # another head dim than the compiled ones runs zero-padded to the
        # next of them (zero q and k columns add nothing to a score; zero v
        # columns give output columns that are dropped)
        pad = (0, hp - hd)
        o = flash_attention(*(F.pad(t, pad) for t in (q, k, v)), causal=causal,
                            window=window, scale=scale)
        return out.copy_(o[..., :hd])
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1 or os_[3] != 1:
        raise ValueError("flash_attention: every row must be contiguous")
    vec = 16 // q.element_size()  # elements per 16-byte load
    if hd <= native.ATTENTION_HEAD_DIMS[-1] and (
            (qs[0] | qs[1] | qs[2] | ks[0] | ks[1] | ks[2] | vs[0] | vs[1] | vs[2]
             | os_[0] | os_[1] | os_[2]) % vec
            or (q.data_ptr() | k.data_ptr() | v.data_ptr() | out.data_ptr()) & 15):
        raise ValueError("flash_attention: every row must start 16-byte aligned")
    native.launch(
        "rt_flash_attention", dev, dt, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *qs[:3], *ks[:3], *vs[:3], *os_[:3], B, H, kvH, S, hd,
        int(causal), int(window or 0), float(scale),
    )
    LAUNCHES.add()
    return out
