"""Causal / sliding-window flash attention for prefill.

:func:`flash_attention` takes the TPU kernel's layout, ``q (B, H, S, hd)``
and ``k``/``v (B, kvH, S, hd)`` (GQA when kvH < H), f32 or bf16.  A CUDA
tensor goes to the hand-written kernel (``csrc/flash_attention.cu``), which
masks ragged S instead of requiring S to divide into blocks; a CPU tensor
goes to :func:`flash_attention_plain`, a dense masked softmax in f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("flash_attention")
NEG_INF = -1e30
MAX_HD = 128
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale=None) -> torch.Tensor:
    """(B, H, S, hd) x (B, kvH, S, hd)^2 -> (B, H, S, hd)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    native.check_inputs("flash_attention", q, k, v)
    B, H, S, hd = q.shape
    kvH = k.shape[1]
    if k.shape != (B, kvH, S, hd) or v.shape != k.shape or H % kvH:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if hd > MAX_HD:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HD}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive")
    scale = hd**-0.5 if scale is None else scale
    out = torch.empty_like(q)
    lib = native.library()
    with torch.cuda.device(q.device):
        err = lib.rt_flash_attention(
            _DTYPES[q.dtype], ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(k.data_ptr()), ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), B, H, kvH, S, hd, int(causal),
            int(window or 0), float(scale),
            ctypes.c_void_p(native.stream_of(q)),
        )
    native.check(err, "flash_attention")
    LAUNCHES.add()
    return out
