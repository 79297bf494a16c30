"""Flash decoding: one query token per sequence against a KV cache.

:func:`decode_attention` takes the TPU kernel's layout: ``q (B, H, hd)``,
the cache ``k``/``v (B, kvH, Sc, hd)`` in f32, bf16 or int8 (then with f32
per-slot scales ``(B, kvH, Sc)``), and ``pos``, the last valid absolute
position (slots ``<= pos`` are valid).  A CUDA tensor goes to the
hand-written kernel (``csrc/decode_attention.cu``); a CPU tensor goes to
:func:`decode_attention_plain`, a masked softmax over the whole cache.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("decode_attention")
NEG_INF = -1e30
MAX_HD = 128
MAX_GROUP = 16  # query heads per kv head the kernel computes together
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def decode_attention_plain(q, k, v, pos: int, k_scale=None, v_scale=None,
                           scale=None):
    """Plain PyTorch version: dequantize, then a masked softmax in f32."""
    B, H, hd = q.shape
    _, kvH, Sc, _ = k.shape
    G = H // kvH
    scale = hd**-0.5 if scale is None else scale
    if k.dtype == torch.int8:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    qg = q.reshape(B, kvH, G, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k.float()) * scale
    valid = torch.arange(Sc, device=q.device) <= pos
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", w, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, k_scale=None, v_scale=None, *,
                     scale=None) -> torch.Tensor:
    """(B, H, hd) query vs (B, kvH, Sc, hd) cache -> (B, H, hd)."""
    pos = int(pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, k_scale, v_scale, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    quantized = k.dtype == torch.int8
    tensors = [q, k, v] + ([k_scale, v_scale] if quantized else [])
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("decode_attention: int8 caches need k_scale/v_scale")
    native.check_inputs("decode_attention", *tensors)
    B, H, hd = q.shape
    _, kvH, Sc, _ = k.shape
    if k.shape != (B, kvH, Sc, hd) or v.shape != k.shape or H % kvH:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, cache {tuple(k.shape)}"
        )
    if q.dtype not in _Q_DTYPES or k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if quantized and (
        k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
        or k_scale.shape != (B, kvH, Sc) or v_scale.shape != (B, kvH, Sc)
    ):
        raise ValueError("decode_attention: scales must be f32 (B, kvH, Sc)")
    if hd > MAX_HD or H // kvH > MAX_GROUP:
        raise ValueError(f"decode_attention: hd {hd} / group {H // kvH} too large")
    if pos < 0:
        raise ValueError(f"decode_attention: pos {pos} leaves no valid slot")
    scale = hd**-0.5 if scale is None else scale
    out = torch.empty_like(q)
    lib = native.library()
    null = ctypes.c_void_p(None)
    with torch.cuda.device(q.device):
        err = lib.rt_decode_attention(
            _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype],
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(k_scale.data_ptr()) if quantized else null,
            ctypes.c_void_p(v_scale.data_ptr()) if quantized else null,
            ctypes.c_void_p(out.data_ptr()), B, H, kvH, Sc, hd, pos,
            float(scale), ctypes.c_void_p(native.stream_of(q)),
        )
    native.check(err, "decode_attention")
    LAUNCHES.add()
    return out
