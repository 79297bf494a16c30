"""Flash decoding: one query token per sequence against a KV cache.

:func:`decode_attention` takes the TPU kernel's layout: ``q (B, H, hd)``,
the cache ``k``/``v (B, kvH, Sc, hd)`` in f32, bf16 or int8 (then with f32
per-slot scales ``(B, kvH, Sc)``), and ``pos``, the last valid absolute
position (slots ``<= pos`` are valid).  A CUDA tensor goes to the
hand-written kernel (``csrc/decode_attention.cu``), which splits the valid
prefix over blocks as :func:`split_plan` says (split-K flash decoding); a
CPU tensor goes to :func:`decode_attention_plain`, a masked softmax over
the whole cache.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("decode_attention")
NEG_INF = -1e30
MAX_GROUP = 16  # query heads per kv head the kernel computes together
TILE = 64  # cache slots per tile of the kernel (BK in csrc/decode_attention.cu)
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


def split_plan(B: int, kvH: int, n_valid: int, sm_count: int) -> Tuple[int, int]:
    """``(splits, tiles_per_split)``: how the kernel cuts the valid prefix
    ``[0, n_valid)`` of each (b, kv head) over blocks.  Every split is a
    whole number of ``TILE``-slot tiles (the last one may end on a partial
    tile) and none is empty.  A cache of a tile or two takes one split;
    a longer one aims at about two blocks per SM over the B * kvH rows."""
    tiles = -(-n_valid // TILE)
    if tiles <= 2:
        return 1, tiles
    want = -(-2 * sm_count // (B * kvH))
    per = -(-tiles // min(max(want, 1), tiles))
    return -(-tiles // per), per


_plan = functools.lru_cache(maxsize=4096)(split_plan)  # the wrapper's, per call


def decode_attention_split_plain(q, k, v, pos: int, k_scale=None, v_scale=None,
                                 scale=None, *, splits: int, tiles_per_split: int):
    """The kernel's arithmetic in plain PyTorch: each split's (m, l, acc)
    over its slots (int8 scales applied to the score and to the softmax
    weight), then the combine ``sum_s acc_s e^(m_s - M) / sum_s l_s
    e^(m_s - M)``.  The CPU tests hold it against the reference."""
    B, H, hd = q.shape
    _, kvH, Sc, _ = k.shape
    G = H // kvH
    scale = hd**-0.5 if scale is None else scale
    n_valid = min(Sc, pos + 1)
    qg = q.reshape(B, kvH, G, hd).float()
    ms, ls, accs = [], [], []
    for sp in range(splits):
        lo = sp * tiles_per_split * TILE
        hi = min(n_valid, lo + tiles_per_split * TILE)
        s = torch.einsum("bkgh,bksh->bkgs", qg, k[:, :, lo:hi].float()) * scale
        if k.dtype == torch.int8:
            s = s * k_scale[:, :, None, lo:hi]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        ls.append(p.sum(dim=-1, keepdim=True))
        if k.dtype == torch.int8:
            p = p * v_scale[:, :, None, lo:hi]
        accs.append(torch.einsum("bkgs,bksh->bkgh", p, v[:, :, lo:hi].float()))
        ms.append(m)
    m = torch.stack(ms)
    f = torch.exp(m - m.amax(dim=0))
    out = (torch.stack(accs) * f).sum(0) / (torch.stack(ls) * f).sum(0)
    return out.reshape(B, H, hd).to(q.dtype)


def sm_count(dev: torch.device) -> int:
    return _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)


@functools.lru_cache(maxsize=None)
def _sm_count(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, k_scale=None, v_scale=None, *,
                     scale=None) -> torch.Tensor:
    """(B, H, hd) query vs (B, kvH, Sc, hd) cache -> (B, H, hd).  On the
    card every tensor is contiguous.  The kernel is compiled for hd 64, 128,
    192 and 256; another head dim up to 256 runs zero-padded to the next of
    them (a copy of q and of the cache), and a wider one raises."""
    pos = int(pos)
    if not q.is_cuda:
        if q.device.type == "cpu":
            return decode_attention_plain(q, k, v, pos, k_scale, v_scale, scale)
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    _, kvH, Sc, _ = k.shape
    hp = native.padded_head_dim("decode_attention", hd)
    qd, kd = _Q_DTYPES.get(q.dtype), _KV_DTYPES.get(k.dtype)
    quantized = kd == 2
    dev = q.device
    if (qd is None or kd is None or v.dtype != k.dtype
            or k.shape != (B, kvH, Sc, hd) or v.shape != k.shape or H % kvH
            or H // kvH > MAX_GROUP or pos < 0 or Sc == 0
            or (quantized and (k_scale is None or v_scale is None))):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} {q.dtype}, cache {tuple(k.shape)} "
            f"{k.dtype}/{v.dtype}, pos {pos} (group <= {MAX_GROUP}, "
            "int8 caches with k_scale/v_scale, a valid slot)"
        )
    if quantized and (
        k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
        or k_scale.shape != (B, kvH, Sc) or v_scale.shape != (B, kvH, Sc)
    ):
        raise ValueError("decode_attention: scales must be f32 (B, kvH, Sc)")
    scale = hd**-0.5 if scale is None else scale
    if hp != hd:
        # another head dim than the compiled ones runs zero-padded to the
        # next of them (zero q and k columns add nothing to a score; zero v
        # columns give output columns that are dropped)
        pad = (0, hp - hd)
        o = decode_attention(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), pos,
                             k_scale, v_scale, scale=scale)
        return o[..., :hd].contiguous()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if (k.device != dev or v.device != dev or (ptrs[0] | ptrs[1] | ptrs[2]) & 15
            or not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous())
            or quantized and (k_scale.device != dev or v_scale.device != dev
                              or not (k_scale.is_contiguous() and v_scale.is_contiguous()))):
        raise ValueError("decode_attention: tensors must be contiguous, 16-byte aligned "
                         "and on one device")
    n_valid = min(Sc, pos + 1)
    splits, per = _plan(B, kvH, n_valid, sm_count(dev))
    out = torch.empty_like(q)
    part = (torch.empty(B * H * splits * (hd + 2), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    native.launch(
        "rt_decode_attention", dev, qd, kd, *ptrs,
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, out.data_ptr(),
        None if part is None else part.data_ptr(), B, H, kvH, Sc, hd, n_valid,
        splits, per, float(scale),
    )
    LAUNCHES.add()
    return out
