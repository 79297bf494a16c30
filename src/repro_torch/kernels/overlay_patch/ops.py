"""Overlay patch: restore a flat tensor from base, private and zero pages.

``plan_from_itable`` / ``compact_plan_from_itable`` turn a JIF interval
table into the dense (kinds, src) page tables, host-side, once per restore.
``compact_plan_from_itable`` numbers the private pages 0..n_priv-1 in page
order: the fused restore reads ONLY the private chunks into a compact
staging buffer and the kernel gathers from that dense array.

:func:`overlay_patch` is the serving-path entry.  A CUDA tensor goes to the
hand-written kernel (``csrc/overlay_patch.cu``); a CPU tensor goes to
:func:`overlay_patch_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.overlay import KIND_BASE, KIND_PRIVATE, IntervalTable
from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("overlay_patch")


def plan_from_itable(table: IntervalTable) -> Tuple[np.ndarray, np.ndarray]:
    n = table.n_pages
    kinds = np.zeros((n,), np.int32)
    src = np.zeros((n,), np.int32)
    for start, count, kind, s in table.table:
        kinds[start : start + count] = kind
        if kind == KIND_PRIVATE:
            src[start : start + count] = np.arange(s, s + count)
    return kinds, src


def compact_plan_from_itable(
    table: IntervalTable,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int, int]], int]:
    """(kinds, src, runs, n_priv) with ``src`` indexing a COMPACT private
    array: private pages are numbered 0..n_priv-1 in page order.  ``runs``
    is the read plan — (compact_slot, data_chunk, count) per private run —
    mapping the JIF data segment onto the compact staging buffer."""
    n = table.n_pages
    kinds = np.zeros((n,), np.int32)
    src = np.zeros((n,), np.int32)
    runs: List[Tuple[int, int, int]] = []
    k = 0
    for start, count, kind, s in table.table:
        kinds[start : start + count] = kind
        if kind == KIND_PRIVATE:
            src[start : start + count] = np.arange(k, k + count)
            runs.append((k, int(s), int(count)))
            k += count
    return kinds, src, runs, k


def overlay_patch_plain(base, priv, kinds, src):
    """Plain PyTorch version: page ``i`` of the output is
    ``priv[clip(src[i], 0, n_priv-1)]`` if PRIVATE, ``base[i]`` if BASE,
    zeros otherwise (one zero dummy page stands in when ``n_priv == 0``)."""
    n_pages, page = base.shape
    if priv.shape[0] == 0:
        priv = torch.zeros((1, page), dtype=priv.dtype, device=priv.device)
    gathered = priv[src.long().clamp(0, priv.shape[0] - 1)]
    k = kinds[:, None]
    zero = torch.zeros((), dtype=base.dtype, device=base.device)
    return torch.where(
        k == KIND_PRIVATE, gathered, torch.where(k == KIND_BASE, base, zero)
    )


def overlay_patch(base: torch.Tensor, priv: torch.Tensor,
                  kinds: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(n_pages, page_elems) patched output, on the inputs' device."""
    if base.device.type == "cpu":
        return overlay_patch_plain(base, priv, kinds, src)
    if base.device.type != "cuda":
        raise ValueError(f"overlay_patch: unsupported device {base.device}")
    native.check_inputs("overlay_patch", base, priv, kinds, src)
    if base.dim() != 2 or priv.dim() != 2 or priv.shape[1] != base.shape[1]:
        raise ValueError(
            f"overlay_patch: base {tuple(base.shape)} / priv {tuple(priv.shape)}"
        )
    if priv.dtype != base.dtype:
        raise ValueError(f"overlay_patch: dtypes {priv.dtype} and {base.dtype}")
    n_pages = base.shape[0]
    if kinds.dtype != torch.int32 or src.dtype != torch.int32 or \
            kinds.shape != (n_pages,) or src.shape != (n_pages,):
        raise ValueError("overlay_patch: kinds/src must be int32 (n_pages,)")
    out = torch.empty_like(base)
    if n_pages == 0:
        return out
    lib = native.library()
    with torch.cuda.device(base.device):
        err = lib.rt_overlay_patch(
            ctypes.c_void_p(base.data_ptr()), ctypes.c_void_p(priv.data_ptr()),
            ctypes.c_void_p(kinds.data_ptr()), ctypes.c_void_p(src.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            n_pages, base.shape[1] * base.element_size(), priv.shape[0],
            ctypes.c_void_p(native.stream_of(base)),
        )
    native.check(err, "overlay_patch")
    LAUNCHES.add()
    return out
