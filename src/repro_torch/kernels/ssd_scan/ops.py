"""Mamba2 SSD scan: ``y`` and the final state of the selective SSM.

:func:`ssd_scan` keeps the TPU kernel's contract: ``x (B, S, H, P)``
already times dt, ``a = dt * A`` as ``(B, H, S)`` in f32, ``Bm``/``Cm
(B, S, G, N)`` (head h reads group ``h // (H / G)``); it returns ``y`` in
``x``'s dtype and the final state ``(B, H, P, N)`` in f32.  ``chunk`` keeps
the reference's contract (``S`` must divide into ``min(chunk, S)``).

A CUDA tensor goes to the hand-written kernel (``csrc/ssd_scan.cu``),
which runs the recurrence token by token; a CPU tensor goes to
:func:`ssd_scan_plain`, the chunked einsum form of
``repro_torch.models.mamba2.ssd``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("ssd_scan")
MAX_N = 256  # state size: N / 32 values per lane, at most 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_len(chunk: int, S: int) -> int:
    """The scan's chunk, ``min(chunk, S)``; ``S`` must divide into it (the
    reference asserts this; prompts are not padded)."""
    c = min(chunk, S)
    if c <= 0 or S % c:
        raise ValueError(f"seq {S} not divisible by chunk {c}")
    return c


def ssd_scan_plain(x, a, Bm, Cm, chunk: int = 128):
    """Plain PyTorch version: the chunked form, with ``a`` as (B, S, H)."""
    from repro_torch.models.mamba2 import ssd  # that module imports this one

    y, state = ssd(x, a.transpose(1, 2), Bm, Cm, chunk)
    return y, state.float()


def ssd_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             *, chunk: int = 128):
    """(B, S, H, P), (B, H, S), (B, S, G, N) x 2 -> (y, final_state)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    chunk_len(chunk, S)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    native.check_inputs("ssd_scan", x, a, Bm, Cm)
    if (a.shape != (B, H, S) or Bm.shape != (B, S, G, N) or Cm.shape != Bm.shape
            or G == 0 or H % G):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, a {tuple(a.shape)}, "
            f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}"
        )
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: a must be f32, got {a.dtype}")
    if N > MAX_N:
        raise ValueError(f"ssd_scan: state size {N} > {MAX_N}")
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    native.launch(
        "rt_ssd_scan", x.device, _DTYPES[x.dtype], x.data_ptr(), a.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, G, P, N,
    )
    LAUNCHES.add()
    return y, state
