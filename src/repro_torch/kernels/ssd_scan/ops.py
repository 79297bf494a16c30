"""Mamba2 SSD scan: ``y`` and the final state of the selective SSM.

:func:`ssd_scan` keeps the TPU kernel's contract: ``x (B, S, H, P)``
already times dt, ``a = dt * A`` as ``(B, H, S)`` in f32, ``Bm``/``Cm
(B, S, G, N)`` (head h reads group ``h // (H / G)``); it returns ``y`` in
``x``'s dtype and the final state ``(B, H, P, N)`` in f32.  ``chunk`` keeps
the reference's contract (``S`` must divide into ``min(chunk, S)``).

A CUDA tensor goes to the hand-written kernel (``csrc/ssd_scan.cu``): the
chunked SSD form at its own chunk of :data:`KERNEL_CHUNK` tokens, parallel
over chunks, with the chunk states passed on in one sequential elementwise
pass through an f32 scratch; a prompt of one chunk takes one launch and no
scratch.  It reads strided views (the conv output's ``B``/``C`` slices, a
transposed ``a``) whose last dimension is contiguous.  A CPU tensor goes
to :func:`ssd_scan_plain`, the chunked einsum form of
``repro_torch.models.mamba2.ssd`` at the caller's chunk;
:func:`ssd_scan_chunked_plain` models the kernel's own chunking.  A
``meta`` tensor is checked as on the card and gets empty results.
:func:`cost` counts the function's least work, which a recorder of
``repro_torch.launch.hlo_analysis`` takes in place of the ops that run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import native
from repro_torch.launch.hlo_analysis import costed

LAUNCHES = native.LaunchCounter("ssd_scan")
MAX_N = 256  # the largest state size the kernel takes
KERNEL_CHUNK = 64  # the kernel's chunk L (csrc/ssd_scan.cu)
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


def ssd_scan_chunked_plain(x, a, Bm, Cm, l: int = KERNEL_CHUNK):
    """The kernel's chunking in plain PyTorch, for the tests: ``S``
    zero-padded up to a multiple of ``l`` (a zero token changes neither the
    state nor the real tokens' y), the plain steps at chunk ``l``, y cut
    back to ``S``."""
    S = x.shape[1]
    pad = -S % l
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        a = F.pad(a, (0, pad))
    y, state = ssd_scan_plain(x, a, Bm, Cm, l)
    return y[:, :S], state


def cost(x, a, Bm, Cm, *, chunk: int = 128):
    """(flops, bytes): x, a, B and C read once, y and the f32 final state
    written once; the recurrence's 4 B S H P N flops, the least the
    function needs."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    state = B * H * P * N * 4
    return 4 * B * S * H * P * N, 2 * x.nbytes + a.nbytes + Bm.nbytes + Cm.nbytes + state


@costed("ssd_scan", cost)
def ssd_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             *, chunk: int = 128):
    """(B, S, H, P), (B, H, S), (B, S, G, N) x 2 -> (y, final_state)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    chunk_len(chunk, S)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, Bm, Cm, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    dev = x.device
    xs, bs, cs = x.stride(), Bm.stride(), Cm.stride()
    # one pass of plain comparisons: this wrapper runs once a Mamba2 layer
    if (a.shape != (B, H, S) or Bm.shape != (B, S, G, N) or Cm.shape != Bm.shape
            or G == 0 or H % G or a.device != dev or Bm.device != dev or Cm.device != dev
            or (xs[3] != 1 and P > 1) or (bs[3] != 1 and N > 1) or (cs[3] != 1 and N > 1)):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, a {tuple(a.shape)}, B {tuple(Bm.shape)}, "
            f"C {tuple(Cm.shape)} (one device; x, B and C with a contiguous last dimension)"
        )
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: a must be f32, got {a.dtype}")
    if N > MAX_N:
        raise ValueError(f"ssd_scan: state size {N} > {MAX_N}")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    if dev.type == "meta":  # shapes only: the checks above, no launch
        return y, state
    nc = -(-S // KERNEL_CHUNK)
    scratch = csum = None
    if nc > 1:  # chunk states, then s_in in place; each chunk's total decay
        scratch = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=dev)
        csum = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    native.launch(
        "rt_ssd_scan", dev, _DTYPES[x.dtype], x.data_ptr(), a.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if scratch is None else scratch.data_ptr(), None if csum is None else csum.data_ptr(),
        *xs[:3], *a.stride(), *bs[:3], *cs[:3], B, S, H, G, P, N,
    )
    LAUNCHES.add()
    return y, state
