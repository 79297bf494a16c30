"""The grouped expert MLP of a dropless MoE layer (K5).

:func:`moe_experts` takes the layer's (token, choice) pairs routed to the
experts held here, sorted by expert: ``tok`` the token of each pair,
``gate`` its gate, ``offsets`` (E + 1) where expert ``e``'s pairs are
``[offsets[e], offsets[e + 1])`` (pairs past ``offsets[E]`` are ignored),
and adds, into ``out`` (T, d), ``gate * (silu(x W_g,e) * x W_u,e) W_d,e``
for each pair's token row of ``x`` (T, d).  The expert weights are
``(E, d, f)``, ``(E, d, f)`` and ``(E, f, d)``.  Nothing is padded to a
capacity and no pair is dropped; the counts stay on the device.

A CUDA tensor goes to the hand-written kernel (``csrc/moe_experts.cu``):
one launch for gate and up with the ``silu * up`` epilogue into a
(pairs, f) scratch, one for down with the gate weight and the scatter-add
into ``out``, both in f32 on the CUDA cores (IEEE products, no TF32).  A
CPU tensor goes to :func:`moe_experts_plain`, one expert after another;
a ``meta`` tensor is checked as on the card and returns ``out``.
:func:`cost` counts the call's least work.

:data:`PAIRS` counts, always on, the pairs the MoE layers routed
(``routed``, on the host) and those computed here (``held()``, added to on
the device by the kernel, read with a synchronize); ``elsewhere()`` is the
pairs routed to experts held on other chips.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import native
from repro_torch.launch.hlo_analysis import costed

LAUNCHES = native.LaunchCounter("moe_experts")
BM, BN, BK = 64, 64, 16  # the kernel's tile: pairs, output columns, reduction (csrc)


class PairCounter:
    """The (token, choice) pairs the MoE layers routed, and how many of
    them were computed here."""

    def __init__(self):
        self.routed = 0
        self._held: Dict[torch.device, torch.Tensor] = {}
        self._lock = threading.Lock()

    def buffer(self, dev: torch.device) -> torch.Tensor:
        """The int64 count of held pairs on ``dev``, which K5 adds to."""
        buf = self._held.get(dev)
        if buf is None:
            with self._lock:
                buf = self._held.setdefault(dev, torch.zeros(1, dtype=torch.int64, device=dev))
        return buf

    def add_routed(self, n: int) -> None:
        with self._lock:
            self.routed += n

    def add_held(self, dev: torch.device, n) -> None:
        buf = self.buffer(dev)
        with self._lock:
            buf.add_(n)

    def held(self) -> int:
        return sum(int(b.item()) for b in list(self._held.values()))

    def elsewhere(self) -> int:
        return self.routed - self.held()


PAIRS = PairCounter()


def moe_experts_plain(x, tok, gate, offsets, w_gate, w_up, w_down, out):
    """Plain PyTorch version, one held expert after another."""
    off = offsets.tolist()
    for e in range(len(off) - 1):
        a, b = off[e], off[e + 1]
        if a == b:
            continue
        t = tok[a:b].long()
        h = x[t]
        y = (F.silu(h @ w_gate[e]) * (h @ w_up[e])) @ w_down[e]
        out.index_add_(0, t, y * gate[a:b, None])
    return out


def cost(x, tok, gate, offsets, w_gate, w_up, w_down, out):
    """(flops, bytes): 2 d f flops a pair for each of gate, up and down;
    the weights of each expert that has a pair read once, each token row
    with a pair read from ``x`` once and read and written in ``out`` once,
    and a token index and a gate a pair.  The counts are read from the
    routing (a synchronize); on ``meta`` every expert and pair counts."""
    E, d, f = w_gate.shape
    if offsets.device.type == "meta":
        pairs, touched, rows = min(tok.numel(), x.shape[0] * E), E, x.shape[0]
    else:
        off = offsets.tolist()
        pairs = off[-1]
        touched = sum(b > a for a, b in zip(off, off[1:]))
        rows = int(tok[:pairs].unique().numel())
    item = x.element_size()
    return 6 * d * f * pairs, item * (3 * d * f * touched + 3 * d * rows) + 8 * pairs


@costed("moe_experts", cost)
def moe_experts(x: torch.Tensor, tok: torch.Tensor, gate: torch.Tensor, offsets: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """``out[tok[r]] += gate[r] * E_e(x[tok[r]])`` for every sorted pair ``r
    < offsets[E]`` of expert ``e``; returns ``out``.  On the card every
    tensor is contiguous and f32 (``tok`` and ``offsets`` int32), ``x``,
    ``out`` and the weights start 16-byte aligned, and d and f are
    multiples of 64."""
    if x.device.type == "cpu":
        moe_experts_plain(x, tok, gate, offsets, w_gate, w_up, w_down, out)
        PAIRS.add_held(x.device, offsets[-1])
        return out
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_experts: unsupported device {x.device}")
    T, d = x.shape
    E, _, f = w_gate.shape
    dev = x.device
    tensors = (x, tok, gate, offsets, w_gate, w_up, w_down, out)
    if (any(t.device != dev or not t.is_contiguous() for t in tensors)
            or any(t.dtype != torch.float32 for t in (x, gate, w_gate, w_up, w_down, out))
            or tok.dtype != torch.int32 or offsets.dtype != torch.int32
            or w_gate.shape != (E, d, f) or w_up.shape != (E, d, f) or w_down.shape != (E, f, d)
            or out.shape != (T, d) or offsets.shape != (E + 1,) or gate.shape != tok.shape
            or tok.dim() != 1 or d % BN or f % BN or E == 0
            or (dev.type == "cuda"
                and any(t.data_ptr() & 15 for t in (x, w_gate, w_up, w_down, out)))):
        raise ValueError(
            f"moe_experts: x {tuple(x.shape)} {x.dtype}, tok {tuple(tok.shape)} {tok.dtype}, "
            f"gate {tuple(gate.shape)}, offsets {tuple(offsets.shape)} {offsets.dtype}, "
            f"weights {tuple(w_gate.shape)} {tuple(w_up.shape)} {tuple(w_down.shape)}, out "
            f"{tuple(out.shape)} (one device, contiguous, f32, int32 indices, d and f "
            f"multiples of {BN})"
        )
    if dev.type == "meta":  # shapes only: the checks above, no launch
        return out
    rows = min(tok.numel(), T * E)  # the most pairs the held experts can have
    if rows == 0:
        return out
    h = torch.empty((rows, f), dtype=torch.float32, device=dev)
    native.launch(
        "rt_moe_experts", dev, x.data_ptr(), tok.data_ptr(), gate.data_ptr(),
        offsets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        h.data_ptr(), out.data_ptr(), PAIRS.buffer(dev).data_ptr(), d, f, E, rows,
    )
    LAUNCHES.add()
    return out
