"""Device resolution for every entry point of the port.

``device=None`` means the GPU: an entry point that finds no card raises,
naming the device it wanted, instead of quietly running on the host.  The
CPU runs only when a caller asks for it (``device="cpu"``), as the tests do.

The reference computes in full f32, so TF32 stays off for matrix products
and convolutions alike.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if the requested CUDA device is absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for all work queued on ``device`` (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
