"""Modality frontends, stubs as in ``repro.models.frontends``: the caller
provides precomputed patch or frame embeddings; only the transformer
backbone is real.  The embeddings are drawn from an explicit
``torch.Generator`` where the reference takes a jax key, so their values
differ between the packages; tests pass the same numpy arrays to both."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def overlay_patches(x: torch.Tensor, patch_embeds: torch.Tensor) -> torch.Tensor:
    """Overlay vision patch embeddings on the sequence front (VLM stub)."""
    P = patch_embeds.shape[1]
    return torch.cat([x[:, :P] + patch_embeds, x[:, P:]], dim=1)


def _normal(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 0.02) drawn on the generator's own device, then put on
    ``device`` (None: the card)."""
    a = torch.randn(shape, generator=generator, device=generator.device) * 0.02
    return a.to(device=resolve_device(device), dtype=dtype)


def make_patch_embeds(generator: torch.Generator, batch: int, n_patches: int, d_model: int,
                      dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return _normal(generator, (batch, n_patches, d_model), dtype, device)


def make_frame_embeds(generator: torch.Generator, batch: int, seq: int, d_model: int,
                      dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """EnCodec frame embeddings stub (audio decoder input)."""
    return _normal(generator, (batch, seq, d_model), dtype, device)


def mrope_positions(batch: int, seq: int, n_patches: int, grid: int = 16) -> np.ndarray:
    """(3, B, S) t/h/w position ids: image tokens get a 2-D grid at t=0;
    text tokens get equal t=h=w positions (qwen2-vl convention, stubbed)."""
    t = np.arange(seq, dtype=np.int32)
    h = t.copy()
    w = t.copy()
    n = min(n_patches, seq)
    ij = np.arange(n, dtype=np.int32)
    t[:n] = 0
    h[:n] = ij // grid
    w[:n] = ij % grid
    # text positions continue after the image box
    t[n:] = np.arange(seq - n, dtype=np.int32) + grid
    h[n:] = t[n:]
    w[n:] = t[n:]
    pos = np.stack([t, h, w])  # (3, S)
    return np.broadcast_to(pos[:, None, :], (3, batch, seq)).copy()
