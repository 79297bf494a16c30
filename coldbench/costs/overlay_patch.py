"""K1 (overlay patch) work, frozen from the port's
``src/repro_torch/kernels/overlay_patch/ops.py`` ``cost`` and tightened as
the benchmark counts it: every output page written once, each PRIVATE and
BASE page read once, a ZERO page read never, the two int32 page tables
read once.  No arithmetic.

Which tensors K1 patches is the fused install's rule
(``src/repro_torch/core/restore.py`` ``_plan_device``): a tensor with at
least one page that is not PRIVATE; a tensor whose every page is PRIVATE
is copied to the card whole.  Pages are classified as the JIF classifies
them (``src/repro_torch/core/overlay.py`` ``classify``): ZERO where every
byte is 0, else BASE where the bytes equal the base's page, else PRIVATE.
"""
from __future__ import annotations

import torch

PAGE = 64 << 10  # the JIF's page (core/overlay.py DEFAULT_PAGE)


def _pages(t: torch.Tensor) -> torch.Tensor:
    raw = t.detach().contiguous().view(-1).view(torch.uint8)
    pad = -raw.numel() % PAGE
    if pad or raw.numel() == 0:
        raw = torch.cat([raw, raw.new_zeros(pad or PAGE)])
    return raw.view(-1, PAGE)


def tensor_work(t: torch.Tensor, base: torch.Tensor):
    """(patched by K1, bytes K1 moves for it) for one restored tensor."""
    pages, bpages = _pages(t), _pages(base)
    n = pages.shape[0]
    zero = ~pages.any(dim=1)
    same = torch.zeros(n, dtype=torch.bool, device=pages.device)
    m = min(n, bpages.shape[0])
    same[:m] = (pages[:m] == bpages[:m]).all(dim=1)
    private = ~zero & ~same
    n_read = int((~zero).sum())
    patched = int(private.sum()) < n
    return patched, n * PAGE + n_read * PAGE + 2 * 4 * n


def cold_start_work(function_leaves, base_leaves):
    """(K1 launches, bytes) of one cold start: over the restored tensors,
    given as parallel lists of the function's and the base's leaves."""
    launches = nbytes = 0
    for t, b in zip(function_leaves, base_leaves):
        patched, moved = tensor_work(t, b)
        if patched:
            launches += 1
            nbytes += moved
    return launches, nbytes
