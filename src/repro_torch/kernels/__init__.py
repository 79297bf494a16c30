"""Hand-written Hopper kernels for the serving path, each beside its plain
PyTorch version.  Sources live in ``repro_torch/csrc/``; ``native`` builds
them with ``nvcc`` at first use and loads the library with ``ctypes``.

- overlay_patch:    the Overlay-VMA mechanism on the device (fused install)
- flash_attention:  causal / windowed attention for prefill
- decode_attention: flash decoding over the KV cache, GQA and int8 KV
"""
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.overlay_patch.ops import (
    compact_plan_from_itable,
    overlay_patch,
    plan_from_itable,
)


def launch_counters():
    """name -> LaunchCounter of every kernel on the serving path."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.overlay_patch import ops as op

    return {c.name: c for c in (op.LAUNCHES, fa.LAUNCHES, da.LAUNCHES)}


__all__ = [
    "overlay_patch",
    "plan_from_itable",
    "compact_plan_from_itable",
    "flash_attention",
    "decode_attention",
    "launch_counters",
]
