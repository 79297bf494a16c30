"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit).  A roofline or MFU share is stated against these,
with the card's power limit beside it."""

F32_FLOPS = 67e12      # float32 outside the tensor cores (TF32 is off)
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the larger of the
    operations over the f32 peak and the bytes over the memory bandwidth."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
