"""NVIDIA H100 constants for roofline bounds: the SXM5 80GB part
(``nvidia-smi`` name "NVIDIA H100 80GB HBM3") at its full 700 W power
limit, from NVIDIA's H100 Tensor Core GPU data sheet (dense rates, no
sparsity).  A card set below 700 W runs slower under load; every
measurement names the card's limit beside it.  The reference's TPU v5e
constants are not carried over."""

NAME = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700
PEAK_FLOPS_BF16 = 989e12  # per card, tensor cores, dense
PEAK_FLOPS_F32 = 67e12  # per card, CUDA cores (TF32 is off in the port)
HBM_BW = 3.35e12  # bytes/s per card, HBM3
NVLINK_BW = 900e9  # bytes/s per card to the others of its host (450 each way)
HBM_BYTES = 80 * 10**9  # per card


def bound_ms(nbytes: float, flops: float, dtype: str = "float32"):
    """(least time in ms, what bounds it): bytes over the memory rate;
    operations over the tensor cores' rate in bf16, the CUDA cores' in f32."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / (PEAK_FLOPS_BF16 if dtype == "bfloat16" else PEAK_FLOPS_F32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
