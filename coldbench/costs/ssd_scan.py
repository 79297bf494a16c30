"""K4 (SSD scan) work per call, frozen from the port's
``src/repro_torch/kernels/ssd_scan/ops.py`` ``cost``: x, a, B and C read
once, y and the f32 final state written once; the recurrence's
4 B S H P N flops."""


def call_work(B: int, S: int, H: int, P: int, G: int, N: int, itemsize: int = 4):
    """(flops, bytes) of one call (prefill of S tokens, batch B)."""
    x = B * S * H * P * itemsize
    a = B * H * S * 4
    bc = 2 * B * S * G * N * itemsize
    state = B * H * P * N * 4
    return 4 * B * S * H * P * N, 2 * x + a + bc + state
