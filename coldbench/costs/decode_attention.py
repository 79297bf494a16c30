"""K3 (decode attention) work per call, frozen from the port's
``src/repro_torch/kernels/decode_attention/ops.py`` ``cost``: q read and
the output written once, the ``pos + 1`` valid slots of the cache read
once (all ``Sc`` slots once ``pos >= Sc - 1``, as in every decode step of
a prefill's clamped cache), 4 hd flops a slot and head."""


def call_work(B: int, H: int, kvH: int, hd: int, Sc: int, pos: int, itemsize: int = 4):
    """(flops, bytes) of one call."""
    n_valid = min(Sc, pos + 1)
    q = B * H * hd * itemsize
    cache = 2 * B * kvH * Sc * hd * itemsize
    return 4 * hd * n_valid * B * H, 2 * q + cache * n_valid // Sc
