"""K5 (the grouped expert MLP of a dropless MoE layer) work per call,
frozen from the port's ``src/repro_torch/kernels/moe_experts/ops.py``
``cost``: 2 d f flops a pair for each of gate, up and down; the weights of
each held expert that has a pair read once, each token row with a pair
read once and its output row read and written once, a token index and a
gate a pair.

What a call computes depends on the routing.  :func:`expected` gives the
pairs, experts touched and token rows of a call under routing that picks
each token's k experts uniformly among the router's E (what seeded random
router weights give, on average): ``T k held / E`` pairs, each held expert
touched unless all T tokens miss it, a token row unless all its k choices
lie elsewhere."""
from math import comb


def call_work(pairs: float, touched: float, rows: float, d: int, f: int, itemsize: int = 4):
    """(flops, bytes) of one call."""
    return 6 * d * f * pairs, itemsize * (3 * d * f * touched + 3 * d * rows) + 8 * pairs


def expected(T: int, k: int, E: int, held: int):
    """(pairs, experts touched, token rows) of a call over T tokens."""
    pairs = T * k * held / E
    touched = held * (1 - (1 - k / E) ** T)
    rows = T * (1 - comb(E - held, k) / comb(E, k))
    return pairs, touched, rows
