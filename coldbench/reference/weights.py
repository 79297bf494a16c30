"""Seeded weights, drawn on the device in a few large calls.

A model's leaves are described by its reference module's ``leaf_specs``
(a tree of :class:`Leaf`), in the stacked tree the program takes as input:
``{"embed": {...}, "pattern": ({...},), "remainder": (), "final_norm"}``,
every leaf of the pattern stacked over the layers.  :func:`draw` walks
that tree in order from one ``torch.Generator`` seeded with the run's
seed, so a seed gives the same weights on every run, and the program and
the reference both get them.

Distributions follow the port's ``lm.init_params`` (N(0, 0.02) for
embeddings and convolutions, N(0, 1 / fan-in) over the second-to-last
dimension for projections, log U[1, 16) for ``A_log``), except that biases
and norm scales are drawn off their initial 0 and 1, as in a trained
model: an all-zero bias or an all-one scale would leave the arithmetic
that reads it unchecked.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

SPREAD = 0.02  # of embeddings, convolutions, biases and norm scales


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    init: str  # "normal" | "fanin" | "bias" | "scale" | "log_uniform"


def draw(specs, seed: int, device, dtype=torch.float32):
    """The tree of ``specs`` as tensors on ``device``, drawn from ``seed``
    (any whole number; reduced modulo 2**63)."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def one(leaf: Leaf) -> torch.Tensor:
        a = torch.empty(leaf.shape, dtype=torch.float32, device=device)
        if leaf.init == "log_uniform":
            a.uniform_(1.0, 16.0, generator=g).log_()
        elif leaf.init == "fanin":
            a.normal_(0.0, leaf.shape[-2] ** -0.5, generator=g)
        elif leaf.init == "scale":
            a.normal_(1.0, SPREAD, generator=g)
        elif leaf.init in ("normal", "bias"):
            a.normal_(0.0, SPREAD, generator=g)
        else:
            raise ValueError(f"unknown init {leaf.init!r}")
        return a.to(dtype)

    def walk(node):
        if isinstance(node, Leaf):
            return one(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tuple(walk(v) for v in node)

    return walk(specs)


def leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf, in draw order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def per_layer(params, n_pattern: int, reps: int):
    """Layer ``i``'s leaves of a stacked tree, for each layer in the order
    the stack runs them (pattern position ``i % n_pattern``, rep ``i //
    n_pattern``; the remainder follows)."""
    def take(tree, r):
        if isinstance(tree, dict):
            return {k: take(v, r) for k, v in tree.items()}
        return tree[r]

    out = [take(params["pattern"][i], r) for r in range(reps) for i in range(n_pattern)]
    return out + list(params["remainder"])
