"""State-tree (de)serialization helpers.

A *state* is a nested dict/list/tuple of array leaves. We flatten it to
``(name, leaf)`` pairs with slash-joined path names and a JSON-able structure
descriptor, so restore can rebuild the exact pytree in one batched pass — the
metadata-restore analogue of the paper's "no syscall replay".
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def flatten_state(tree) -> Tuple[List[Tuple[str, np.ndarray]], Any]:
    leaves: List[Tuple[str, np.ndarray]] = []
    desc = _walk(tree, (), leaves)
    return leaves, desc


def _walk(node, path, leaves):
    # a module-level function: a nested one that calls itself is a closure
    # cycle that keeps ``leaves`` alive until Python's cyclic collector runs
    if isinstance(node, dict):
        keys = sorted(node.keys())
        return {"t": "dict", "k": keys,
                "c": [_walk(node[k], path + (str(k),), leaves) for k in keys]}
    if isinstance(node, (list, tuple)):
        return {
            "t": "list" if isinstance(node, list) else "tuple",
            "c": [_walk(v, path + (str(i),), leaves) for i, v in enumerate(node)],
        }
    name = "/".join(path) if path else "_root"
    # torch tensors stay tensors (a device tensor, or a bf16 one, has no
    # numpy form without a copy); use leaf_bytes() for their raw bytes
    arr = node if isinstance(node, torch.Tensor) else np.asarray(node)
    leaves.append((name, arr))
    return {"t": "leaf", "n": name}


def unflatten_state(desc, leaves: Dict[str, Any]):
    if desc["t"] == "dict":
        return {k: unflatten_state(c, leaves) for k, c in zip(desc["k"], desc["c"])}
    if desc["t"] == "list":
        return [unflatten_state(c, leaves) for c in desc["c"]]
    if desc["t"] == "tuple":
        return tuple(unflatten_state(c, leaves) for c in desc["c"])
    return leaves[desc["n"]]


def leaf_names(desc) -> List[str]:
    out: List[str] = []

    def walk(d):
        if d["t"] == "leaf":
            out.append(d["n"])
        else:
            for c in d["c"]:
                walk(c)

    walk(desc)
    return out


def leaf_bytes(arr) -> np.ndarray:
    """A flattened leaf's raw bytes as a flat uint8 numpy array (a view
    where the leaf is a contiguous host array or CPU tensor)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().reshape(-1)
        if t.numel() == 0:  # may have stride 0 (from numpy), which view refuses
            return np.empty(0, np.uint8)
        return t.view(torch.uint8).cpu().numpy()
    return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
