"""Working-set / first-touch-order tracing (the paper's kernel tracing
module, §5): record the order in which execution first touches each tensor,
iterating until the trace is stable, then feed it to the snapshot writer so
the JIF data segment is laid out in access order."""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.treeutil import flatten_state, unflatten_state
from repro_torch.interop import to_numpy


class AccessRecorder:
    """Wrap a state tree so every leaf access is recorded (first touch)."""

    def __init__(self, state):
        self._order: List[str] = []
        self._seen = set()
        self._lock = threading.Lock()
        leaves, self._tree = flatten_state(state)
        self._leaves = dict(leaves)

    def _touch(self, name: str):
        with self._lock:
            if name not in self._seen:
                self._seen.add(name)
                self._order.append(name)

    def view(self):
        rec = self

        class _Proxy(np.ndarray):
            def __array_finalize__(self, obj):
                pass

        def wrap(name, arr):
            class _Lazy:
                """Touch-on-use leaf: coerces to the array on first use."""

                def __init__(self):
                    self.name = name

                def __array__(self, dtype=None, copy=None):
                    rec._touch(name)
                    a = rec._leaves[name]
                    if isinstance(a, torch.Tensor):  # e.g. a warm device tree
                        a = to_numpy(a)
                    return np.asarray(a, dtype=dtype)

                @property
                def shape(self):
                    return rec._leaves[name].shape

                @property
                def dtype(self):
                    return rec._leaves[name].dtype

                @property
                def ndim(self):
                    return rec._leaves[name].ndim

            return _Lazy()

        return unflatten_state(
            self._tree, {n: wrap(n, a) for n, a in self._leaves.items()}
        )

    @property
    def touched(self) -> List[str]:
        """Only the leaves execution actually touched — the traced working
        set; ``order`` appends the untouched stragglers after them."""
        with self._lock:
            return list(self._order)

    @property
    def order(self) -> List[str]:
        with self._lock:
            out = list(self._order)
        rest = [n for n in self._leaves if n not in set(out)]
        return out + rest


def trace_access_order(
    state,
    run_fn: Callable[[Any], None],
    max_iters: int = 3,
    return_touched: bool = False,
):
    """Run ``run_fn(state_view)`` under tracing until the first-touch order
    reaches a fixed point (paper: iterative re-tracing to kill tracer
    artifacts).  With ``return_touched`` also returns the touched-only
    prefix (the traced working set, without untouched stragglers)."""
    prev: Optional[List[str]] = None
    order: List[str] = []
    touched: List[str] = []
    for _ in range(max_iters):
        rec = AccessRecorder(state)
        run_fn(rec.view())
        order = rec.order
        touched = rec.touched
        if order == prev:
            break
        prev = order
    if return_touched:
        return order, touched
    return order


def static_access_order(cfg, params_like) -> List[str]:
    """Structure-derived order: embed -> blocks in execution order -> final
    norm -> unembed. Used when an instrumented run isn't available."""
    leaves, _ = flatten_state(params_like)
    names = [n for n, _ in leaves]

    def rank(n: str):
        if n.startswith("embed/tok"):
            return (0, n)
        if n.startswith("layers/"):
            try:
                return (1 + int(n.split("/")[1]), n)
            except ValueError:
                return (1, n)
        if n.startswith("pattern/"):
            parts = n.split("/")
            try:
                return (1 + int(parts[1]), n)
            except ValueError:
                return (1, n)
        if n.startswith("remainder/"):
            return (10_000, n)
        if n.startswith("final_norm"):
            return (20_000, n)
        if "unembed" in n:
            return (30_000, n)
        return (15_000, n)

    return sorted(names, key=rank)
