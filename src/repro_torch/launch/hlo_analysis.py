"""The op and collective record of one step, the counterpart of
``repro.launch.hlo_analysis``.

The port has no compiler and so no HLO to parse.  It analyses a record of
what one eager run of the step executes instead: :class:`StepRecorder`, a
``TorchDispatchMode``, sees every aten op of the step, on ``meta`` tensors
as on the card.

- **FLOPs** come from ``torch.utils.flop_counter``'s registry: matmuls,
  convolutions and attention ops.  Elementwise ops count none, where XLA's
  cost analysis counts them too.
- **Bytes** count each op's tensor operands once (read) and its fresh
  outputs once (written).  A view counts nothing; a tensor an op writes in
  place counts once, as an operand; a table looked up (``aten.embedding``)
  counts the rows it returns.
- **Kernels** (K1-K4) count their own ``cost`` (``kernels/*/ops.py``): the
  wrapper reports it through :func:`costed`, and the recorder counts no
  aten op while the wrapper runs, whichever version runs.  So a kernel
  counts the same on every device: not the plain version's dense S x S
  einsum on the CPU, and not nothing for an opaque launch on the card.
- **Collectives** of ``repro_torch.sharding.collectives`` report (kind,
  dtype, shape, group size) through :func:`collective`; the group size is
  known there and not on the ``c10d`` op.  A ``c10d`` op that arrives with
  no such record fails the trace, and so does a record whose op never
  arrives.  The edges of ``shard_map`` (each global view cut to this rank's
  block on entry, each output block gathered back on exit) report ``view``
  records: the port's global-view design makes them, ``jax.shard_map`` does
  not, and :func:`collective_bytes` leaves them out.

Each op is tagged with its scope: ``"global"`` (a global view, outside
every ``shard_map`` body), ``"region"`` (a per-rank block inside one) or
``"edge"`` (the edges' own cuts and concatenations).  Autograd runs a
body's backward ops after the body has returned, so they count as
``"global"``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

DTYPE_BYTES = {
    torch.float64: 8, torch.int64: 8, torch.uint64: 8, torch.complex64: 8,
    torch.complex128: 16,
    torch.float32: 4, torch.int32: 4, torch.uint32: 4,
    torch.bfloat16: 2, torch.float16: 2, torch.int16: 2, torch.uint16: 2,
    torch.int8: 1, torch.uint8: 1, torch.bool: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1, torch.float8_e4m3fnuz: 1,
    torch.float8_e5m2fnuz: 1,
}

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# ops that move no bytes: allocations, and reshapes whose schema claims a
# fresh tensor (every op whose outputs all alias an input is a view too)
_ALLOC = {"aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
          "aten.new_empty_strided"}
_VIEWS = {"aten._unsafe_view", "aten.lift_fresh"}
_LOOKUPS = {"aten.embedding"}  # operand 0 is a table read only at the rows returned

_STACK: List["StepRecorder"] = []  # the active recorders, innermost last


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, t.element_size())


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


CLASSES = ("param", "cache", "act", "split")


class StepRecorder(TorchDispatchMode):
    """Records one step.  ``params`` and ``caches`` are trees of the step's
    parameter (and optimizer-state) and cache tensors.  Every byte is
    counted under the class of the tensor it belongs to:

    - ``param`` and ``cache``: those trees, and a copy made of them alone
      (a weight cast to the compute dtype, the decode step's restack);
    - ``split``: an activation the rules split over ``model`` (heads, ff,
      vocab): the output of a GEMM with a weight whose activation operand
      is not split (column-parallel), of a GEMM without a weight over a
      split operand (attention scores), of a kernel, and whatever an op
      makes from a split operand; a GEMM with a weight over a split operand
      (row-parallel) gives a whole one;
    - ``act``: every other activation.

    A tensor's class is set when an op makes it, so a storage freed and
    made again is never read with a stale class.

    ``ops[(scope, op)]`` holds [calls, flops, then bytes by class in
    :data:`CLASSES` order]; ``kernels[(scope, name)]`` [calls, flops,
    bytes]; ``collectives`` one dict per collective."""

    def __init__(self, params=None, caches=None):
        super().__init__()
        self.ops: Dict = defaultdict(lambda: [0, 0, 0, 0, 0, 0])
        self.kernels: Dict = defaultdict(lambda: [0, 0, 0])
        self.collectives: List[Dict] = []
        self.scope = "global"
        self._paused = 0
        self._pending = 0
        self._class: Dict[int, str] = {}
        for cls, tree in (("param", params), ("cache", caches)):
            self.mark(tree, cls)

    def mark(self, tree, cls: str) -> None:
        for t in _tensors(tree):
            self._class[_storage(t)] = cls

    # ------------------------------------------------------------ the mode
    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STACK.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            if self._pending <= 0:
                raise RuntimeError(f"{func} ran with no collective record: a collective "
                                   "outside repro_torch.sharding.collectives")
            self._pending -= 1
            return out
        if self._paused:
            return out
        returns = func._schema.returns
        name = str(func.overloadpacket)
        if name in _VIEWS or (returns and all(
                r.alias_info is not None and not r.alias_info.is_write for r in returns)):
            return out
        outs = [out] if len(returns) == 1 else list(out or ())
        fresh = [t for r, o in zip(returns, outs) if r.alias_info is None for t in _tensors(o)]
        if name in _ALLOC:
            self.mark(fresh, "act")
            return out
        flops = 0
        registry = _flop_registry()
        if func.overloadpacket in registry:
            flops = int(registry[func.overloadpacket](*args, **kwargs, out_val=out))
        operands = _tensors((args, kwargs))
        seen = [self._class.get(_storage(t), "act") for t in operands]
        split = "split" in seen
        if flops and "param" in seen:
            cls = "act" if split else "split"  # row- or column-parallel
        elif split:
            cls = "split"
        elif not flops and seen and all(c == seen[0] for c in seen) and seen[0] != "split":
            cls = seen[0]  # a copy of params alone, or of caches alone
        else:
            cls = "act"
        self.mark(fresh, cls)
        rec = self.ops[(self.scope, name)]
        rec[0] += 1
        rec[1] += flops
        for i, (t, c) in enumerate(zip(operands, seen)):
            rows = i == 0 and name in _LOOKUPS
            rec[2 + CLASSES.index(c)] += sum(_nbytes(o) for o in fresh) if rows else _nbytes(t)
        rec[2 + CLASSES.index(cls)] += sum(_nbytes(t) for t in fresh)
        return out

    # -------------------------------------------------------------- hooks
    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        rec = self.kernels[(self.scope, name)]
        rec[0] += 1
        rec[1] += int(flops)
        rec[2] += int(nbytes)

    def add_collective(self, kind: str, dtype, shape, group: int, view: bool) -> None:
        self.collectives.append({"kind": kind, "dtype": dtype, "shape": tuple(shape),
                                 "group": int(group), "view": bool(view), "scope": self.scope})
        if kind in KINDS:
            self._pending += 1

    def check_closed(self) -> None:
        """Raise if a recorded collective's ``c10d`` op never arrived."""
        if self._pending:
            raise RuntimeError(f"{self._pending} collective record(s) without a c10d op")

    # ------------------------------------------------------------ totals
    def totals(self, scopes: Iterable[str] = ("global", "region")) -> Dict[str, int]:
        """FLOPs and bytes of the ops and kernels in ``scopes``."""
        scopes = set(scopes)
        out = {"flops": 0, "bytes": 0, "ops": 0, **{f"{c}_bytes": 0 for c in CLASSES},
               "kernel_flops": 0, "kernel_bytes": 0, "kernel_calls": 0}
        for (scope, _), (calls, flops, *by) in self.ops.items():
            if scope in scopes:
                out["ops"] += calls
                out["flops"] += flops
                out["bytes"] += sum(by)
                for c, b in zip(CLASSES, by):
                    out[f"{c}_bytes"] += b
        for (scope, _), (calls, flops, nbytes) in self.kernels.items():
            if scope in scopes:
                out["kernel_calls"] += calls
                out["kernel_flops"] += flops
                out["kernel_bytes"] += nbytes
        out["flops"] += out["kernel_flops"]
        out["bytes"] += out["kernel_bytes"]
        return out

    def kernel_calls(self) -> Dict[str, int]:
        calls: Dict[str, int] = defaultdict(int)
        for (_, name), (n, _, _) in self.kernels.items():
            calls[name] += n
        return dict(calls)


def recorder() -> Optional[StepRecorder]:
    return _STACK[-1] if _STACK else None


def costed(name: str, cost: Callable):
    """Decorate a kernel's public wrapper: under a recorder, report
    ``cost(*args, **kwargs) -> (flops, nbytes)`` and count no aten op (nor
    the wrapper's own nested calls) until the wrapper returns; its outputs
    are ``split`` activations."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = recorder()
            if rec is None or rec._paused:
                return fn(*args, **kwargs)
            flops, nbytes = cost(*args, **kwargs)
            rec.add_kernel(name, flops, nbytes)
            rec._paused += 1
            try:
                result = fn(*args, **kwargs)
            finally:
                rec._paused -= 1
            rec.mark(result, "split")  # per head: split wherever the heads are
            return result

        call.cost = cost
        return call

    return wrap


def collective(kind: str, dtype, shape, group: int, view: bool = False) -> None:
    """Report one collective about to run (``kind`` one of :data:`KINDS`,
    or ``"slice"`` for a ``shard_map`` edge's cut, which moves nothing).
    ``shape`` is the buffer as XLA's HLO shows it: the all-reduced or
    exchanged buffer, the gathered output, the scattered output."""
    rec = recorder()
    if rec is not None:
        rec.add_collective(kind, dtype, shape, group, view)


@contextlib.contextmanager
def scope(name: str):
    """Tag the ops run inside as ``name`` ("region" or "edge")."""
    rec = recorder()
    if rec is None:
        yield
        return
    prev, rec.scope = rec.scope, name
    try:
        yield
    finally:
        rec.scope = prev


def collective_bytes(records: Iterable[Dict], view: bool = False) -> Dict[str, float]:
    """Bytes moved per device, by collective kind (+ ``total`` and
    ``counts``), with the reference's ring factors by group size s:
    all-reduce 2 size (s-1)/s, all-gather size (s-1)/s of the gathered
    buffer, reduce-scatter size (s-1) of the scattered output, all-to-all
    size (s-1)/s, collective-permute size.  Only the records whose ``view``
    flag equals ``view`` count (a ``shard_map`` edge's cut moves nothing).
    A record may carry ``count``, the times it runs."""
    out: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for r in records:
        if bool(r.get("view", False)) != view:
            continue
        op, s, n = r["kind"], r["group"], r.get("count", 1)
        size = math.prod(r["shape"]) * DTYPE_BYTES[r["dtype"]]
        if op == "all-reduce":
            moved = 2.0 * size * (s - 1) / s
        elif op == "all-gather":
            moved = size * (s - 1) / s
        elif op == "reduce-scatter":
            moved = size * (s - 1)
        elif op == "all-to-all":
            moved = size * (s - 1) / s
        elif op == "collective-permute":
            moved = float(size)
        elif op == "slice":
            moved = 0.0
        else:
            raise ValueError(f"unknown collective kind {op!r}")
        out[op] += moved * n
        counts[op] += n
    out["total"] = sum(v for k, v in out.items() if k != "total")
    result = dict(out)
    result["counts"] = dict(counts)  # type: ignore[assignment]
    return result


def op_histogram(rec: StepRecorder, top: int = 20) -> Dict[str, int]:
    """Calls per aten op and kernel over every scope, the most frequent
    ``top`` (a debug aid, as the reference's opcode histogram)."""
    hist: Dict[str, int] = defaultdict(int)
    for (_, name), r in list(rec.ops.items()) + list(rec.kernels.items()):
        hist[name] += r[0]
    return dict(sorted(hist.items(), key=lambda kv: -kv[1])[:top])
