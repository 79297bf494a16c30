"""Warm-state handoff: move a WARM instance between nodes without a cold
start.

Scale-in is where keep-alive policies quietly pay: draining a node evicts
its warm instances, and the next request for each of them is a full cold
restore somewhere else.  This module converts that eviction into a
*handoff*:

1. wait for the source instance to be WARM and idle (an in-flight
   invocation always completes first — handoff never interrupts work);
2. snapshot the live warm tree as a DELTA against the function's own
   published image (:meth:`FunctionCatalog.publish_handoff`, built on
   :func:`repro_torch.core.delta_snapshot`).  Warm generation is read-only over
   the restored tree, so the delta's private payload is the dirty warm
   state only — typically KBs against a multi-MB image;
3. restore it on the successor node through the ordinary invocation path
   (``Invocation(prewarm=True, jif_override=<handoff jif>)``): admission,
   QoS ordering, restore joining, chunk-CAS dedup and peer fetch all apply
   unchanged, and the restore is accounted a ``speculative_restore``,
   never a demand cold start;
4. repoint the router's sticky replica map at the successor and evict the
   source (its ledger returns to pre-restore residency), then retire the
   handoff image's CAS refs.

The destination reads the delta's private chunks plus whatever base chunks
it does not already hold — and because the base image was published into
the cluster CAS, those are peer-fetchable rather than re-read from the
image store.  ``HandoffStats.delta_bytes`` vs ``restore_read_bytes`` is
exactly the wire saving the scale benchmark asserts on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.instance import InstanceState
from repro_torch.serve.invocation import Invocation, QosClass
from repro_torch.serve.node import NodeScheduler

__all__ = ["HandoffStats", "handoff_warm", "wait_idle_warm"]


@dataclasses.dataclass
class HandoffStats:
    """One handoff's outcome and cost breakdown."""

    function: str
    src: str
    dst: str
    ok: bool = False
    reason: str = ""  # failure diagnostics ("" on success)
    delta_bytes: int = 0        # handoff image wire cost (private payload)
    total_bytes: int = 0        # logical bytes of the warm state tree
    restore_read_bytes: int = 0  # bytes the destination read to go WARM
    wait_s: float = 0.0      # waiting out WARMING / in-flight work
    snapshot_s: float = 0.0  # delta snapshot + CAS ingest
    restore_s: float = 0.0   # destination restore (submit -> WARM)


def _tree_nbytes(tree) -> int:
    """Logical bytes of a (possibly nested) state tree of numpy arrays or
    torch tensors (both carry ``nbytes``)."""
    total, stack = 0, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "nbytes"):
            total += int(x.nbytes)
    return total


def wait_idle_warm(
    node: NodeScheduler, fname: str, timeout: float = 60.0
) -> bool:
    """Block until ``fname``'s instance on ``node`` is WARM with no
    invocation in flight.  WARMING (residual stream live) and RUNNING
    (generation in progress) both resolve by waiting; EVICTED or a missing
    instance fails fast."""
    inst = node.instance(fname)
    if inst is None:
        return False
    deadline = time.monotonic() + timeout
    with inst.cond:
        while True:
            if inst.state is InstanceState.WARM and inst.idle:
                return True
            if inst.state is InstanceState.EVICTED:
                return False
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            # in-flight counts change without a cond notification; poll in
            # short beats so an idle edge is seen within ~10ms
            inst.cond.wait(min(remaining, 0.01))


def handoff_warm(
    router,
    fname: str,
    src_name: str,
    dst_name: str,
    *,
    handoff_dir: str,
    cfg: Optional[ModelConfig] = None,
    timeout: float = 60.0,
    simulate_read_bw: Optional[float] = None,
    qos: QosClass = QosClass.STANDARD,
    evict_source: bool = True,
    retire: bool = True,
    charge_source: bool = True,
) -> HandoffStats:
    """Hand one WARM function from ``src_name`` to ``dst_name`` through
    ``router`` (a :class:`~repro_torch.serve.cluster.ClusterRouter`).

    Returns :class:`HandoffStats` with ``ok=False`` + ``reason`` instead of
    raising on the recoverable failures (source never went idle, source
    evicted under memory pressure mid-wait, destination rejected the
    restore) — the caller falls back to plain eviction.  ``cfg`` defaults
    to the source instance's config (bench-reduced variants are not in the
    named-arch table, so the destination could not look it up).
    ``charge_source=False`` skips charging the snapshot writer's state copy
    as scratch against the source ledger (useful when draining a node that
    is itself under pressure)."""
    src = router.node(src_name)
    dst = router.node(dst_name)
    st = HandoffStats(function=fname, src=src_name, dst=dst_name)
    t0 = time.perf_counter()
    if not wait_idle_warm(src, fname, timeout):
        st.reason = "source instance not WARM+idle within timeout"
        return st
    st.wait_s = time.perf_counter() - t0
    inst = src.instance(fname)
    if cfg is None and inst is not None:
        cfg = inst.cfg
    # host copy of the live tree (None if a racing eviction won — with the
    # node draining, only the pressure reclaim ladder can do that)
    state = src.warm_state(fname)
    if state is None:
        st.reason = "source warm state vanished before snapshot"
        return st
    st.total_bytes = _tree_nbytes(state)

    t1 = time.perf_counter()
    path, sstats = router.catalog.publish_handoff(
        fname, state, handoff_dir,
        memory=src.memory if charge_source else None,
    )
    st.snapshot_s = time.perf_counter() - t1
    st.delta_bytes = int(sstats.private_bytes)

    t2 = time.perf_counter()
    try:
        handle = dst.submit_invocation(Invocation(
            function=fname,
            prompt=None,
            max_new_tokens=0,
            cfg=cfg,
            qos=qos,
            prewarm=True,  # restore+promote, skip generation; accounted a
            # speculative_restore — a handoff is never a demand cold start
            simulate_read_bw=simulate_read_bw,
            jif_override=path,
        ))
        result = handle.result(timeout=timeout)
    except Exception as exc:  # Overloaded/DeadlineExceeded/restore errors
        st.reason = f"destination restore failed: {exc!r}"
        if retire:
            router.catalog.retire_handoff(fname, path)
        return st
    st.restore_s = time.perf_counter() - t2
    if result.stats:
        st.restore_read_bytes = int(result.stats.get("bytes_read", 0))

    # successor is WARM: repoint sticky routing, then release the source
    router.reassign(
        fname, to_name=dst_name,
        from_name=src_name if evict_source else None,
    )
    if evict_source:
        src.evict(fname)
    if retire:
        router.catalog.retire_handoff(fname, path)
    st.ok = True
    return st
