"""Snapshot writer: state -> JIF — compatibility wrapper.

The actual writer is the staged :class:`repro_torch.core.lifecycle.SnapshotPipeline`
(trim → classify → relocate → write, §4.1); this free function keeps the
seed's call surface for tests, benchmarks, and the fine-tune manager.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import overlay
from repro_torch.core.lifecycle import SnapshotPipeline, SnapshotStats

__all__ = ["snapshot", "SnapshotStats"]


def snapshot(
    state,
    path: str,
    *,
    base=None,
    parent: Optional[str] = None,
    access_order: Optional[List[str]] = None,
    working_set: Optional[List[str]] = None,
    page_size: int = overlay.DEFAULT_PAGE,
    meta: Optional[Dict[str, Any]] = None,
    trim_fn: Optional[Callable] = None,
    node_cache=None,
    memory=None,
) -> SnapshotStats:
    return SnapshotPipeline(
        page_size=page_size, trim_fn=trim_fn, node_cache=node_cache,
        memory=memory,
    ).run(
        state,
        path,
        base=base,
        parent=parent,
        access_order=access_order,
        working_set=working_set,
        meta=meta,
    )
