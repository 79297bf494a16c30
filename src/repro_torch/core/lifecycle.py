"""Snapshot lifecycle pipeline: the paper's §4.1/§5 closed loop, writer side.

The offline JIF preparation is a staged pipeline::

    trim ──▶ classify ──▶ relocate ──▶ write

* **trim** — per-subsystem trimming (the MADV_FREE→DONTNEED / stack-trim
  analogue): caller-supplied rules drop state the function won't need.
* **classify** — chunk classification {ZERO, BASE, PRIVATE} against a digest
  source: an in-memory :class:`BaseImage`, or a **parent JIF on disk** (delta
  snapshots — a fine-tuned warm instance checkpoints only its changed pages;
  JIF v2 parents serve digests straight from the file, v1 parents are
  materialized once through the node cache).
* **relocate** — PRIVATE chunks of the traced working set are laid out
  contiguously at the front of the data segment in first-access order, and
  the ``ws_boundary`` (data-segment chunk where the working set ends) is
  recorded so restore can promote the instance the moment one sequential
  read lands, while the residual streams at background priority.
* **write** — one msgpack header + raw interval tables + raw chunk digests
  + the data segment, atomically (tmp + rename).

The legacy free function :func:`repro_torch.core.snapshot.snapshot` remains as a
thin compatibility wrapper over this pipeline.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import jif, overlay
from repro_torch.core.digest import chunk_digests
from repro_torch.core.treeutil import flatten_state, leaf_bytes
from repro_torch.interop import dtype_name


@dataclasses.dataclass
class SnapshotStats:
    total_bytes: int = 0
    private_bytes: int = 0
    base_bytes: int = 0
    zero_bytes: int = 0
    n_tensors: int = 0
    n_intervals: int = 0
    write_s: float = 0.0
    classify_s: float = 0.0
    ws_boundary: int = 0      # data-segment chunk where the working set ends
    ws_tensors: int = 0       # tensors inside the traced working set
    parent: Optional[str] = None  # parent JIF path for delta snapshots

    @property
    def file_fraction(self) -> float:
        return self.private_bytes / max(self.total_bytes, 1)

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["file_fraction"] = self.file_fraction
        return d


class _Classified:
    """Per-tensor classification artifacts flowing between pipeline stages."""

    __slots__ = ("names", "buffers", "kinds", "itables", "digests", "entries", "treedesc")

    def __init__(self):
        self.names: List[str] = []
        self.buffers: Dict[str, np.ndarray] = {}
        self.kinds: Dict[str, np.ndarray] = {}
        self.itables: Dict[str, np.ndarray] = {}
        self.digests: Dict[str, np.ndarray] = {}
        self.entries: Dict[str, jif.TensorEntry] = {}
        self.treedesc: Any = None


class _JifDigestSource:
    """Digest provider over a parent JIF: v2 parents serve stored digests
    with zero data-segment I/O.  v1 parents try the backfill path first
    (hash straight from the file, persisted sidecar — no BASE chunks means
    no materialization needed); delta v1 parents are materialized once into
    the node cache, and their digests are persisted as a sidecar so the
    NEXT classify against them is zero-I/O too."""

    def __init__(self, reader: jif.JifReader, node_cache=None):
        self._r = reader
        self._img = None
        self._node_cache = node_cache
        if not reader.has_digests:
            try:
                # in-memory backfill: classify must not leave sidecars next
                # to images it merely READ (e.g. checked-in goldens) — the
                # dedup paths (restore with a chunk cache, CAS ingest)
                # persist the sidecar when the image actually participates
                reader.ensure_digests(write_sidecar=False)
                return
            except ValueError:
                pass  # BASE chunks: parent bytes are not in this file
            self._img = _materialize_parent(reader.path, node_cache)
            try:
                reader.write_digest_sidecar({
                    t.name: self._img.digests(t.name)
                    for t in reader.tensors
                    if self._img.digests(t.name) is not None
                })
            except OSError:
                pass  # read-only store: backfill stays in-memory this run

    def digests(self, name: str) -> Optional[np.ndarray]:
        if self._img is not None:
            return self._img.digests(name)
        if name not in self._r.by_name:
            return None
        return self._r.digests(name)


_writer_parent_cache = None  # lazily-built; memoizes v1 parents across calls


def _materialize_parent(path: str, node_cache=None):
    from repro_torch.core.cache import BaseImage, NodeImageCache

    global _writer_parent_cache
    if node_cache is None:
        # memoize across snapshot() calls: a loop of K deltas against one
        # v1 parent must materialize it once, not K times
        if _writer_parent_cache is None:
            _writer_parent_cache = NodeImageCache(capacity_bytes=2 << 30)
        node_cache = _writer_parent_cache
    name = parent_cache_key(path)
    img = node_cache.get(name)
    if img is None:
        img = BaseImage.from_jif(path, name=name, node_cache=node_cache)
        node_cache.put(img)
    return img


def parent_cache_key(path: str) -> str:
    """Node-cache key under which a parent JIF's materialized image lives —
    the writer and the restorer must agree on it.  The key binds the file's
    identity (mtime + size), so a parent rewritten in place (relayout does
    exactly that) gets a fresh key instead of serving stale cached bytes,
    and a restore whose on-disk parent no longer matches the key its child
    was classified against fails loudly instead of corrupting silently."""
    st = os.stat(path)
    return f"jif:{os.path.abspath(path)}#{st.st_mtime_ns:x}.{st.st_size:x}"


def delta_snapshot(
    state,
    path: str,
    parent: str,
    *,
    meta: Optional[Dict[str, Any]] = None,
    node_cache=None,
    memory=None,
) -> SnapshotStats:
    """Snapshot ``state`` as a delta against ``parent`` (a JIF on disk),
    inheriting the parent's access order and working-set boundary.

    This is the warm-state handoff writer: a live WARM instance's tree is
    classified against the function's own published image, so only dirty
    pages land in the data segment (typically KBs), while the child keeps
    the parent's restore layout — the successor node promotes at the same
    ws boundary the original restore would have.  ``stats.private_bytes``
    is the delta's wire cost; everything else restores through the parent
    chain (node caches / chunk CAS / peer fetch)."""
    from repro_torch.core.jif import JifReader

    with JifReader(parent) as r:
        order = r.meta.get("access_order")
        ws = r.meta.get("working_set")
    pipeline = SnapshotPipeline(node_cache=node_cache, memory=memory)
    return pipeline.run(
        state, path, parent=parent,
        access_order=order, working_set=ws, meta=meta,
    )


class SnapshotPipeline:
    """Staged snapshot writer (trim → classify → relocate → write)."""

    def __init__(
        self,
        page_size: int = overlay.DEFAULT_PAGE,
        trim_fn: Optional[Callable] = None,
        node_cache=None,
        memory=None,
    ):
        self.page_size = page_size
        self.trim_fn = trim_fn
        self.node_cache = node_cache  # used to materialize v1 parents once
        # optional node ledger (repro_torch.core.memory.NodeMemoryManager): the
        # writer's classification buffers are charged as scratch for the
        # duration of run(), so snapshot writes compete with live tenants
        self.memory = memory

    # ------------------------------------------------------------- stage 1
    def trim(self, state):
        return self.trim_fn(state) if self.trim_fn is not None else state

    # ------------------------------------------------------------- stage 2
    def classify(self, state, digest_source=None) -> Tuple[_Classified, SnapshotStats]:
        """Flatten the state and classify every chunk; digests are computed
        for every tensor (stored in the v2 image so children can delta
        against it without reading our data segment)."""
        ps = self.page_size
        leaves, treedesc = flatten_state(state)
        c = _Classified()
        c.treedesc = treedesc
        stats = SnapshotStats(n_tensors=len(leaves))
        for name, arr in leaves:
            raw = leaf_bytes(arr)
            c.names.append(name)
            c.buffers[name] = raw
            mv = memoryview(raw)
            dg = chunk_digests(mv, ps)  # shared identity (repro_torch.core.digest)
            c.digests[name] = dg
            base_dg = digest_source.digests(name) if digest_source is not None else None
            c.kinds[name] = overlay.classify(mv, ps, base_dg, digests=dg)
            c.entries[name] = jif.TensorEntry(
                name=name, dtype=dtype_name(arr.dtype), shape=tuple(arr.shape),
                nbytes=raw.nbytes,
            )
            self._account(stats, name, c)
        return c, stats

    def _account(self, stats: SnapshotStats, name: str, c: _Classified) -> None:
        ps = self.page_size
        nb = c.buffers[name].nbytes
        kinds = c.kinds[name]
        stats.total_bytes += nb
        last_partial = nb - (overlay.n_chunks(nb, ps) - 1) * ps
        counts = np.bincount(kinds, minlength=3)

        def _kind_bytes(k):
            n = int(counts[k])
            # last chunk may be partial; attribute it to its kind
            if n and int(kinds[-1]) == k:
                return (n - 1) * ps + last_partial
            return n * ps

        stats.private_bytes += _kind_bytes(overlay.KIND_PRIVATE)
        stats.base_bytes += _kind_bytes(overlay.KIND_BASE)
        stats.zero_bytes += _kind_bytes(overlay.KIND_ZERO)

    # ------------------------------------------------------------- stage 3
    def relocate(
        self,
        c: _Classified,
        access_order: Optional[List[str]] = None,
        working_set: Optional[List[str]] = None,
    ) -> Tuple[List[str], List[str], int]:
        """Assign data-segment offsets in first-access order and compute the
        working-set boundary.  Returns (order, ws_names, ws_boundary)."""
        names = c.names
        if access_order:
            listed = [n for n in access_order if n in c.entries]
            listed_set = set(listed)
            rest = [n for n in names if n not in listed_set]
            order = listed + rest
        else:
            order = list(names)
            listed = order
        if working_set is not None:
            ws_names = [n for n in working_set if n in c.entries]
        else:
            ws_names = listed
        ws_set = set(ws_names)

        cursor = 0
        ws_boundary = 0
        for name in order:
            table = overlay.intervals_from_kinds(c.kinds[name])
            for row in table:
                if row[2] == overlay.KIND_PRIVATE:
                    row[3] = cursor
                    cursor += int(row[1])
            c.itables[name] = table
            if name in ws_set:
                ws_boundary = cursor
        if not ws_set:
            ws_boundary = cursor
        return order, ws_names, ws_boundary

    # ------------------------------------------------------------- stage 4
    def write(
        self,
        path: str,
        c: _Classified,
        order: List[str],
        meta: Dict[str, Any],
        base_ref: Optional[Dict],
        ws_boundary: int,
    ) -> None:
        ps = self.page_size
        scratch = np.zeros(ps, np.uint8)  # one shared pad buffer, not a
        # fresh np.concatenate per tensor's final partial chunk

        def data_iter():
            for name in order:
                raw = c.buffers[name]
                for start, n, _src in overlay.IntervalTable(c.itables[name]).private_runs():
                    chunk = raw[start * ps : (start + n) * ps]
                    full = (len(chunk) // ps) * ps
                    if full:
                        yield chunk[:full].tobytes()
                    tail = len(chunk) - full
                    if tail:
                        scratch[:tail] = chunk[full:]
                        scratch[tail:] = 0
                        yield scratch.tobytes()

        jif.write_jif(
            path,
            meta,
            [c.entries[n] for n in order],
            c.itables,
            data_iter(),
            ps,
            base_ref=base_ref,
            digests=c.digests,
            ws_boundary=ws_boundary,
        )

    # ----------------------------------------------------------------- run
    def run(
        self,
        state,
        path: str,
        *,
        base=None,
        parent: Optional[str] = None,
        access_order: Optional[List[str]] = None,
        working_set: Optional[List[str]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> SnapshotStats:
        """Run the full pipeline.  ``base`` is an in-memory
        :class:`BaseImage`; ``parent`` is a path to a parent JIF on disk
        (delta snapshot — at most one of the two)."""
        if base is not None and parent is not None:
            raise ValueError("pass either base= (in-memory) or parent= (on-disk), not both")

        t0 = time.perf_counter()
        state = self.trim(state)

        scratch = None
        if self.memory is not None:
            from repro_torch.core.memory import KIND_SCRATCH

            nbytes = sum(
                getattr(arr, "nbytes", 0) for _, arr in flatten_state(state)[0]
            )
            scratch = self.memory.reserve(
                nbytes, KIND_SCRATCH, owner=f"snapshot:{os.path.basename(path)}"
            )
        try:
            return self._run(state, path, base, parent, access_order,
                             working_set, meta, t0)
        finally:
            if scratch is not None:
                scratch.release()

    def _run(self, state, path, base, parent, access_order, working_set,
             meta, t0) -> SnapshotStats:

        digest_source = base
        base_ref = {"name": base.name} if base is not None else None
        parent_reader = None
        if parent is not None:
            parent_reader = jif.JifReader(parent)
            if parent_reader.page_size != self.page_size:
                parent_reader.close()
                raise ValueError(
                    f"parent page_size {parent_reader.page_size} != {self.page_size}"
                )
            digest_source = _JifDigestSource(parent_reader, self.node_cache)
            base_ref = {
                "name": parent_cache_key(parent),
                "path": os.path.abspath(parent),
            }

        try:
            c, stats = self.classify(state, digest_source)
        finally:
            if parent_reader is not None:
                parent_reader.close()
        order, ws_names, ws_boundary = self.relocate(c, access_order, working_set)
        stats.classify_s = time.perf_counter() - t0
        stats.n_intervals = sum(len(c.itables[n]) for n in order)
        stats.ws_boundary = ws_boundary
        stats.ws_tensors = len(ws_names)
        stats.parent = os.path.abspath(parent) if parent else None

        header_meta = dict(meta or {})
        header_meta.setdefault("tree", c.treedesc)
        header_meta.setdefault("access_order", order)
        header_meta.setdefault("working_set", ws_names)
        header_meta.setdefault("created_at", time.time())

        t1 = time.perf_counter()
        self.write(path, c, order, header_meta, base_ref, ws_boundary)
        stats.write_s = time.perf_counter() - t1
        return stats
