"""The Spice restore engine.

Restore = batched metadata restore + pipelined, *guaranteed* memory restore:

* metadata: ONE header decode rebuilds the full state structure (no
  per-resource replay); interval tables are raw int64 arrays (zero
  deserialization cost).
* memory: chunk reads are submitted to a prefetch I/O scheduler (one shared
  arbiter per node, or a private one for standalone restores) that streams
  the data segment with large sequential reads in first-access order.  On
  the device path a read lands straight in one of the upload stream's
  page-locked slots and is copied from there into the tensor's device
  memory, allocated at planning time, so a private byte crosses host
  memory once.  A host-staged tensor fills a pool buffer instead: BASE
  chunks are memcpy'd from the node base-image cache concurrently
  (VMA-creation/prefetch overlap, §4.2); ZERO chunks cost nothing (pool
  buffers are pre-zeroed).  Completion is
  *tracked per tensor* — unlike madvise-style hints, execution can wait on
  exactly the tensor it needs and never takes a "major fault" on data that
  was requested but not loaded.  Under contention, a wait on an unread
  tensor demand-boosts its chunks to the head of the scheduler queue.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import overlay
from repro_torch.core.cache import BaseImage, NodeImageCache
from repro_torch.core.chunkstore import NodeChunkCache
from repro_torch.core.digest import digest_key
from repro_torch.core.iosched import IOStream, PrefetchIOScheduler
from repro_torch.core.jif import JifReader
from repro_torch.core.memory import (
    KIND_RESIDUAL,
    KIND_WORKING_SET,
    MemoryRegion,
    NodeMemoryManager,
)
from repro_torch.core.pool import BufferPool
from repro_torch.core.treeutil import unflatten_state
from repro_torch.interop import dtype_name, host_view, itemsize, wait_landed


def _dtype_name(arr) -> str:
    """numpy's spelling of a resident array's or tensor's dtype ("" if
    it has none), as the JIF header spells it."""
    dt = getattr(arr, "dtype", None)
    return "" if dt is None else dtype_name(dt)


def _pread_into(fd: int, dst: np.ndarray, off: int) -> int:
    """Fill ``dst`` (contiguous ``uint8``) from ``fd`` at byte ``off`` with
    ``os.preadv``, no intermediate object; returns the bytes read, fewer
    than ``dst`` holds only at the end of the file."""
    view = memoryview(dst)
    got = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], off + got)
        if n <= 0:
            break
        got += n
    return got


@dataclasses.dataclass
class RestoreStats:
    metadata_s: float = 0.0
    first_tensor_s: float = 0.0
    working_set_s: float = 0.0  # all working-set tensors resident (phase 1)
    total_s: float = 0.0
    bytes_read: int = 0
    base_bytes: int = 0
    zero_bytes: int = 0
    io_ops: int = 0
    demand_boosts: int = 0
    restore_ops: int = 1  # ONE batched metadata restore (vs CRIU's replay)
    major_faults: int = 0  # guaranteed population: always 0 for spice
    image_bytes: int = 0      # logical bytes of the restored state tree
    ws_tensors: int = 0       # tensors inside the traced working set
    residual_tensors: int = 0  # tensors streaming after the ws boundary
    reused_bytes: int = 0     # bytes served from a pinned working set
    reused_tensors: int = 0   # tensors served from a pinned working set
    # device fast path: read-wait and upload-wait split apart so benchmarks
    # can attribute TTFT to storage vs PCIe/serialization
    upload_s: float = 0.0             # time spent in host->device transfers
    uploaded_bytes: int = 0           # bytes that actually crossed to HBM
    pinned_bytes: int = 0             # of those, copied from the staging slots
    patched_on_device_bytes: int = 0  # tensor bytes materialized by the kernel
    sync_wait_s: float = 0.0          # of upload_s, waiting on the upload stream
    # content-addressed dedup: bytes served per tier instead of pulled from
    # the image store, plus the metadata-time plan partition (chunk counts)
    chunk_resident_bytes: int = 0  # served from the RAM chunk cache (zero I/O)
    chunk_cas_bytes: int = 0       # read from the node-local disk CAS
    chunk_peer_bytes: int = 0      # transferred node-to-node over the wire
    chunk_plan_resident: int = 0   # chunks planned as RAM hits
    chunk_plan_cas: int = 0        # chunks planned as local CAS hits
    chunk_plan_miss: int = 0       # chunks planned as image-store pulls
    ws_names: Optional[List[str]] = None  # traced working-set tensor names

    # Snapshot consistency: the prefetcher mutates counters concurrently
    # with readers (the engine reports stats while the stream is live), so
    # every mutation happens under a lock and ``as_dict`` takes a coherent
    # snapshot.  Completion is two-phase: ``mark_working_set`` fires when
    # every tensor before the ws boundary finalized (execution-ready),
    # ``mark_complete`` once the last residual tensor landed.
    def __post_init__(self):
        self._lock = threading.Lock()
        self._complete = threading.Event()
        self._ws = threading.Event()
        # the span recorder's request and ``restore`` span (0: not traced),
        # read by the restore's reads and upload jobs on their threads
        self.req = 0
        self.span = 0

    def add(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def set_once(self, field: str, value) -> None:
        with self._lock:
            if not getattr(self, field):
                setattr(self, field, value)

    def mark_working_set(self, working_set_s: float) -> None:
        with self._lock:
            self.working_set_s = working_set_s
        self._ws.set()

    def wait_working_set(self, timeout: Optional[float] = None) -> bool:
        return self._ws.wait(timeout)

    @property
    def ws_ready(self) -> bool:
        return self._ws.is_set()

    def mark_complete(self, total_s: float) -> None:
        with self._lock:
            self.total_s = total_s
        self._ws.set()  # a drained stream implies the working set landed
        self._complete.set()

    def wait_complete(self, timeout: Optional[float] = None) -> bool:
        return self._complete.wait(timeout)

    @property
    def complete(self) -> bool:
        return self._complete.is_set()

    def as_dict(self):
        with self._lock:
            d = dataclasses.asdict(self)
        d.pop("ws_names", None)  # bulky name list; read the attribute instead
        d["complete"] = self.complete
        d["ws_ready"] = self.ws_ready
        return d


def estimate_rerestore_cost(
    stats: Optional[RestoreStats],
    *,
    image_bytes: int = 0,
    ws_pinned: bool = False,
    residual_bytes: int = 0,
    chunks_hot: bool = False,
    device_base_resident: bool = False,
) -> int:
    """Estimated storage-pull bytes to bring an instance back after
    eviction — the currency cost-aware eviction ranks candidates in
    (:class:`repro_torch.serve.prewarm.PrewarmPolicy`).

    Baseline: what the LAST restore actually pulled (``stats.bytes_read``
    already discounts base-image memcpys, zero pages, chunk-cache hits
    and pinned-ws reuse).  Refinements, cheapest state first:

    * ``ws_pinned`` — a residual-evicted instance re-reads only the
      dropped residual share of the image (``residual_bytes`` of
      ``stats.image_bytes``); a fully pinned ws with no residual left
      costs ~nothing.
    * ``chunks_hot`` — the pull lands through a node chunk cache whose
      CAS already holds the image's chunks (the last restore ingested
      them): re-reads come from the node-local CAS, not the image
      store — order-of-magnitude cheaper, not free (disk + verify).
    * ``device_base_resident`` — the HBM base survives eviction in the
      DeviceImageCache, shaving the re-upload (a mild discount here:
      this estimate prices storage, not PCIe).

    Returns >= 1 so penalty ratios stay well-defined; a stats-less
    instance (never restored through spice) prices at its full logical
    size — unknown is expensive, evict it last among equals."""
    if stats is None:
        return max(int(image_bytes), 1)
    total = stats.image_bytes or image_bytes
    paid = stats.bytes_read
    if ws_pinned:
        if total > 0 and residual_bytes > 0:
            paid = int(paid * min(1.0, residual_bytes / total))
        else:
            paid = 0
    if chunks_hot:
        paid //= 16
    if device_base_resident:
        paid = int(paid * 0.9)
    return max(paid, 1)


class TensorHandle:
    """Tracked-completion handle (the anti-madvise): ``wait`` blocks until
    the tensor is materialized; ``ready`` never lies.  Waiting on an unread
    tensor issues a demand boost to the I/O scheduler first, so execution
    demand overtakes background prefetch of other tensors/functions."""

    def __init__(self, name: str, shape, dtype):
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self._ev = threading.Event()
        self._arr: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None
        self._demand: Optional[Callable[[], bool]] = None

    def set(self, arr: np.ndarray):
        self._arr = arr
        self._ev.set()

    def fail(self, exc: BaseException) -> None:
        """Release waiters with the restore failure instead of hanging."""
        if not self._ev.is_set():
            self._exc = exc
            self._ev.set()

    def attach_demand(self, fn: Callable[[], bool]) -> None:
        self._demand = fn

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._ev.is_set() and self._demand is not None:
            self._demand()
        if not self._ev.wait(timeout):
            raise TimeoutError(f"tensor {self.name} not restored in time")
        if self._exc is not None:
            raise RuntimeError(f"restore of {self.name} failed") from self._exc
        return self._arr

    @property
    def ready(self) -> bool:
        return self._ev.is_set()


# Residual tails yield to every demand stream — including BATCH-class
# restores, whose streams open at -1 (see repro_torch.serve.invocation.QosClass
# .io_priority): demanded bytes of any class beat advisory background fill.
BACKGROUND_PRIORITY = -2


class SpiceRestorer:
    def __init__(
        self,
        pool: Optional[BufferPool] = None,
        node_cache: Optional[NodeImageCache] = None,
        io_chunk_bytes: int = 8 << 20,
        pipelined: bool = True,
        transform: Optional[Callable[[np.ndarray], Any]] = None,
        simulate_read_bw: Optional[float] = None,
        iosched: Optional[PrefetchIOScheduler] = None,
        stream_priority: int = 0,
        memory: Optional[NodeMemoryManager] = None,
        device_path=None,
        chunks: Optional[NodeChunkCache] = None,
    ):
        """``transform`` runs on the scheduler's reader thread per completed
        tensor (e.g. a copy to the GPU = eager device install, off the critical
        path).  ``simulate_read_bw`` (bytes/s) sleeps during reads to model
        real storage latency when files are page-cache resident (labeled
        runs only).  ``iosched`` is the node-shared prefetch scheduler; when
        omitted a private one is created per restorer (standalone use).
        ``memory`` is the node ledger: when given, a restore reserves its
        working-set and residual regions up front — a restore that cannot
        fit fails fast (or triggers the reclaim ladder) instead of
        over-committing the node.

        ``device_path`` (a :class:`repro_torch.core.upload.DevicePath`) switches
        tensor materialization to the device fast path: finalize enqueues
        uploads onto the node's shared :class:`UploadStream` instead of
        host-assembling + transforming on the reader thread.  Per tensor,
        the restore plans either a FUSED restore — only private pages are
        read and uploaded, into a compact device tensor; BASE pages come
        from the HBM-resident :class:`DeviceImageCache`, ZERO pages are
        free, and the overlay-patch kernel materializes the full tensor on
        device — or a full upload when fusion cannot apply: page size not
        a dtype multiple, all-private itable (nothing to fuse), BASE pages
        with no device base available (cache miss under pressure, or
        ``device_path.images is None``).  Private pages of a fused tensor
        and of an all-private one are read straight into the upload
        stream's page-locked slots and copied from there into device
        memory allocated at planning time; any other full upload is
        host-staged (pool buffer, host assembly as usual, whole-tensor
        upload off the reader thread), as is an all-private tensor that
        dedup serves.  ``transform`` is ignored for device-path tensors;
        ``on_ready`` only fires for host-path tensors.

        ``chunks`` (a :class:`repro_torch.core.chunkstore.NodeChunkCache`)
        enables dedup-aware restore planning: each host-path tensor's
        chunk list is partitioned by digest into resident hits (served
        from the RAM chunk cache, zero I/O), node-local CAS hits (one
        local disk read), peer hits (interconnect transfer), and misses —
        only the missing chunks are pulled from the image store, and each
        pull ingests into the cache so K deltas of one base cost ~1 base
        read across the node/cluster, not K."""
        self.pool = pool or BufferPool()
        self.node_cache = node_cache or NodeImageCache()
        self.io_chunk_bytes = io_chunk_bytes
        self.pipelined = pipelined
        self.transform = transform
        self.simulate_read_bw = simulate_read_bw
        self.iosched = iosched or PrefetchIOScheduler(name="spice-private")
        self.stream_priority = stream_priority
        self.memory = memory
        self.device_path = device_path
        self.chunks = chunks
        # (ws_region, residual_region) of the LAST restore() call — the
        # node scheduler transfers these onto the FunctionInstance, which
        # releases them on eviction (restorers are per-restore on that path)
        self.regions: Tuple[Optional[MemoryRegion], Optional[MemoryRegion]] = (None, None)
        # the LAST restore() call's live prefetch stream: the node holds it
        # to abort a cancelled invocation mid-restore (stream.abort fails
        # every handle and returns the admitted regions via on_complete)
        self.stream: Optional[IOStream] = None

    # ------------------------------------------------------------------
    def restore(
        self,
        path: str,
        on_ready: Optional[Callable[[str, np.ndarray], None]] = None,
        wait: bool = True,
        on_working_set: Optional[Callable[[], None]] = None,
        preloaded: Optional[Dict[str, Any]] = None,
        preloaded_region: Optional[MemoryRegion] = None,
    ) -> Tuple[Any, Dict, Dict[str, TensorHandle], RestoreStats]:
        """Returns (state, meta, handles, stats). With ``wait=False`` the
        state tree contains TensorHandles being filled by the scheduler —
        callers overlap execution with restore by waiting per tensor.

        Completion is two-phase: once every tensor inside the traced
        working set finalizes, ``stats.mark_working_set`` fires (and
        ``on_working_set``, if given, runs on the prefetcher thread) while
        the residual keeps streaming at background priority — demand boosts
        still promote individual residual tensors on ``TensorHandle.wait``.
        The JIF reader is closed (and ``stats`` marked complete) when the
        last tensor finalizes, whether or not the caller waited.

        ``preloaded`` maps tensor names to already-resident arrays (a
        residual-evicted instance's pinned working set): matching tensors
        are served without any storage read, so a re-restore reads only the
        bytes that were actually dropped.  Entries whose dtype/shape no
        longer match the image (e.g. after a relayout) fall back to a
        normal read.  ``preloaded_region`` is the ledger region still
        charging those resident bytes — it is resized in place into this
        restore's working-set region (ownership transfers here; the caller
        must not release it afterwards)."""
        stats = RestoreStats()
        t0 = obs.now()
        rspan = None
        if obs.ON:
            rspan = obs.begin("restore", t0)
            stats.req, stats.span = rspan.req, rspan.id

        def since() -> float:
            return (obs.now() - t0) / 1e9

        r = None
        try:
            r = JifReader(path)  # missing/corrupt image raises here
            r.load_all_itables()
            meta = r.meta
            base = self._resolve_base(r)
        except BaseException:
            # _resolve_base closes r on its own failure paths, but a parent
            # bootstrap can also fail through node_cache.put (e.g.
            # MemoryPressureError) — close() is idempotent, never leak the
            # fd (nor the caller's retained ws charge)
            if preloaded_region is not None:
                preloaded_region.release()
            if r is not None:
                r.close()
            raise

        order = meta["access_order"]
        ws_names = set(meta.get("working_set") or order)
        reused: Dict[str, Any] = {}
        for t in r.tensors:
            arr = (preloaded or {}).get(t.name)
            if (
                arr is not None
                and getattr(arr, "nbytes", -1) == t.nbytes
                and tuple(getattr(arr, "shape", ())) == tuple(t.shape)
                and _dtype_name(arr) == t.dtype
            ):
                reused[t.name] = arr

        # ---- device fast path: plan fused vs full uploads per tensor -----
        # Planned NOW (the itables are already resident, zero extra I/O) so
        # device memory can be allocated before any read is issued.  The
        # first restore against a base pays its one-time device install
        # here, synchronously; every later restore on the node shares it.
        dp = self.device_path
        plans: Dict[str, Any] = {}   # name -> FusedPlan
        full_upload: set = set()     # device path, whole-tensor upload
        whole: set = set()           # of those, all-private
        if dp is not None:
            try:
                plans, full_upload, whole = self._plan_device(r, base, reused)
            except BaseException:
                if preloaded_region is not None:
                    preloaded_region.release()
                r.close()
                raise

        # ---- dedup planning: partition chunk lists by digest -------------
        # Metadata-time only (the itables and digest regions are already
        # resident — zero data-segment I/O): record how many chunks the
        # node can serve without touching the image store.  The actual
        # short-circuit happens per op at read time (dedup_read_op), because
        # demand boosts reorder tensors and earlier ops ingest chunks later
        # ones need — the plan counters are the *forecast*, not the contract.
        dedup_digests: Dict[str, np.ndarray] = {}
        if self.chunks is not None:
            try:
                # v1 images backfill digests once (persisted sidecar) so
                # legacy images participate in dedup instead of being opaque
                have = r.has_digests or r.ensure_digests(base=base)
            except (ValueError, OSError):
                have = False  # e.g. unreadable sidecar dir: restore sans dedup
            if have:
                plan_hits = {"ram": 0, "cas": 0, None: 0}
                for t in r.tensors:
                    if t.name in reused or t.name in plans:
                        continue
                    dg = r.digests(t.name)
                    if dg is None:
                        continue
                    dedup_digests[t.name] = dg
                    for start, count, _src in r.itable(t.name).private_runs():
                        for j in range(start, start + count):
                            plan_hits[self.chunks.probe(dg[j])] += 1
                stats.add(
                    chunk_plan_resident=plan_hits["ram"],
                    chunk_plan_cas=plan_hits["cas"],
                    chunk_plan_miss=plan_hits[None],
                )

        # ---- admission: reserve regions BEFORE any data is staged --------
        region_ws = region_res = None
        if self.memory is not None:
            ws_bytes = sum(t.nbytes for t in r.tensors if t.name in ws_names)
            res_bytes = sum(t.nbytes for t in r.tensors) - ws_bytes
            tag = os.path.basename(path)
            try:
                if (
                    preloaded_region is not None
                    and not preloaded_region.released
                    and preloaded_region.resize(ws_bytes)
                ):
                    # re-restore: the pinned working set's charge carries
                    # over in place — the resident bytes are never
                    # uncharged, so concurrent reserves cannot admit
                    # against memory that is still physically held
                    region_ws = preloaded_region
                else:
                    if preloaded_region is not None:
                        # ws size changed (relayout): release the stale pin
                        # first so the fresh reserve does not stack on top
                        # of a charge the ladder has no way to reclaim
                        preloaded_region.release()
                    region_ws = self.memory.reserve(
                        ws_bytes, KIND_WORKING_SET, owner=tag
                    )
                if res_bytes:
                    region_res = self.memory.reserve(
                        res_bytes, KIND_RESIDUAL, owner=tag
                    )
            except BaseException:
                if region_ws is not None:
                    region_ws.release()
                r.close()
                raise
        elif preloaded_region is not None:
            preloaded_region.release()  # no ledger on this restorer
        self.regions = (region_ws, region_res)

        def _release_regions():
            for reg in (region_ws, region_res):
                if reg is not None:
                    reg.release()

        handles: Dict[str, TensorHandle] = {}
        buffers: Dict[str, np.ndarray] = {}  # host staging (pool buffers)
        # device memory the reads copy into through the upload stream's
        # slots: a fused tensor's compact private pages, an all-private
        # tensor whole (unless dedup serves it: the chunk cache takes and
        # gives host bytes)
        targets: Dict[str, Any] = {}
        # anything that fails between here and the stream owning its
        # on_complete (pool or device allocation, a shut-down scheduler)
        # must return the admitted charges and close the reader — a leaked
        # reservation would brick every later admission on the node
        try:
            for t in r.tensors:
                handles[t.name] = TensorHandle(t.name, t.shape, t.dtype)
                if t.name in reused:
                    continue
                plan = plans.get(t.name)
                if plan is not None:
                    # fused: ONLY the private pages cross, compactly; an
                    # all-BASE/ZERO tensor needs no staging at all
                    if plan.n_priv:
                        targets[t.name] = dp.upload.staged(plan.priv_bytes)
                elif t.name in whole and t.name not in dedup_digests:
                    targets[t.name] = dp.upload.staged(t.nbytes)
                else:
                    buffers[t.name] = self.pool.acquire(t.nbytes)
            ws_remaining = [sum(
                1 for t in r.tensors if t.name in ws_names and t.name not in reused
            )]
            stats.image_bytes = sum(t.nbytes for t in r.tensors)
            stats.ws_tensors = sum(1 for t in r.tensors if t.name in ws_names)
            stats.residual_tensors = len(r.tensors) - stats.ws_tensors
            stats.ws_names = [n for n in order if n in ws_names]
            t_meta = obs.now()
            stats.metadata_s = (t_meta - t0) / 1e9
            if rspan is not None:
                obs.add("restore.metadata", t0, t_meta, parent=rspan.id)

            # pinned tensors are resident already: serve them with zero I/O
            for t in r.tensors:
                if t.name not in reused:
                    continue
                handles[t.name].set(reused[t.name])
                stats.add(reused_bytes=t.nbytes, reused_tensors=1)
                region = region_ws if t.name in ws_names else region_res
                if region is not None:
                    region.populate(t.nbytes)
            if reused:
                stats.set_once("first_tensor_s", since())
        except BaseException:
            _release_regions()
            r.close()
            raise

        def finalize(name: str):
            t = r.by_name[name]
            if dp is not None and (name in plans or name in full_upload):
                # device path: hand the tensor to the uploader and return to
                # reading immediately — the landing wait (and, for fused
                # tensors, the overlay patch behind the reads' copies; for a
                # host-staged one, its whole device copy) runs on the
                # uploader thread, overlapped with further reads.  The
                # handle resolves when the tensor lands.
                plan = plans.get(name)
                if plan is not None:
                    dp.upload.upload_fused(
                        handles[name], plan, targets.pop(name, None), stats=stats,
                    )
                elif name in targets:
                    dp.upload.land(
                        handles[name], targets.pop(name),
                        shape=tuple(t.shape), dtype=t.dtype, stats=stats,
                    )
                else:
                    dp.upload.upload_full(
                        handles[name], buffers.pop(name),
                        shape=tuple(t.shape), dtype=t.dtype, nbytes=t.nbytes,
                        stats=stats, release=partial(self.pool.release, dirty=True),
                    )
            else:
                # numpy view, or a CPU torch view for bf16 (no ml_dtypes)
                arr = host_view(buffers[name][: t.nbytes], t.dtype, t.shape)
                if self.transform is not None:  # eager install (device put)
                    arr = self.transform(arr)
                    # a device copy may still be in flight when the transform
                    # returns: it must land before its staging buffer is
                    # re-zeroed, or the device copy reads zeros mid-transfer
                    wait_landed(arr)
                    # the host staging buffer is no longer referenced:
                    # recycle it into the pool, re-zeroing on THIS (reader)
                    # thread — allocation and zeroing stay off future
                    # critical paths
                    self.pool.release(buffers.pop(name), dirty=True)
                handles[name].set(arr)
                if on_ready is not None:
                    on_ready(name, arr)
            region = region_ws if name in ws_names else region_res
            if region is not None:
                region.populate(t.nbytes)
            stats.set_once("first_tensor_s", since())
            if name in ws_names:
                # the stream serves one tensor at a time, so this counter
                # only ever moves on the serving thread
                ws_remaining[0] -= 1
                if ws_remaining[0] == 0 and not stats.ws_ready:
                    if region_ws is not None:
                        region_ws.commit(pinned="working_set")
                    stats.mark_working_set(since())
                    # phase 2: residual streams on at background priority;
                    # per-tensor demand boosts still overtake it
                    stream.set_priority(BACKGROUND_PRIORITY)
                    stream.region = region_res  # residual I/O accounting
                    if on_working_set is not None:
                        on_working_set()

        def fill_base_zero(name: str) -> int:
            """memcpy BASE runs from the node cache; ZERO runs are free.
            Costs no storage reads (returns 0 bytes for the arbiter)."""
            t = r.by_name[name]
            it = r.itable(name)
            ps = r.page_size
            for start, count, kind, _src in it.table:
                if kind == overlay.KIND_PRIVATE:
                    continue
                nb = min(count * ps, t.nbytes - start * ps)
                if kind == overlay.KIND_BASE:
                    src = base.chunk_bytes(name, int(start), int(count))[:nb]
                    buffers[name][start * ps : start * ps + nb] = src
                    stats.add(base_bytes=nb)
                    self.node_cache.note_base_served(nb)
                else:  # ZERO: pool buffers are pre-zeroed
                    stats.add(zero_bytes=nb)
                    self.pool.note_zero_chunks(nb)
            return 0

        def read_op(name: str, src: int, dst_chunk: int, count: int) -> int:
            """One large sequential read into a host-staged tensor's pool
            buffer."""
            t = r.by_name[name]
            ps = r.page_size
            raw = r.pread_chunks(src, count)
            if self.simulate_read_bw:
                time.sleep(len(raw) / self.simulate_read_bw)
            dst0 = dst_chunk * ps
            nb = min(len(raw), t.nbytes - dst0)
            buffers[name][dst0 : dst0 + nb] = np.frombuffer(raw[:nb], np.uint8)
            stats.add(bytes_read=len(raw), io_ops=1)
            return len(raw)

        def dedup_read_op(name: str, src: int, dst_chunk: int, count: int) -> int:
            """read_op with content-addressed short-circuits: chunks already
            in the RAM chunk cache, the local CAS, or held by a peer are
            served without touching the image store; only runs of
            consecutive misses are pulled (one coalesced sequential read
            each), and every pulled chunk is ingested so the next tenant —
            on this node or a peer — hits instead.  Returns only the bytes
            actually pulled from the image store, so the arbiter's
            ``bytes_read`` keeps meaning storage pulls."""
            t = r.by_name[name]
            ps = r.page_size
            dgs = dedup_digests[name]
            cache = self.chunks
            pulled = [0]

            def clen(page: int) -> int:  # unpadded length of chunk `page`
                return min(ps, t.nbytes - page * ps)

            def pull(j0: int, n: int) -> None:
                raw = r.pread_chunks(src + j0, n)
                if self.simulate_read_bw:
                    time.sleep(len(raw) / self.simulate_read_bw)
                dst0 = (dst_chunk + j0) * ps
                nb = min(len(raw), t.nbytes - dst0)
                buffers[name][dst0 : dst0 + nb] = np.frombuffer(raw[:nb], np.uint8)
                stats.add(bytes_read=len(raw), io_ops=1)
                pulled[0] += len(raw)
                for j in range(j0, j0 + n):
                    off = (j - j0) * ps
                    cache.ingest(
                        dgs[dst_chunk + j], raw[off : off + clen(dst_chunk + j)]
                    )

            miss0 = miss_n = 0
            for j in range(count):
                page = dst_chunk + j
                dk = digest_key(dgs[page])
                data = cache.get(dk)
                if data is not None:
                    stats.add(chunk_resident_bytes=len(data))
                else:
                    data = cache.get_cas(dk)
                    if data is not None:
                        stats.add(chunk_cas_bytes=len(data))
                    else:
                        data = cache.fetch_peer(dk)
                        if data is not None:
                            stats.add(chunk_peer_bytes=len(data))
                if data is None:
                    if miss_n == 0:
                        miss0 = j
                    miss_n += 1
                    continue
                if miss_n:
                    pull(miss0, miss_n)
                    miss_n = 0
                nb = clen(page)
                buffers[name][page * ps : page * ps + nb] = np.frombuffer(
                    data[:nb], np.uint8
                )
            if miss_n:
                pull(miss0, miss_n)
            return pulled[0]

        def direct_read_op(name: str, src: int, dst: int, nbytes: int) -> int:
            """One sequential read of private chunks straight into a
            page-locked slot (``preadv`` on the reader's file, no
            intermediate object), then an async copy from the slot into the
            tensor's device memory: a fused tensor's compact private pages,
            or an all-private tensor whole — neither exists on the host.
            ``src`` and ``dst`` are byte offsets into the data segment and
            the device memory; bytes past the tensor's end (its last page's
            padding) are read and not sent."""
            target = targets[name]
            want = min(nbytes, r.data_len - src)
            got = 0

            def fill(slot: np.ndarray) -> int:
                nonlocal got
                got = _pread_into(r._f.fileno(), slot[:want], r.data_off + src)
                if got < want:
                    raise OSError(
                        f"{path}: short read of {name} ({got} of {want} bytes)"
                    )
                if self.simulate_read_bw:
                    time.sleep(got / self.simulate_read_bw)
                return min(got, target.flat.numel() - dst)

            dp.upload.stage(target, dst, fill)
            stats.add(bytes_read=got, io_ops=1)
            return got

        def fused_account(name: str) -> int:
            """Fused tensors pay no host memcpy for BASE/ZERO pages —
            account the bytes the device tier serves (no storage reads)."""
            plan = plans[name]
            t = r.by_name[name]
            sizes = np.minimum(
                plan.page_bytes,
                t.nbytes - np.arange(plan.n_pages, dtype=np.int64) * plan.page_bytes,
            )
            nb_base = int(sizes[plan.kinds == overlay.KIND_BASE].sum())
            nb_zero = int(sizes[plan.kinds == overlay.KIND_ZERO].sum())
            if nb_base:
                stats.add(base_bytes=nb_base)
                if dp.images is not None:
                    dp.images.note_base_served(nb_base)
            if nb_zero:
                stats.add(zero_bytes=nb_zero)
            return 0

        def tensor_ops(name: str) -> List[Callable[[], int]]:
            ps = r.page_size
            chunk = max(self.io_chunk_bytes // ps, 1)
            plan = plans.get(name)
            if plan is not None or name in targets:
                # fused: read ONLY the private runs, packed compactly; an
                # all-private tensor: its runs where they lie.  One op fills
                # at most one slot.
                ops = [partial(fused_account, name)] if plan is not None else []
                runs = plan.runs if plan is not None else [
                    (start, src, count)
                    for start, count, src in r.itable(name).private_runs()
                ]
                step = min(chunk * ps, dp.upload.slot_bytes)
                for dst, src, count in runs:
                    for off in range(0, count * ps, step):
                        ops.append(partial(
                            direct_read_op, name, src * ps + off, dst * ps + off,
                            min(step, count * ps - off),
                        ))
                return ops
            ops = [partial(fill_base_zero, name)]
            # dedup applies per host-staged tensor (never one read through
            # the slots); the op probes the chunk cache at read time
            rop = dedup_read_op if name in dedup_digests else read_op
            for start, count, src in r.itable(name).private_runs():
                done = 0
                while done < count:
                    n = min(count - done, chunk)
                    ops.append(partial(rop, name, src + done, start + done, n))
                    done += n
            return ops

        try:
            stream = self.iosched.open_stream(
                name=os.path.basename(path),
                priority=self.stream_priority,
                inline=not self.pipelined,
                region=region_ws,
            )
        except BaseException:
            _release_regions()
            r.close()
            raise
        self.stream = stream
        stream.req, stream.span = stats.req, stats.span

        def on_complete():
            if stream.error is not None:
                # failed stream: release every waiter with the error, and
                # return the admitted regions to the budget (idempotent —
                # an instance that already adopted them releases too)
                for h in handles.values():
                    h.fail(stream.error)
                _release_regions()
            else:
                if region_ws is not None:
                    region_ws.commit(pinned="working_set")
                if region_res is not None:
                    region_res.commit(pinned="residual")
            t_end = obs.now()
            if rspan is not None:  # recorded before a waiter can see completion
                obs.end(rspan, t_end)
            stats.mark_complete((t_end - t0) / 1e9)
            r.close()

        stream._on_complete = on_complete
        try:
            if ws_remaining[0] == 0 and not stats.ws_ready:
                # the whole working set was served from pinned memory:
                # promote immediately; the stream only reads residual now
                if region_ws is not None:
                    region_ws.commit(pinned="working_set")
                stats.mark_working_set(since())
                stream.set_priority(BACKGROUND_PRIORITY)
                stream.region = region_res
                if on_working_set is not None:
                    on_working_set()
            for name in order:
                if name in reused:
                    continue
                stream.submit(name, tensor_ops(name), partial(finalize, name))
            stream.seal()
        except BaseException as exc:
            # never leave a half-submitted stream registered (it would pin
            # the reader thread and leak the fd): fail it, which also runs
            # on_complete -> r.close()
            stream.abort(exc)
            raise
        for name, h in handles.items():
            h.attach_demand(partial(self._boost, stream, stats, name))

        if not self.pipelined:
            # synchronous path: drain on the caller's thread (no overlap)
            self.iosched.drain_inline(stream)
        elif wait:
            stream.wait()

        leaves: Dict[str, Any] = {name: handles[name] for name in handles}
        if wait:
            leaves = {name: h.wait() for name, h in leaves.items()}
        state = unflatten_state(meta["tree"], leaves)
        return state, meta, handles, stats

    def _plan_device(
        self, r: JifReader, base: Optional[BaseImage], reused: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], set, set]:
        """Split this image's tensors between the two device-path modes:
        ``plans`` (name -> FusedPlan: upload private pages only, patch on
        device) and ``full_upload`` (whole-tensor upload), and name the
        all-private tensors among the latter (``whole``: nothing for the
        host to assemble).  Fusion applies when the page size divides the
        dtype and the itable has BASE/ZERO pages to save; BASE pages
        additionally need the device-resident base — a cache miss under
        memory pressure falls back to full upload, never fails."""
        # imported here: only the device path needs the kernels' module
        from repro_torch.core.upload import FusedPlan
        from repro_torch.kernels.overlay_patch.ops import compact_plan_from_itable

        dp = self.device_path
        plans: Dict[str, Any] = {}
        full: set = set()
        whole: set = set()
        ps = r.page_size
        for t in r.tensors:
            if t.name in reused:
                continue
            size = itemsize(t.dtype)  # resolves "bfloat16" without ml_dtypes
            it = r.itable(t.name)
            kinds, src, runs, n_priv = compact_plan_from_itable(it)
            n_pages = it.n_pages
            if n_priv == n_pages:
                full.add(t.name)  # nothing to fuse
                whole.add(t.name)
                continue
            if ps % size != 0:
                full.add(t.name)  # pages unviewable in the dtype
                continue
            page_elems = ps // size
            base_pages = None
            if (kinds == overlay.KIND_BASE).any():
                if dp.images is None or base is None:
                    full.add(t.name)
                    continue
                base_pages = dp.images.get_pages(
                    base, t.name, n_pages, page_elems, t.dtype
                )
                if base_pages is None:  # pressure/mismatch: host fallback
                    full.add(t.name)
                    continue
            plans[t.name] = FusedPlan(
                name=t.name, shape=tuple(t.shape), dtype=t.dtype,
                nbytes=t.nbytes, page_bytes=ps, page_elems=page_elems,
                n_pages=n_pages, n_priv=n_priv, kinds=kinds, src=src,
                runs=runs, base_pages=base_pages,
            )
        return plans, full, whole

    # one bootstrap per parent key at a time: N sibling delta restores that
    # all miss the parent must not each materialize the full image
    _bootstrap_meta = threading.Lock()
    _bootstrap_locks: Dict[str, threading.Lock] = {}

    def _resolve_base(self, r: JifReader) -> Optional[BaseImage]:
        """Resolve the image's base: from the node cache, or — for delta
        chains — bootstrapped from the parent JIF on disk (recursively, so a
        fresh node can restore any depth of chain from the snapshot store).
        The ref's name binds the parent file's identity (mtime+size): if the
        file on disk no longer matches what this image was classified
        against, the restore fails loudly instead of corrupting silently."""
        ref = r.base_ref
        if not ref:
            return None
        name = ref.get("name")
        base = self.node_cache.get(name)
        if base is None and ref.get("path"):
            from repro_torch.core.lifecycle import parent_cache_key

            with SpiceRestorer._bootstrap_meta:
                lock = SpiceRestorer._bootstrap_locks.setdefault(
                    name, threading.Lock()
                )
            with lock:
                base = self.node_cache.get(name)  # won the race? already in
                if base is None:
                    try:
                        current_key = parent_cache_key(ref["path"])
                    except FileNotFoundError:
                        current_key = None
                    if current_key is not None and current_key != name:
                        r.close()
                        raise FileNotFoundError(
                            f"parent JIF {ref['path']!r} changed on disk "
                            f"since this delta was written (key mismatch)"
                        )
                    if current_key is not None:
                        try:
                            base = BaseImage.from_jif(
                                ref["path"], name=name,
                                node_cache=self.node_cache,
                                iosched=self.iosched,
                                simulate_read_bw=self.simulate_read_bw,
                                chunks=self.chunks,
                            )
                        except FileNotFoundError:
                            base = None
                    if base is not None:
                        self.node_cache.put(base)
        if base is None:
            r.close()
            raise FileNotFoundError(
                f"base image {ref.get('name')!r} not in node cache"
                + (f" and parent JIF {ref['path']!r} unusable" if ref.get("path") else "")
            )
        return base

    @staticmethod
    def _boost(stream: IOStream, stats: RestoreStats, name: str) -> bool:
        if stream.boost(name):
            stats.add(demand_boosts=1)
            return True
        return False
