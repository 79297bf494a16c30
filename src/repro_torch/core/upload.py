"""Device-resident restore fast path: host→HBM upload stream + base cache.

The host restore pipeline stops at host memory; the eager install path then
pays a synchronous per-tensor device copy on the prefetcher thread, so the
read stream stalls behind every upload (serialization-bound, not
read-bandwidth-bound).  This module closes that gap:

* :class:`UploadStream` — a double-buffered host→HBM upload engine.  The
  prefetcher's finalize enqueues an upload job and returns to reading; a
  dedicated uploader thread performs the device transfers.  The ring is
  bounded (``depth`` slots, default 2): while one slot uploads, the next
  is staged, and the reader only blocks when BOTH are in flight — uploads
  overlap with ongoing disk reads, and (because completion is tracked per
  tensor) with layer-gated decode in the function instance.  The pool's
  pre-zeroed staging buffers are the pinned-slot analogue: jobs hand them
  back to the pool after the device copy lands, re-zeroing on the uploader
  thread, off every critical path.

* :class:`DeviceImageCache` — base images resident in HBM once per node.
  Each (image, tensor) entry holds the base's pages on device, charged to
  the node ledger under the ``device_image`` kind and evictable via its
  own reclaim-ladder rung (order 1: after residual tails, before host base
  images — a dropped device base costs one re-upload from host, never a
  disk read).  Delta restores then upload ONLY private pages and
  materialize the full tensor on device with the overlay-patch kernel:
  BASE pages come from the shared HBM-resident base, ZERO pages are free,
  and no intermediate full host tensor is ever built.

* :class:`DevicePath` — the bundle a :class:`~repro_torch.core.restore
  .SpiceRestorer` takes as its ``device_path=`` mode.

On a GPU the uploader thread works on a CUDA stream of its own and
synchronizes it before each handle resolves and before each staging buffer
goes back to the pool: layers gated on a handle read finished tensors, and
no copy can read a buffer the pool has re-zeroed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cache import BaseImage
from repro_torch.core.memory import (
    KIND_DEVICE_IMAGE,
    MemoryPressureError,
    NodeMemoryManager,
)
from repro_torch.device import resolve_device
from repro_torch.interop import host_view, storage_dtype, to_torch, torch_dtype


def _default_install(arr, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor.  MUST copy: on the CPU
    ``torch.from_numpy`` aliases the staging buffer, which the pool recycles
    and re-zeroes."""
    return to_torch(arr, device, copy=True)


class _DeviceStream:
    """The CUDA stream one thread issues its device work on (a null context
    on the CPU), and the barrier that work must pass before a tensor is
    handed on or its host source is reused."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __enter__(self):
        if self.stream is not None:
            self._ctx = torch.cuda.stream(self.stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            self._ctx.__exit__(*exc)
        return False

    def land(self, out: Optional[torch.Tensor] = None) -> None:
        """Wait until every copy and kernel issued so far has finished.  A
        tensor made here is then read on the default stream: record that,
        so the allocator never reuses its memory under a pending reader."""
        if self.stream is None:
            return
        self.stream.synchronize()
        if out is not None:
            out.record_stream(torch.cuda.default_stream(self.device))


@dataclasses.dataclass
class FusedPlan:
    """Per-tensor device-patch plan, built host-side at restore planning
    time (the itable is already resident — zero deserialization).  ``src``
    indexes the COMPACT private staging buffer (pages 0..n_priv-1 in page
    order); ``runs`` maps JIF data-segment chunks onto compact slots."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    page_bytes: int
    page_elems: int
    n_pages: int
    n_priv: int
    kinds: np.ndarray
    src: np.ndarray
    runs: List[Tuple[int, int, int]]  # (compact_slot, data_chunk, count)
    base_pages: Optional[object] = None  # device (n_pages, page_elems) or None

    @property
    def priv_bytes(self) -> int:
        return self.n_priv * self.page_bytes


class UploadStream:
    """Bounded host→HBM upload ring shared by every restore on a node.

    One daemon uploader thread drains a queue of at most ``depth`` jobs.
    ``submit`` blocks the producer (the prefetch reader thread) only when
    the ring is full — the documented trade-off: brief reader stalls bound
    the staging memory in flight instead of letting uploads queue
    unboundedly.  Each job resolves exactly one :class:`TensorHandle`
    (``set`` on success, ``fail`` on error), so execution gates on real
    device arrays and a failed upload never hangs a waiter."""

    def __init__(self, depth: int = 2, name: str = "upload-stream",
                 install: Optional[Callable] = None,
                 simulate_bw: Optional[float] = None, device=None):
        """``simulate_bw`` (bytes/s) models the host→device interconnect
        roofline the same way ``simulate_read_bw`` models storage: each job
        sleeps for the bytes it actually moves (private pages only for
        fused jobs — the fast path's economy shows up as shorter sleeps).
        Labeled benchmark runs only; None on real hardware.  ``device``
        (None: the GPU) is where tensors land."""
        self.name = name
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self.install = install or partial(_default_install, device=self.device)
        self._dstream: Optional[_DeviceStream] = None  # uploader thread's
        self.simulate_bw = simulate_bw
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = 0  # queued + executing jobs
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.stats = {
            "uploads": 0,
            "fused_patches": 0,
            "uploaded_bytes": 0,
            "patched_bytes": 0,
            "upload_s": 0.0,
            "failures": 0,
        }

    # ------------------------------------------------------------ internals
    def _landed(self, stats, t0: int, t_sync: int, t_end: int, uploaded: int,
                patched: int, fused: bool, t_copy: int = 0) -> None:
        """Account one job from its stamps (``perf_counter_ns``): start,
        the stream synchronize's start, its end, and with the recorder on
        the end of the host-to-device copy.  The same stamps feed
        ``upload_s`` / ``sync_wait_s`` and the spans ``install.job`` →
        ``install.copy``, ``install.patch`` (fused), ``install.sync``."""
        dt = (t_end - t0) / 1e9
        self._note(dt, uploaded, patched, fused)
        if stats is not None:
            stats.add(upload_s=dt, uploaded_bytes=uploaded,
                      sync_wait_s=(t_end - t_sync) / 1e9,
                      patched_on_device_bytes=patched)
        if obs.ON:
            parent, req = (stats.span, stats.req) if stats is not None else (0, 0)
            job = obs.add("install.job", t0, t_end, parent=parent, req=req,
                          bytes=uploaded, fused=int(fused))
            obs.add("install.copy", t0, t_copy or t_sync, parent=job, req=req)
            if fused and t_copy:
                obs.add("install.patch", t_copy, t_sync, parent=job, req=req)
            obs.add("install.sync", t_sync, t_end, parent=job, req=req)

    def _ensure_worker(self) -> None:
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name=f"{self.name}-uploader", daemon=True
                )
                self._thread.start()

    def _submit(self, job: Callable[[], None]) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError(f"upload stream {self.name!r} is closed")
            self._pending += 1
        self._ensure_worker()
        self._q.put(job)  # blocks while the ring is full (backpressure)

    def _loop(self) -> None:
        self._dstream = _DeviceStream(self.device)
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job()
            finally:
                # drop the job before the next wait: its handle reaches the
                # restore's whole tree (through its stream's completion
                # hook), which would outlive the instance's eviction
                job = None
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _note(self, dt: float, uploaded: int, patched: int, fused: bool) -> None:
        with self._cv:
            self.stats["uploads"] += 1
            self.stats["upload_s"] += dt
            self.stats["uploaded_bytes"] += uploaded
            if fused:
                self.stats["fused_patches"] += 1
                self.stats["patched_bytes"] += patched

    # ----------------------------------------------------------------- API
    def upload_full(self, handle, buf: np.ndarray, *, shape, dtype: str,
                    nbytes: int, stats=None, release=None) -> None:
        """Enqueue a whole-tensor upload: the staging buffer holds the full
        host tensor (base memcpy + private reads + zero pages); the device
        copy happens on the uploader thread, overlapped with further reads."""

        def job():
            try:
                view = host_view(buf[:nbytes], dtype, shape)
                t0 = obs.now()
                if self.simulate_bw:
                    time.sleep(nbytes / self.simulate_bw)
                with self._dstream as ds:
                    arr = self.install(view)
                    t_sync = obs.now()
                    ds.land(arr)
                t_end = obs.now()
                handle.set(arr)
                self._landed(stats, t0, t_sync, t_end, nbytes, 0, fused=False)
            except BaseException as exc:  # noqa: BLE001 — typed via handle
                with self._cv:
                    self.stats["failures"] += 1
                handle.fail(exc)
            finally:
                if release is not None:
                    release(buf)

        self._submit(job)

    def upload_fused(self, handle, plan: FusedPlan,
                     buf: Optional[np.ndarray], *, stats=None,
                     release=None) -> None:
        """Enqueue a fused upload+patch: only the compact private pages in
        ``buf`` cross to the device; the full tensor materializes there via
        the overlay-patch kernel against the HBM-resident base pages
        (``plan.base_pages``; ZERO pages cost nothing)."""

        def job():
            from repro_torch.kernels.overlay_patch.ops import overlay_patch

            try:
                dtype = torch_dtype(plan.dtype)
                dev = self.device
                t0 = obs.now()
                if self.simulate_bw:
                    # only the private pages cross the interconnect
                    time.sleep(plan.priv_bytes / self.simulate_bw)
                with self._dstream as ds:
                    if plan.n_priv and buf is not None:
                        priv_host = host_view(
                            buf[: plan.priv_bytes], plan.dtype,
                            (plan.n_priv, plan.page_elems),
                        )
                        priv = self.install(priv_host)
                    else:
                        priv = torch.zeros((1, plan.page_elems), dtype=dtype, device=dev)
                    t_copy = obs.now() if obs.ON else 0
                    base = plan.base_pages
                    if base is None:  # ZERO/PRIVATE-only tensor: free base
                        base = torch.zeros(
                            (plan.n_pages, plan.page_elems), dtype=dtype, device=dev
                        )
                    out = overlay_patch(
                        base, priv,
                        torch.from_numpy(plan.kinds).to(dev),
                        torch.from_numpy(plan.src).to(dev),
                    )
                    n_elems = plan.nbytes // out.element_size()
                    arr = out.reshape(-1)[:n_elems]
                    arr = arr.reshape(plan.shape) if plan.shape else arr.reshape(())
                    t_sync = obs.now()
                    ds.land(arr)
                t_end = obs.now()
                handle.set(arr)
                self._landed(stats, t0, t_sync, t_end, plan.priv_bytes, plan.nbytes,
                             fused=True, t_copy=t_copy)
            except BaseException as exc:  # noqa: BLE001 — typed via handle
                with self._cv:
                    self.stats["failures"] += 1
                handle.fail(exc)
            finally:
                if release is not None and buf is not None:
                    release(buf)

        self._submit(job)

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued upload landed (tests/benchmarks)."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Drain outstanding uploads and stop the worker (idempotent)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            th = self._thread
        self.flush(timeout)
        if th is not None and th.is_alive():
            self._q.put(None)
            th.join(timeout)

    def snapshot_stats(self) -> Dict[str, float]:
        with self._cv:
            return dict(self.stats)


class DeviceImageCache:
    """HBM-resident base pages, shared by every fused restore on a node.

    One entry per (base image, tensor, dtype, page geometry): the base's
    raw bytes padded to the restored tensor's page count, viewed in the
    tensor's dtype, installed on device ONCE — the ROADMAP scenario where
    thousands of fine-tunes of one base share a single HBM-resident copy.
    Attached to the node ledger, entries are charged as ``device_image``
    regions and LRU-evicted by the pressure reclaimer (rung
    ``RECLAIM_ORDER``); every entry is recoverable from the host
    :class:`BaseImage`, so the rung may drain the cache entirely."""

    RECLAIM_ORDER = 1  # residual (0) -> device images -> chunk CAS (2) ->
    # host image cache (3)

    def __init__(self, capacity_bytes: int = 4 << 30,
                 install: Optional[Callable] = None, device=None):
        self.capacity = capacity_bytes
        self.device = resolve_device(device)
        self.install = install or partial(_default_install, device=self.device)
        self._entries: "OrderedDict[Tuple, Tuple[object, int]]" = OrderedDict()
        self._regions: Dict[Tuple, object] = {}
        self._lock = threading.Lock()
        self._memory: Optional[NodeMemoryManager] = None
        self.total_bytes = 0
        # a build that loses the race to another counts as a hit (as in
        # the reference) and as a duplicate build
        self.stats = {
            "hits": 0, "misses": 0, "evictions": 0,
            "built_bytes": 0, "base_bytes_served": 0, "duplicate_builds": 0,
        }

    # --------------------------------------------------------------- ledger
    def attach(self, memory: NodeMemoryManager) -> None:
        """Charge resident entries to the node ledger and register the LRU
        eviction as the ladder's device-image rung."""
        evicted = []
        with self._lock:
            if self._memory is memory:
                return
            self._memory = memory
            entries = list(self._entries.items())
        for key, (_dev, nbytes) in entries:
            try:
                region = memory.reserve(
                    nbytes, KIND_DEVICE_IMAGE,
                    owner="/".join(map(str, key[:2])), block=False,
                )
            except MemoryPressureError:
                # always recoverable from the host base: drop, don't raise
                self._drop(key)
                continue
            region.commit()
            with self._lock:
                if key in self._entries:
                    self._regions[key] = region
                else:
                    evicted.append(region)
        for r in evicted:
            r.release()
        memory.register_reclaimer("device-image", self.reclaim, self.RECLAIM_ORDER)

    # ----------------------------------------------------------------- API
    def get_pages(self, base: BaseImage, tensor_name: str, n_pages: int,
                  page_elems: int, dtype) -> Optional[object]:
        """Device (n_pages, page_elems) base pages for one tensor, building
        and charging the entry on first use.  Returns None when the entry
        cannot be served (page-size mismatch, tensor absent from the base,
        or the ledger cannot admit the bytes even after reclaim) — the
        caller falls back to the host path for that tensor."""
        host_dtype = storage_dtype(dtype)  # same width; "bfloat16" as int16
        page_bytes = page_elems * host_dtype.itemsize
        key = (base.name, tensor_name, str(dtype), int(n_pages), int(page_elems))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.stats["hits"] += 1
                self._entries.move_to_end(key)
                return hit[0]
        if base.page_size != page_bytes or base.digests(tensor_name) is None:
            return None
        # build OUTSIDE the lock: pad the base's raw bytes to the restored
        # tensor's page count (a shorter base cannot own pages past its
        # length — classify never marks them BASE — so zero padding is safe)
        raw = base.chunk_bytes(tensor_name, 0, n_pages)
        host = np.zeros(n_pages * page_bytes, np.uint8)
        host[: len(raw)] = raw[: n_pages * page_bytes]
        with _DeviceStream(self.device) as ds:
            dev = self.install(host_view(host, dtype, (n_pages, page_elems)))
            ds.land(dev)
        nbytes = int(dev.nbytes)
        region = None
        if self._memory is not None:
            # reserve BEFORE taking the cache lock: admission may run the
            # reclaim ladder, whose device-image rung locks this cache
            try:
                region = self._memory.reserve(
                    nbytes, KIND_DEVICE_IMAGE,
                    owner=f"{base.name}/{tensor_name}", block=False,
                )
            except MemoryPressureError:
                return None  # caller falls back to the host path
            region.commit()
        evicted = []
        with self._lock:
            raced = self._entries.get(key)
            if raced is not None:  # lost a build race: keep the winner
                self.stats["hits"] += 1
                self.stats["duplicate_builds"] += 1
                if region is not None:
                    evicted.append(region)
                dev = raced[0]
            else:
                self.stats["misses"] += 1
                self.stats["built_bytes"] += nbytes
                self._entries[key] = (dev, nbytes)
                self.total_bytes += nbytes
                if region is not None:
                    self._regions[key] = region
                evicted.extend(self._evict_capacity())
        for r in evicted:
            r.release()
        return dev

    def note_base_served(self, nbytes: int) -> None:
        """Fused restores report BASE bytes materialized from device-resident
        pages (the device-tier analogue of the host cache's counter)."""
        with self._lock:
            self.stats["base_bytes_served"] += nbytes

    def resident_bytes(self) -> int:
        with self._lock:
            return self.total_bytes

    def resident_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------- eviction
    def _drop(self, key) -> int:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return 0
            self.total_bytes -= entry[1]
            self.stats["evictions"] += 1
            return entry[1]

    def _evict_capacity(self):
        """Capacity LRU (under self._lock); returns regions to release once
        the lock drops (lock order is always cache -> manager)."""
        released = []
        while self.total_bytes > self.capacity and len(self._entries) > 1:
            key, (_dev, nbytes) = self._entries.popitem(last=False)
            self.total_bytes -= nbytes
            self.stats["evictions"] += 1
            region = self._regions.pop(key, None)
            if region is not None:
                released.append(region)
        return released

    def reclaim(self, nbytes: int, protect=frozenset()) -> int:
        """Ladder rung 1: LRU-evict device base pages until ``nbytes`` are
        freed.  Every entry is recoverable (one re-upload from the host
        base image), so the rung may drain the cache entirely."""
        freed = 0
        released = []
        with self._lock:
            while self._entries and freed < nbytes:
                key, (_dev, ebytes) = self._entries.popitem(last=False)
                self.total_bytes -= ebytes
                self.stats["evictions"] += 1
                freed += ebytes
                region = self._regions.pop(key, None)
                if region is not None:
                    released.append(region)
        for r in released:
            r.release()
        return freed

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)


@dataclasses.dataclass
class DevicePath:
    """The device-restore bundle a :class:`SpiceRestorer` takes as its
    ``device_path=`` mode: the node's shared upload ring, the HBM base
    cache (None disables fused patching — every tensor full-uploads), and
    the host→device install transform."""

    upload: UploadStream
    images: Optional[DeviceImageCache] = None
    install: Optional[Callable] = None

    def installer(self) -> Callable:
        return self.install or self.upload.install
