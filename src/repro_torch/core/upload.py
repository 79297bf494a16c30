"""Device-resident restore fast path: host→HBM upload stream + base cache.

The host restore pipeline stops at host memory; the eager install path then
pays a synchronous per-tensor device copy on the prefetcher thread, so the
read stream stalls behind every upload (serialization-bound, not
read-bandwidth-bound).  This module closes that gap:

* :class:`UploadStream` — the node's host→HBM upload engine.  It owns a
  ring of ``depth`` staging slots, page-locked on a GPU and plain memory on
  the CPU, allocated once per node and charged once to its ledger.  A
  restore's read op lands its private chunks straight in a slot (one
  ``preadv``) and issues an async copy from there into the tensor's final
  device memory (a :class:`Staged`, allocated when the restore is planned)
  on the uploader's CUDA stream, so a private byte crosses host memory
  once.  A slot is refilled only after its copy's event has completed:
  the reader waiting for a slot is the backpressure that bounds host
  staging in flight.  The prefetcher's finalize then enqueues a landing
  job and returns to reading; a dedicated uploader thread enqueues the
  overlay patch (fused tensors) behind the copies, waits for the tensor to
  land and resolves its handle — uploads overlap ongoing disk reads and
  (because completion is tracked per tensor) layer-gated decode in the
  function instance.  A host-staged tensor (assembled in a pool buffer,
  uploaded whole) still goes through :meth:`UploadStream.upload_full`.

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

On a GPU the reads' copies, the patches and the host-staged uploads all go
on the uploader's CUDA stream, and a handle resolves only once the work
issued there for its tensor has finished: layers gated on a handle read
finished tensors, no slot is refilled under a pending copy, and no copy
reads a pool buffer the pool has re-zeroed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict, deque
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.cache import BaseImage
from repro_torch.core.memory import (
    KIND_DEVICE_IMAGE,
    KIND_POOL,
    MemoryPressureError,
    NodeMemoryManager,
)
from repro_torch.device import resolve_device
from repro_torch.interop import host_view, storage_dtype, to_torch, torch_dtype


# bytes of one staging slot: the restorer's default ``io_chunk_bytes``, so
# one read op fills at most one slot
SLOT_BYTES = 8 << 20


def _default_install(arr, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor.  MUST copy: on the CPU
    ``torch.from_numpy`` aliases the staging buffer, which the pool recycles
    and re-zeroes."""
    return to_torch(arr, device, copy=True)


class _DeviceStream:
    """The CUDA stream device work is issued on (none on the CPU), and the
    barrier that work must pass before a tensor is handed on or its host
    source is reused.  Any thread may issue on it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def on(self):
        """A context in which the calling thread's device work goes on the
        stream (a no-op on the CPU)."""
        return torch.cuda.stream(self.stream)

    def land(self, out: Optional[torch.Tensor] = None) -> None:
        """Wait until every copy and kernel issued so far has finished.  A
        tensor made here is then read on the default stream: record that,
        so the allocator never reuses its memory under a pending reader."""
        if self.stream is None:
            return
        done = torch.cuda.Event()
        done.record(self.stream)
        done.synchronize()
        if out is not None:
            out.record_stream(torch.cuda.default_stream(self.device))


class _Slots:
    """``n`` staging slots of ``nbytes`` in one host allocation, page-locked
    when the device is a GPU.  :meth:`take` hands out a free slot, else the
    one whose copy was issued first, once that copy has completed."""

    def __init__(self, device: torch.device, n: int, nbytes: int):
        cuda = device.type == "cuda"
        self.nbytes = nbytes
        self.host = torch.empty(n * nbytes, dtype=torch.uint8, pin_memory=cuda)
        self._np = self.host.numpy()
        self._events = [torch.cuda.Event() if cuda else None for _ in range(n)]
        self._free = deque(range(n))
        self._landing: deque = deque()  # slots with a copy issued, oldest first
        self._cv = threading.Condition()

    def array(self, i: int) -> np.ndarray:
        return self._np[i * self.nbytes : (i + 1) * self.nbytes]

    def tensor(self, i: int) -> torch.Tensor:
        return self.host[i * self.nbytes : (i + 1) * self.nbytes]

    def take(self) -> int:
        with self._cv:
            self._cv.wait_for(lambda: self._free or self._landing)
            if self._free:
                return self._free.popleft()
            i = self._landing.popleft()
        self._events[i].synchronize()  # the slot's last copy has read it
        return i

    def give(self, i: int, stream=None) -> None:
        """Return slot ``i``; ``stream`` is the stream a copy from it was
        just issued on (None: no copy pending)."""
        if stream is not None:
            self._events[i].record(stream)
        with self._cv:
            (self._free if stream is None else self._landing).append(i)
            self._cv.notify()

    def idle(self) -> int:
        """Slots no op holds (free, or waiting for their copy)."""
        with self._cv:
            return len(self._free) + len(self._landing)


class Staged:
    """Device memory a restore's reads fill through the staging slots: one
    tensor's bytes, or a fused tensor's compact private pages, as flat
    ``uint8``.  ``sent`` counts the bytes copied in."""

    __slots__ = ("flat", "sent")

    def __init__(self, flat: torch.Tensor):
        self.flat = flat
        self.sent = 0

    def view(self, dtype: str, shape) -> torch.Tensor:
        arr = self.flat.view(torch_dtype(dtype))
        return arr.reshape(shape) if shape else arr.reshape(())


@dataclasses.dataclass
class FusedPlan:
    """Per-tensor device-patch plan, built host-side at restore planning
    time (the itable is already resident — zero deserialization).  ``src``
    indexes the COMPACT private pages (0..n_priv-1 in page order); ``runs``
    maps JIF data-segment chunks onto compact slots."""

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
    """Host→HBM upload engine shared by every restore on a node.

    Reads copy into device memory through ``depth`` staging slots of
    :data:`SLOT_BYTES` (:meth:`stage`).  One daemon uploader thread drains a
    queue of landing jobs (:meth:`land`, :meth:`upload_fused`,
    :meth:`upload_full`); each resolves exactly one :class:`TensorHandle`
    (``set`` on success, ``fail`` on error), so execution gates on real
    device arrays and a failed upload never hangs a waiter.  The queue is
    unbounded: the slots bound the reads in flight, and the only jobs that
    hold host staging (host-staged uploads' pool buffers) got it when their
    restore was planned."""

    def __init__(self, depth: int = 4, name: str = "upload-stream",
                 install: Optional[Callable] = None,
                 simulate_bw: Optional[float] = None, device=None):
        """``depth`` is the number of staging slots.  ``simulate_bw``
        (bytes/s) models the host→device interconnect roofline the same
        way ``simulate_read_bw`` models storage: each job sleeps for the
        bytes it actually moves (private pages only for fused jobs — the
        fast path's economy shows up as shorter sleeps).
        Labeled benchmark runs only; None on real hardware.  ``device``
        (None: the GPU) is where tensors land."""
        self.name = name
        self.depth = max(1, int(depth))
        self.slot_bytes = SLOT_BYTES
        self.device = resolve_device(device)
        self.install = install or partial(_default_install, device=self.device)
        self._dstream = _DeviceStream(self.device)
        self._slots = _Slots(self.device, self.depth, self.slot_bytes)
        self._region = None  # the slots' ledger charge (attach)
        self.simulate_bw = simulate_bw
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = 0  # queued + executing jobs
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.stats = {
            "uploads": 0,
            "fused_patches": 0,
            "uploaded_bytes": 0,
            "pinned_bytes": 0,  # of uploaded_bytes, copied from the slots
            "patched_bytes": 0,
            "upload_s": 0.0,
            "failures": 0,
        }

    # --------------------------------------------------------------- ledger
    def attach(self, memory: NodeMemoryManager) -> None:
        """Charge the slots to the node ledger (``pool`` kind, as pool
        staging is), once."""
        if self._region is None:
            self._region = memory.reserve(
                self.depth * self.slot_bytes, KIND_POOL,
                owner=f"{self.name}-slots", block=False,
            )
            self._region.commit()

    # ------------------------------------------------------------ internals
    def _landed(self, stats, t0: int, t_sync: int, t_end: int, uploaded: int,
                patched: int, fused: bool, t_copy: int = 0, pinned: int = 0) -> None:
        """Account one job from its stamps (``perf_counter_ns``): its start
        on the uploader, the wait's start, its end, and with the recorder on
        the end of the copies (the patch's start).  The same stamps feed
        ``upload_s`` / ``sync_wait_s`` and the spans ``install.job`` →
        ``install.copy``, ``install.patch`` (fused), ``install.sync``.  A
        host-staged job starts with its host-to-device copy; a tensor read
        through the slots had its copies issued with its reads, before its
        job, so its job holds the patch (fused) and the wait for the copies
        to land — the uploader's own time, not the reads' nor the queue's."""
        dt = (t_end - t0) / 1e9
        with self._cv:
            self.stats["uploads"] += 1
            self.stats["upload_s"] += dt
            self.stats["uploaded_bytes"] += uploaded
            self.stats["pinned_bytes"] += pinned
            if fused:
                self.stats["fused_patches"] += 1
                self.stats["patched_bytes"] += patched
        if stats is not None:
            stats.add(upload_s=dt, uploaded_bytes=uploaded, pinned_bytes=pinned,
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

    def _failed(self, handle, exc: BaseException) -> None:
        with self._cv:
            self.stats["failures"] += 1
        handle.fail(exc)

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
        self._q.put(job)

    def _loop(self) -> None:
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

    # ----------------------------------------------------------------- API
    def staged(self, nbytes: int) -> Staged:
        """Device memory for ``nbytes`` that reads will fill through the
        slots, allocated on the uploader's stream."""
        with self._dstream.on():
            return Staged(torch.empty(nbytes, dtype=torch.uint8, device=self.device))

    def stage(self, target: Staged, offset: int,
              fill: Callable[[np.ndarray], int]) -> int:
        """Copy bytes into ``target`` at byte ``offset`` through one slot:
        ``fill`` writes them into the slot (a ``uint8`` array of
        :data:`SLOT_BYTES`) and returns how many to send.  The copy is async on
        the uploader's stream; the slot goes back to the ring at once and is
        refilled only after the copy has completed.  A ``fill`` that raises
        returns the slot with nothing in flight.  Returns the bytes sent."""
        i = self._slots.take()
        copied = False
        try:
            n = int(fill(self._slots.array(i)))
            if n:
                with self._dstream.on():
                    target.flat[offset : offset + n].copy_(
                        self._slots.tensor(i)[:n], non_blocking=True
                    )
                copied = True
        finally:
            self._slots.give(i, self._dstream.stream if copied else None)
        target.sent += n
        return n

    def land(self, handle, target: Staged, *, shape, dtype: str,
             stats=None) -> None:
        """Enqueue the landing of a tensor the restore's reads copied whole
        into ``target``: the handle resolves once those copies finished."""

        def job():
            try:
                t0 = obs.now()
                if self.simulate_bw:
                    time.sleep(target.sent / self.simulate_bw)
                arr = target.view(dtype, shape)
                t_sync = obs.now()
                self._dstream.land(arr)
                t_end = obs.now()
                handle.set(arr)
                self._landed(stats, t0, t_sync, t_end, target.sent, 0,
                             fused=False, pinned=target.sent)
            except BaseException as exc:  # noqa: BLE001 — typed via handle
                self._failed(handle, exc)

        self._submit(job)

    def upload_full(self, handle, buf: np.ndarray, *, shape, dtype: str,
                    nbytes: int, stats=None, release=None) -> None:
        """Enqueue a whole-tensor upload of a host-staged tensor: ``buf``
        holds the full host tensor (base memcpy + private reads + zero
        pages); the device copy happens on the uploader thread, overlapped
        with further reads, and ``buf`` goes to ``release`` once it landed."""

        def job():
            try:
                view = host_view(buf[:nbytes], dtype, shape)
                t0 = obs.now()
                if self.simulate_bw:
                    time.sleep(nbytes / self.simulate_bw)
                with self._dstream.on():
                    arr = self.install(view)
                    t_sync = obs.now()
                    self._dstream.land(arr)
                t_end = obs.now()
                handle.set(arr)
                self._landed(stats, t0, t_sync, t_end, nbytes, 0, fused=False)
            except BaseException as exc:  # noqa: BLE001 — typed via handle
                self._failed(handle, exc)
            finally:
                if release is not None:
                    release(buf)

        self._submit(job)

    def upload_fused(self, handle, plan: FusedPlan,
                     target: Optional[Staged], *, stats=None) -> None:
        """Enqueue a fused patch: the restore's reads copied the compact
        private pages into ``target`` (None: the tensor has none), and the
        overlay-patch kernel goes on the same stream behind them,
        materializing the full tensor against the HBM-resident base pages
        (``plan.base_pages``; ZERO pages cost nothing)."""

        def job():
            from repro_torch.kernels.overlay_patch.ops import overlay_patch

            try:
                dtype = torch_dtype(plan.dtype)
                dev = self.device
                sent = target.sent if target is not None else 0
                t0 = obs.now()
                if self.simulate_bw:
                    # only the private pages cross the interconnect
                    time.sleep(sent / self.simulate_bw)
                with self._dstream.on():
                    if target is not None:
                        priv = target.view(plan.dtype, (plan.n_priv, plan.page_elems))
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
                    self._dstream.land(arr)
                t_end = obs.now()
                handle.set(arr)
                self._landed(stats, t0, t_sync, t_end, sent, plan.nbytes,
                             fused=True, t_copy=t_copy, pinned=sent)
            except BaseException as exc:  # noqa: BLE001 — typed via handle
                self._failed(handle, exc)

        self._submit(job)

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued upload landed (tests/benchmarks)."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Drain outstanding uploads, stop the worker and return the slots'
        ledger charge (idempotent)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            th = self._thread
        self.flush(timeout)
        if th is not None and th.is_alive():
            self._q.put(None)
            th.join(timeout)
        if self._region is not None:
            self._region.release()

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
        ds = _DeviceStream(self.device)
        with ds.on():
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
