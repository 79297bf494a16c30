"""Node-level base-image cache — the host page cache analogue.

Base images hold the bytes shared across function instances (a common base
model, language runtime weights, ...). They stay resident in node RAM after
container teardown, so subsequent restores of any function that deduplicated
against them fetch only private chunks from storage — the paper's
"specialized node pools / Python+AI pools" operating model builds on this.

Images can be bootstrapped straight from JIFs on disk
(:meth:`BaseImage.from_jif`): a delta-chain restore that misses its parent in
the cache materializes the parent image from its file (recursively through
the chain) and installs it, so a freshly provisioned node needs nothing but
the snapshot store.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.core import overlay
from repro_torch.core.memory import KIND_IMAGE_CACHE, MemoryPressureError, NodeMemoryManager
from repro_torch.core.treeutil import flatten_state, leaf_bytes


class BaseImage:
    """Digests + chunk bytes of one shared snapshot, keyed by tensor name."""

    def __init__(self, name: str, page_size: int = overlay.DEFAULT_PAGE):
        self.name = name
        self.page_size = page_size
        self._bytes: Dict[str, np.ndarray] = {}
        self._digests: Dict[str, np.ndarray] = {}

    @classmethod
    def from_state(cls, name: str, state, page_size: int = overlay.DEFAULT_PAGE) -> "BaseImage":
        img = cls(name, page_size)
        leaves, _ = flatten_state(state)
        for lname, arr in leaves:
            raw = leaf_bytes(arr)
            img._bytes[lname] = raw.copy()
            img._digests[lname] = overlay.chunk_digests(memoryview(raw), page_size)
        return img

    @classmethod
    def from_jif(
        cls,
        path: str,
        name: Optional[str] = None,
        node_cache: Optional["NodeImageCache"] = None,
        iosched=None,
        simulate_read_bw: Optional[float] = None,
        chunks=None,
    ) -> "BaseImage":
        """Materialize a full image from a JIF on disk.  The restore runs
        synchronously through ``node_cache``, which resolves (and, for delta
        chains, recursively bootstraps) any parent the JIF references.
        Pass the node's ``iosched`` so the bootstrap's reads are arbitrated
        against live tenant streams instead of bypassing the scheduler."""
        from repro_torch.core.jif import JifReader
        from repro_torch.core.restore import SpiceRestorer

        with JifReader(path) as r:
            page_size = r.page_size
        if name is None:
            from repro_torch.core.lifecycle import parent_cache_key

            name = parent_cache_key(path)
        # pipelined even though we wait: inline streams are drained on the
        # caller's thread and would bypass the scheduler's arbitration
        # ``chunks`` (the node's chunk cache) lets the bootstrap itself
        # dedup: a parent whose chunks a peer already pulled arrives over
        # the interconnect instead of the slow image store
        restorer = SpiceRestorer(
            node_cache=node_cache,
            iosched=iosched, simulate_read_bw=simulate_read_bw,
            chunks=chunks,
        )
        state, _, _, _ = restorer.restore(path)
        return cls.from_state(name, state, page_size)

    def digests(self, name: str) -> Optional[np.ndarray]:
        return self._digests.get(name)

    def chunk_bytes(self, name: str, start_chunk: int, n: int) -> np.ndarray:
        raw = self._bytes[name]
        return raw[start_chunk * self.page_size : (start_chunk + n) * self.page_size]

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._bytes.values())


class NodeImageCache:
    """LRU cache of BaseImages shared by every restore on this node.

    Attached to a :class:`~repro_torch.core.memory.NodeMemoryManager`, every
    resident image is charged to an ``image_cache`` region and eviction
    becomes a registered *reclaimer* invoked under node memory pressure
    (rung 3 of the ladder: after residual tails, device-resident base
    pages, and the RAM chunk CAS, before warm instances) instead of only a
    private capacity LRU."""

    RECLAIM_ORDER = 3  # ladder rung: residual (0) -> device images (1) ->
    # chunk CAS (2) -> image cache -> pool staging -> warm LRU.  Host base
    # images outrank device copies and RAM chunks: dropping a device base
    # costs one re-upload from here, a RAM chunk one local CAS read, but
    # dropping a host base forces a disk re-read (or fails the restore).

    def __init__(self, capacity_bytes: int = 8 << 30):
        self.capacity = capacity_bytes
        self._images: "OrderedDict[str, BaseImage]" = OrderedDict()
        self._lock = threading.Lock()
        # resident bytes, maintained incrementally (the evict loop used to
        # re-sum every image per iteration — O(n²) under churn)
        self.total_bytes = 0
        self._memory: Optional[NodeMemoryManager] = None
        self._regions: Dict[str, "object"] = {}  # name -> MemoryRegion
        # names the pressure reclaimer must NOT evict: images with no
        # on-disk parent to re-materialize from (operator-installed bases).
        # Recoverable images (bootstrapped from a parent JIF) are fair game.
        self._pinned: set = set()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0, "base_bytes_served": 0}

    # --------------------------------------------------------------- ledger
    def attach(self, memory: NodeMemoryManager) -> None:
        """Charge resident images to the node ledger and register this
        cache's LRU eviction as the ladder's image-cache reclaimer."""
        with self._lock:
            if self._memory is memory:
                return
            self._memory = memory
            imgs = list(self._images.values())
        for img in imgs:
            try:
                region = memory.reserve(
                    img.nbytes, KIND_IMAGE_CACHE, owner=img.name, block=False
                )
            except MemoryPressureError:
                with self._lock:
                    pinned = img.name in self._pinned
                if pinned:
                    # an unrecoverable base that does not fit must fail
                    # LOUDLY at attach time — silently dropping it would
                    # crash every later restore deduplicated against it
                    raise
                self._drop(img.name)
                continue
            region.commit()
            with self._lock:
                self._regions[img.name] = region
        memory.register_reclaimer("image-cache", self.reclaim, self.RECLAIM_ORDER)

    def put(self, img: BaseImage, evictable: bool = True) -> None:
        """Install an image.  ``evictable=False`` pins it against the
        *pressure* reclaimer (a restore that deduplicated against an
        in-memory-only base cannot recover it from disk); recoverable
        images — bootstrapped parents with a JIF behind them — stay
        evictable.  Capacity LRU is unaffected by the pin."""
        region = None
        if self._memory is not None:
            # a same-name replacement only needs the DELTA: resize the
            # resident image's region in place instead of double-charging
            # the full size (which would run the ladder, or fail, for a
            # net-zero operation)
            with self._lock:
                resident = self._regions.get(img.name)
            if resident is not None and resident.resize(img.nbytes):
                region = resident
            else:
                # reserve BEFORE taking the cache lock: admission may run
                # the reclaim ladder, whose image-cache rung locks this
                # cache.  A base that cannot fit even after reclaim fails
                # fast here — the restore that needed it must not
                # over-commit the node.
                region = self._memory.reserve(
                    img.nbytes, KIND_IMAGE_CACHE, owner=img.name
                )
            region.commit()
        evicted = []
        with self._lock:
            old = self._images.get(img.name)
            if old is not None:
                self.total_bytes -= old.nbytes
                old_region = self._regions.pop(img.name, None)
                if old_region is not None and old_region is not region:
                    evicted.append(old_region)
            self._images[img.name] = img
            self.total_bytes += img.nbytes
            if region is not None:
                self._regions[img.name] = region
            if evictable:
                self._pinned.discard(img.name)
            else:
                self._pinned.add(img.name)
            self._images.move_to_end(img.name)
            evicted.extend(self._evict())
        for r in evicted:
            r.release()

    def get(self, name: Optional[str]) -> Optional[BaseImage]:
        if name is None:
            return None  # "no base" is not a cache miss
        with self._lock:
            img = self._images.get(name)
            if img is None:
                self.stats["misses"] += 1
                return None
            self.stats["hits"] += 1
            self._images.move_to_end(name)
            return img

    def contains(self, name: Optional[str]) -> bool:
        """Non-mutating residency probe: no LRU bump, no hit/miss stats.
        Placement policies poll this per request — a probe that polluted
        the LRU order or the stats would bias both."""
        if name is None:
            return False
        with self._lock:
            return name in self._images

    def resident_names(self) -> frozenset:
        """Names of every resident image (non-mutating; for load probes)."""
        with self._lock:
            return frozenset(self._images)

    def note_base_served(self, nbytes: int) -> None:
        """Restorers report BASE bytes they memcpy'd (thread-safe)."""
        with self._lock:
            self.stats["base_bytes_served"] += nbytes

    def _drop(self, name: str) -> int:
        """Remove one image (no region bookkeeping); returns its bytes."""
        with self._lock:
            img = self._images.pop(name, None)
            if img is None:
                return 0
            self._pinned.discard(name)
            self.total_bytes -= img.nbytes
            self.stats["evictions"] += 1
            return img.nbytes

    def _evict(self):
        """Capacity LRU (under self._lock).  Pinned images are skipped —
        an unrecoverable base evicted for capacity would crash every
        restore deduplicated against it.  Returns regions to release once
        the lock is dropped (region release takes the manager lock; lock
        order is always cache -> manager)."""
        released = []
        victims = [n for n in self._images if n not in self._pinned]
        while (
            self.total_bytes > self.capacity and len(self._images) > 1 and victims
        ):
            name = victims.pop(0)
            img = self._images.pop(name)
            self.total_bytes -= img.nbytes
            self.stats["evictions"] += 1
            region = self._regions.pop(name, None)
            if region is not None:
                released.append(region)
        return released

    def reclaim(self, nbytes: int, protect=frozenset()) -> int:
        """Ladder rung 3: evict LRU *recoverable* images until ``nbytes``
        are freed (may drain them all — a restore mid-flight keeps its own
        reference to the base it resolved, and the next miss bootstraps the
        parent back from its JIF).  Pinned images (no disk backing) are
        never sacrificed here.  Returns the bytes uncharged."""
        freed = 0
        released = []
        with self._lock:
            for name in [n for n in self._images if n not in self._pinned]:
                if freed >= nbytes:
                    break
                img = self._images.pop(name)
                self.total_bytes -= img.nbytes
                self.stats["evictions"] += 1
                freed += img.nbytes
                region = self._regions.pop(name, None)
                if region is not None:
                    released.append(region)
        for r in released:
            r.release()
        return freed
