"""Zero page pool: pre-allocated, pre-zeroed host buffers.

The paper's zero page pool serves two purposes we reproduce exactly:
(1) buffer acquisition off the restore critical path (no allocator calls,
no page faults while the prefetcher is streaming), and (2) ZERO-classified
chunks are satisfied for free because pool buffers are already zeroed.

Host-staged restores stage through it: every tensor of a restore without a
device path (host or eager install), and on the device path a tensor the
host must assemble (BASE pages with no device base, pages the dtype cannot
view, an all-private tensor that dedup serves).  A device-path tensor's
private pages bypass it: they are read into the upload stream's
page-locked slots and copied to the device from there
(:mod:`repro_torch.core.upload`), so no pool buffer is re-zeroed for bytes
the next restore would overwrite.

The pool is a size-classed free list living *inside* one ledger region
(:mod:`repro_torch.core.memory`): ``held_bytes`` counts every byte under pool
management — free-list buffers AND outstanding buffers a caller acquired —
so capacity is an invariant, not an estimate.  The seed's hole (miss-path
``np.zeros`` allocations were never charged, so N concurrent restores
could stage unbounded untracked memory) is closed: misses charge on
allocation, and an allocation that does not fit the capacity (or the node
budget, when attached) is a tracked *unmanaged* transient that is dropped
— never pooled — at release.
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.memory import KIND_POOL, NodeMemoryManager


def _size_class(nbytes: int) -> int:
    c = 1 << 12
    while c < nbytes:
        c <<= 1
    return c


class BufferPool:
    def __init__(self, capacity_bytes: int = 2 << 30, prezero: bool = True):
        self.capacity = capacity_bytes
        self.prezero = prezero
        self._free: Dict[int, List[np.ndarray]] = defaultdict(list)
        # held = free-list bytes + outstanding (acquired, charged) bytes
        self._held = 0
        # id(buf) -> (weakref, size class, charged) for every buffer a
        # caller currently holds; the weakref lets release() verify the id
        # (no stale-id confusion) and lets _sweep reclaim the charge of
        # buffers a caller dropped without releasing (GC'd views).
        # ``charged=False`` marks unmanaged transients (miss did not fit
        # capacity/budget): their bytes are real RSS the ledger could not
        # admit, tracked in the ``unmanaged_bytes`` gauge so over-budget
        # staging overshoot is visible instead of silent.
        self._outstanding: Dict[int, Tuple[weakref.ref, int, bool]] = {}
        self._lock = threading.Lock()
        self._region = None       # ledger region mirroring _held
        self._memory: Optional[NodeMemoryManager] = None
        self.stats = {
            "hits": 0,
            "misses": 0,
            "released": 0,
            "zero_bytes_avoided": 0,
            "rezeroed_bytes": 0,
            "unmanaged_allocs": 0,   # miss did not fit capacity/budget
            "unmanaged_bytes": 0,    # gauge: live unmanaged bytes right now
            "unmanaged_bytes_hw": 0, # high-water of that gauge
            "dropped_releases": 0,   # released buffer not pooled
            "gc_reclaimed_bytes": 0, # charges swept from GC'd buffers
        }

    # --------------------------------------------------------------- ledger
    def attach(self, memory: NodeMemoryManager) -> None:
        """Charge this pool's bytes to a node ledger: one region of kind
        ``pool`` mirrors ``held_bytes`` from here on."""
        with self._lock:
            if self._memory is memory:
                return
            old = self._region
            self._region = None
            self._memory = None
        if old is not None:
            old.release()
        region = memory.reserve(0, KIND_POOL, owner="buffer-pool", block=False)
        with self._lock:
            self._memory = memory
            self._region = region
            if self._held and not region.resize(self._held):
                # existing bytes exceed the budget: trim free lists until
                # the region (and therefore the ledger) matches reality
                self._trim_free_locked()

    def detach(self) -> None:
        with self._lock:
            region, self._region, self._memory = self._region, None, None
        if region is not None:
            region.release()

    # Charging helpers: called under self._lock.  Lock order is always
    # pool lock -> manager lock (the manager never calls into the pool).
    def _charge_locked(self, sc: int) -> bool:
        if self._held + sc > self.capacity:
            return False
        if self._region is not None and not self._region.resize(self._held + sc):
            return False
        self._held += sc
        return True

    def _uncharge_locked(self, sc: int) -> None:
        self._held -= sc
        if self._region is not None:
            self._region.resize(self._held)

    def _trim_free_locked(self) -> None:
        """Drop free buffers until the ledger admits the held bytes."""
        while self._region is not None and not self._region.resize(self._held):
            for sc, lst in self._free.items():
                if lst:
                    lst.pop()
                    self._held -= sc
                    break
            else:
                return  # nothing left to trim; outstanding bytes stand

    def _record_outstanding_locked(self, buf: np.ndarray, sc: int, charged: bool) -> None:
        """Register an acquired buffer, first settling any stale entry at
        the same id — a new allocation can reuse the address of a GC'd
        buffer that was never released, and blindly overwriting its entry
        would leak that charge forever (release() defends the same way)."""
        stale = self._outstanding.get(id(buf))
        if stale is not None and stale[0]() is not buf:
            if stale[2]:
                self._uncharge_locked(stale[1])
                self.stats["gc_reclaimed_bytes"] += stale[1]
            else:
                self.stats["unmanaged_bytes"] -= stale[1]
        self._outstanding[id(buf)] = (weakref.ref(buf), sc, charged)

    def _sweep_locked(self) -> None:
        """Reclaim charges of outstanding buffers that were GC'd without a
        release (e.g. a non-pipelined restore whose state tree was dropped)."""
        dead = [k for k, (ref, _sc, _c) in self._outstanding.items() if ref() is None]
        for key in dead:
            _, sc, charged = self._outstanding.pop(key)
            if charged:
                self._uncharge_locked(sc)
                self.stats["gc_reclaimed_bytes"] += sc
            else:
                self.stats["unmanaged_bytes"] -= sc

    def reclaim(self, nbytes: int, protect=frozenset()) -> int:
        """Ladder rung: drop free-list buffers (largest first) until
        ``nbytes`` are uncharged.  Free buffers are pure performance cache
        — zeroed staging waiting for the next restore — so they go before
        any warm state is sacrificed; outstanding buffers (in use by live
        restores) are never touched.  Returns the bytes freed."""
        freed = 0
        with self._lock:
            while freed < nbytes:
                for sc in sorted(self._free, reverse=True):
                    if self._free[sc]:
                        self._free[sc].pop()
                        self._uncharge_locked(sc)
                        freed += sc
                        break
                else:
                    break
        return freed

    # ----------------------------------------------------------------- API
    def prime(self, sizes_bytes: List[int]) -> None:
        """Pre-populate the pool (amortized, function-agnostic setup)."""
        for nb in sizes_bytes:
            sc = _size_class(nb)
            with self._lock:
                if not self._charge_locked(sc):
                    return
                self._free[sc].append(np.zeros(sc, np.uint8))

    def acquire(self, nbytes: int) -> np.ndarray:
        """Returns a zeroed uint8 buffer of >= nbytes (view of pool block).
        Misses are charged against capacity (and the node ledger when
        attached); an allocation that does not fit is an unmanaged
        transient, dropped at release instead of pooled."""
        sc = _size_class(nbytes)
        with self._lock:
            lst = self._free.get(sc)
            if lst:
                buf = lst.pop()
                self.stats["hits"] += 1
                self._record_outstanding_locked(buf, sc, True)
                return buf
            self.stats["misses"] += 1
            self._sweep_locked()
            charged = self._charge_locked(sc)
        buf = np.zeros(sc, np.uint8)
        with self._lock:
            self._record_outstanding_locked(buf, sc, charged)
            if not charged:
                self.stats["unmanaged_allocs"] += 1
                self.stats["unmanaged_bytes"] += sc
                self.stats["unmanaged_bytes_hw"] = max(
                    self.stats["unmanaged_bytes_hw"], self.stats["unmanaged_bytes"]
                )
        return buf

    def release(self, buf: np.ndarray, dirty: bool = True) -> None:
        sc = buf.nbytes
        with self._lock:
            entry = self._outstanding.pop(id(buf), None)
            if entry is not None and entry[0]() is not buf:
                # stale id-reuse entry: its buffer was GC'd — settle that
                # entry's books, and treat the released buffer as foreign
                if entry[2]:
                    self._uncharge_locked(entry[1])
                    self.stats["gc_reclaimed_bytes"] += entry[1]
                else:
                    self.stats["unmanaged_bytes"] -= entry[1]
                entry = None
            if entry is not None and not entry[2]:  # unmanaged transient
                self.stats["unmanaged_bytes"] -= entry[1]
                entry = None
            if entry is None:
                # over-capacity / unmanaged / foreign release: drop on the
                # floor, GC reclaims — it was never charged, so pooling it
                # would exceed capacity
                self.stats["dropped_releases"] += 1
                return
            if dirty and self.prezero:
                buf[:] = 0  # re-zero off the critical path (caller's thread)
                self.stats["rezeroed_bytes"] += sc
            self._free[sc].append(buf)
            self.stats["released"] += 1

    def note_zero_chunks(self, nbytes: int) -> None:
        with self._lock:
            self.stats["zero_bytes_avoided"] += nbytes

    @property
    def held_bytes(self) -> int:
        """Bytes under pool management: free lists + outstanding acquired
        buffers (thread-safe)."""
        with self._lock:
            self._sweep_locked()
            return self._held

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)
