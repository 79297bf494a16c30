"""Unified node memory subsystem — one ledger, region primitives, reclaim.

The paper's second pillar (after replay-free kernel restore) is dedicated OS
memory primitives that *reliably* materialize mappings: memory is reserved
before the prefetcher streams into it, population is tracked (never
advisory), and the node's byte budget is an invariant rather than an
estimate.  This module is the node-side reproduction of that contract:

* :class:`NodeMemoryManager` owns the node's entire byte budget.  Every
  byte the runtime holds — pool staging buffers, cached base images, warm
  working sets, residual tails, snapshot scratch — is charged to exactly
  one live :class:`MemoryRegion`, and::

      held_bytes() == sum(region.nbytes for live regions) <= budget

  holds at every transition (:meth:`NodeMemoryManager.audit` asserts it).

* **Region primitives** mirror the paper's mapping lifecycle:
  ``reserve(nbytes, kind)`` admits the bytes against the budget (fail fast
  or reclaim — never over-commit), ``populate()`` records the prefetcher's
  in-flight fill, ``commit(pinned=...)`` marks the region live (working
  set vs residual), ``release()`` returns the charge.

* **Registered reclaimers** replace per-subsystem private LRU loops: under
  pressure the manager walks reclaimers in ladder order — residual tails
  first (cheapest to re-restore), then device base copies, then the
  RAM-resident chunk CAS (re-readable from its disk CAS), then recoverable
  base images, then idle pool staging, then LRU warm instances — until the
  deficit is covered.
  Reclaimers run *outside* the manager lock, so they may release regions
  (and take their own locks) freely.

Charges are logical tensor bytes.  Two bounded forms of slack are
deliberately outside the ledger (documented, not hidden): a staging buffer
that is mid-flight between the pool free list and a region's device copy,
and an evicted image whose bytes a concurrent restore still references
until Python GC runs.  Both are transient and bounded by the I/O pipeline
depth — the ledger never *under*-admits because of them.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Tuple

__all__ = [
    "KIND_POOL",
    "KIND_IMAGE_CACHE",
    "KIND_DEVICE_IMAGE",
    "KIND_CHUNK_CAS",
    "KIND_WORKING_SET",
    "KIND_RESIDUAL",
    "KIND_SCRATCH",
    "MEMORY_KINDS",
    "MemoryPressureError",
    "MemoryRegion",
    "NodeMemoryManager",
]

# Region kinds — the per-kind ledger columns.
KIND_POOL = "pool"                # BufferPool free list + outstanding buffers
KIND_IMAGE_CACHE = "image_cache"  # NodeImageCache resident base images
KIND_DEVICE_IMAGE = "device_image"  # DeviceImageCache HBM-resident base pages
KIND_CHUNK_CAS = "chunk_cas"      # NodeChunkCache RAM-resident unique chunks
KIND_WORKING_SET = "working_set"  # pinned working-set bytes of an instance
KIND_RESIDUAL = "residual"        # residual (post-ws-boundary) bytes
KIND_SCRATCH = "scratch"          # transient snapshot/relayout staging

MEMORY_KINDS = (
    KIND_POOL, KIND_IMAGE_CACHE, KIND_DEVICE_IMAGE, KIND_CHUNK_CAS,
    KIND_WORKING_SET, KIND_RESIDUAL, KIND_SCRATCH,
)


class MemoryPressureError(RuntimeError):
    """A reservation could not be admitted within the node budget, even
    after running the reclaim ladder (and waiting, for blocking reserves)."""


class MemoryRegion:
    """One charged extent of the node budget.

    Lifecycle: ``reserved`` (admitted, prefetcher filling) → ``committed``
    (live, optionally pinned as working-set/residual) → ``released``.
    The charge is constant from reserve to release unless :meth:`resize`
    is used (pool free-list growth/shrink); ``populate`` and ``note_io``
    only track fill progress, they never change the charge — admission
    control happened at reserve time, which is what makes population
    guaranteed rather than advisory.
    """

    __slots__ = ("manager", "kind", "owner", "nbytes", "filled", "io_bytes",
                 "pinned", "_state")

    def __init__(self, manager: "NodeMemoryManager", kind: str, nbytes: int,
                 owner: Optional[str] = None):
        self.manager = manager
        self.kind = kind
        self.owner = owner
        self.nbytes = int(nbytes)
        self.filled = 0       # logical bytes the prefetcher has landed
        self.io_bytes = 0     # storage bytes read into this region
        self.pinned: Optional[str] = None
        self._state = "reserved"

    # ------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        return self._state

    @property
    def released(self) -> bool:
        return self._state == "released"

    # -------------------------------------------------------- transitions
    def populate(self, nbytes: int) -> None:
        """Record ``nbytes`` of in-flight fill landing in this region (the
        prefetcher calls this per finalized tensor)."""
        with self.manager._cv:
            self.filled = min(self.filled + int(nbytes), self.nbytes)

    def note_io(self, nbytes: int) -> None:
        """Record raw storage bytes read toward this region (called from
        the I/O scheduler's reader thread; PRIVATE chunks only, so
        ``io_bytes <= filled`` once the stream drains)."""
        with self.manager._cv:
            self.io_bytes += int(nbytes)

    def commit(self, pinned: Optional[str] = None) -> None:
        """Mark the region live.  ``pinned`` tags what the bytes are
        (``"working_set"`` / ``"residual"``) for the reclaim ladder."""
        with self.manager._cv:
            if self._state == "released":
                return
            self._state = "committed"
            if pinned is not None:
                self.pinned = pinned

    def resize(self, nbytes: int) -> bool:
        """Grow or shrink the charge in place (the pool's free list uses
        this).  Growth is admitted non-blocking against the budget; returns
        False (charge unchanged) when it does not fit.  Shrink always
        succeeds."""
        nbytes = int(nbytes)
        with self.manager._cv:
            if self._state == "released":
                return False
            delta = nbytes - self.nbytes
            if delta > 0 and not self.manager._fits_locked(delta):
                return False
            self.manager._charge_locked(self.kind, delta)
            self.nbytes = nbytes
            if delta < 0:
                self.filled = min(self.filled, self.nbytes)
                self.manager._cv.notify_all()
            return True

    def release(self) -> int:
        """Return the charge to the budget (idempotent).  Returns the bytes
        freed by THIS call (0 on a repeat release)."""
        with self.manager._cv:
            if self._state == "released":
                return 0
            freed = self.nbytes
            self._state = "released"
            self.manager._charge_locked(self.kind, -freed)
            self.manager._regions.discard(self)
            self.manager._cv.notify_all()
            return freed

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"MemoryRegion({self.kind}, {self.nbytes}B, {self._state}"
                + (f", pinned={self.pinned}" if self.pinned else "")
                + (f", owner={self.owner}" if self.owner else "") + ")")


class NodeMemoryManager:
    """The node's single memory ledger.

    ``budget_bytes=None`` means unlimited (accounting only, no admission
    control) — the semantics standalone restorers and zero-capacity pools
    relied on before this subsystem existed.
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._budget = budget_bytes
        self._held = 0
        self._by_kind: Dict[str, int] = {k: 0 for k in MEMORY_KINDS}
        self._hw: Dict[str, int] = {k: 0 for k in MEMORY_KINDS}
        self._hw_total = 0
        self._regions: set = set()
        # (order, name, fn) — fn(nbytes_needed, protect) -> bytes freed
        self._reclaimers: List[Tuple[int, str, Callable[[int, FrozenSet[str]], int]]] = []
        self._reclaim_lock = threading.Lock()  # serialize ladder walks
        self.stats = {
            "reserves": 0,
            "reclaims": 0,
            "reclaimed_bytes": 0,
            "pressure_waits": 0,
            "pressure_failures": 0,
        }

    # -------------------------------------------------------------- budget
    @property
    def budget(self) -> Optional[int]:
        return self._budget

    @budget.setter
    def budget(self, nbytes: Optional[int]) -> None:
        with self._cv:
            self._budget = nbytes
            over = 0 if nbytes is None else max(0, self._held - nbytes)
            self._cv.notify_all()
        if over:
            # shrinking below current residency runs the ladder so audit's
            # held <= budget invariant is restored; if the rungs cannot
            # cover it the node is genuinely over-budget and audit will
            # (correctly) flag that state
            self.reclaim(over)

    # ------------------------------------------------------ locked helpers
    def _fits_locked(self, delta: int) -> bool:
        return self._budget is None or self._held + delta <= self._budget

    def _charge_locked(self, kind: str, delta: int) -> None:
        self._held += delta
        self._by_kind[kind] = self._by_kind.get(kind, 0) + delta
        if delta > 0:
            self._hw[kind] = max(self._hw.get(kind, 0), self._by_kind[kind])
            self._hw_total = max(self._hw_total, self._held)

    # ------------------------------------------------------------- reserve
    def reserve(
        self,
        nbytes: int,
        kind: str,
        owner: Optional[str] = None,
        block: bool = True,
        timeout: float = 60.0,
        protect: Optional[Iterable[str]] = None,
    ) -> MemoryRegion:
        """Admit ``nbytes`` against the budget and return the region.

        When the reservation does not fit, the reclaim ladder runs (outside
        the manager lock); a ``block=True`` reserve then waits for releases
        up to ``timeout`` seconds, re-running reclaim as the deficit moves.
        Raises :class:`MemoryPressureError` when the bytes cannot be
        admitted — the caller fails fast instead of over-committing.
        ``protect`` names functions the ladder must not sacrifice (e.g. the
        instance this reservation is for)."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"negative reservation: {nbytes}")
        protect = frozenset(protect or ())
        deadline = time.monotonic() + timeout
        waited = False
        freed = 0
        last_walk = None
        while True:
            with self._cv:
                if self._fits_locked(nbytes):
                    region = MemoryRegion(self, kind, nbytes, owner)
                    self._charge_locked(kind, nbytes)
                    self._regions.add(region)
                    self.stats["reserves"] += 1
                    return region
                deficit = self._held + nbytes - self._budget
            # walk the ladder at most every ~200ms while blocked: each walk
            # takes every rung's locks, and re-walking on every 50ms wake
            # when nothing moved is pure contention (the fits check above
            # still reacts to releases immediately)
            now = time.monotonic()
            if last_walk is None or now - last_walk >= 0.2:
                freed = self.reclaim(deficit, protect=protect)
                last_walk = time.monotonic()
            with self._cv:
                if self._fits_locked(nbytes):
                    continue  # re-enter the admission check above
                if not block or time.monotonic() >= deadline:
                    self.stats["pressure_failures"] += 1
                    raise MemoryPressureError(
                        f"cannot reserve {nbytes} bytes of {kind!r}: "
                        f"held={self._held} budget={self._budget} "
                        f"(reclaimed {freed} last walk)"
                    )
                if not waited:
                    self.stats["pressure_waits"] += 1
                    waited = True
                self._cv.wait(timeout=0.05)

    # ------------------------------------------------------------ pressure
    def held_bytes(self) -> int:
        with self._cv:
            return self._held

    def kind_bytes(self) -> Dict[str, int]:
        with self._cv:
            return dict(self._by_kind)

    def high_water(self) -> Dict[str, int]:
        """Per-kind and total high-water marks since construction."""
        with self._cv:
            hw = dict(self._hw)
            hw["total"] = self._hw_total
            return hw

    def pressure(self) -> float:
        """Fraction of the budget currently held (0.0 with no budget)."""
        with self._cv:
            if not self._budget:
                return 0.0
            return self._held / self._budget

    def over_budget(self) -> int:
        """Bytes held above the budget (0 when within it / unlimited)."""
        with self._cv:
            if self._budget is None:
                return 0
            return max(0, self._held - self._budget)

    # -------------------------------------------------------------- reclaim
    def register_reclaimer(
        self, name: str, fn: Callable[[int, FrozenSet[str]], int], order: int
    ) -> None:
        """Register a reclaimer rung.  ``fn(nbytes, protect)`` frees up to
        ``nbytes`` (by releasing regions) and returns the bytes it freed.
        Lower ``order`` runs first — the node ladder is residual (0) →
        device-image (1) → chunk-cas (2) → image-cache (3) → pool
        staging (4) → LRU warm instances (5)."""
        with self._cv:
            self._reclaimers = sorted(
                [r for r in self._reclaimers if r[1] != name]
                + [(order, name, fn)]
            )

    def reclaim(self, nbytes: int, protect: Optional[Iterable[str]] = None) -> int:
        """Walk the reclaim ladder until ``nbytes`` are freed (or every rung
        is exhausted).  Runs reclaimers OUTSIDE the manager lock; walks are
        serialized so concurrent pressure does not stampede every rung."""
        if nbytes <= 0:
            return 0
        protect = frozenset(protect or ())
        with self._cv:
            rungs = list(self._reclaimers)
        freed = 0
        with self._reclaim_lock:
            for _, _name, fn in rungs:
                if freed >= nbytes:
                    break
                freed += int(fn(nbytes - freed, protect) or 0)
        if freed:
            # count only walks that freed something: a blocked reserve may
            # poll the ladder repeatedly within one pressure episode, and
            # empty walks would make the benchmark's reclaim count noise
            with self._cv:
                self.stats["reclaims"] += 1
                self.stats["reclaimed_bytes"] += freed
                self._cv.notify_all()
        return freed

    # ---------------------------------------------------------------- audit
    def audit(self) -> Dict[str, int]:
        """Assert the ledger invariant and return a consistent snapshot:
        ``sum(live region charges) == held_bytes() <= budget`` and the
        per-kind sums agree with the per-kind counters."""
        with self._cv:
            by_kind = {k: 0 for k in self._by_kind}
            total = 0
            for region in self._regions:
                by_kind[region.kind] = by_kind.get(region.kind, 0) + region.nbytes
                total += region.nbytes
            assert total == self._held, (
                f"ledger drift: sum(regions)={total} != held={self._held}"
            )
            for k, v in by_kind.items():
                assert v == self._by_kind.get(k, 0), (
                    f"ledger drift[{k}]: sum={v} != counter={self._by_kind.get(k, 0)}"
                )
            if self._budget is not None:
                assert self._held <= self._budget, (
                    f"over budget: held={self._held} > budget={self._budget}"
                )
            snap = dict(by_kind)
            snap["total"] = total
            snap["budget"] = -1 if self._budget is None else self._budget
            return snap

    def snapshot_stats(self) -> Dict[str, int]:
        with self._cv:
            return dict(self.stats)
