"""Cluster-wide content-addressed chunk store — dedup on disk and in RAM.

JIF v2 images already carry per-tensor blake2b chunk digests
(:mod:`repro_torch.core.digest`); this module promotes those digests to first-class
identity so thousands of fine-tunes of one base share ONE physical copy at
every layer:

* :class:`ChunkStore` — an on-disk CAS: one refcounted file per unique
  digest (``root/<hex[:2]>/<hex>``).  ``publish()`` ingests images at write
  time, so delta chains and sibling fine-tunes never store an identical
  chunk twice; restore reads chunks back by digest instead of re-pulling
  them from the (slow) image store.

* :class:`NodeChunkCache` — a node-resident read-only cache over the CAS.
  RAM-tier chunks are charged ONCE per unique digest to the node ledger
  under the ``chunk_cas`` kind, with their own reclaim-ladder rung
  (order 2: cheaper to drop than a host base image — a demoted chunk is one
  local CAS file read away, an evicted base is a full image restore).
  A pluggable ``peer_fetch`` hook (installed by the cluster router) pulls a
  missing chunk from whichever node already holds it over the simulated
  interconnect instead of re-reading the image store.

Thread-safety: both classes are locked internally.  The cache lock is taken
by restore worker threads, the reclaim ladder, and peer readers; no call
holds it while blocking on I/O against the manager lock — ``region.resize``
is non-blocking and never runs the ladder, which is what makes charging
under the cache lock deadlock-free (same contract as NodeImageCache).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.digest import DIGEST_BYTES, digest_key
from repro_torch.core.memory import KIND_CHUNK_CAS, NodeMemoryManager

__all__ = ["ChunkStore", "NodeChunkCache"]


class ChunkStore:
    """On-disk content-addressed store of refcounted chunk files.

    The refcount tracks logical owners (published image manifests, node
    caches holding the chunk).  A chunk file is unlinked when its count
    drops to zero; :meth:`audit` asserts files-on-disk == refcounted set.
    """

    def __init__(self, root: str, simulate_read_bw: Optional[float] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.simulate_read_bw = simulate_read_bw
        self._lock = threading.Lock()
        self._refs: Dict[bytes, int] = {}
        self.stats = {
            "puts": 0,
            "dedup_hits": 0,
            "bytes_stored": 0,
            "bytes_deduped": 0,
            "reads": 0,
            "bytes_read": 0,
            "unlinks": 0,
        }

    # ------------------------------------------------------------- layout
    def _path(self, digest: bytes) -> str:
        hx = digest.hex()
        return os.path.join(self.root, hx[:2], hx)

    # ------------------------------------------------------------- writes
    def put(self, digest, data) -> bool:
        """Store one chunk (or bump its refcount when already present).
        Returns True when the chunk was NEW — callers use this to count
        write-time dedup."""
        dk = digest_key(digest)
        with self._lock:
            if dk in self._refs:
                self._refs[dk] += 1
                self.stats["dedup_hits"] += 1
                self.stats["bytes_deduped"] += len(data)
                return False
            self._refs[dk] = 1
            self.stats["puts"] += 1
            self.stats["bytes_stored"] += len(data)
        p = self._path(dk)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(bytes(data))
        os.replace(tmp, p)
        return True

    def incref(self, digest) -> None:
        dk = digest_key(digest)
        with self._lock:
            if dk not in self._refs:
                raise KeyError(f"incref on absent chunk {dk.hex()}")
            self._refs[dk] += 1

    def decref(self, digest) -> bool:
        """Drop one reference; unlink the chunk file at zero.  Returns True
        when the chunk was removed from the store."""
        dk = digest_key(digest)
        with self._lock:
            n = self._refs.get(dk)
            if n is None:
                raise KeyError(f"decref on absent chunk {dk.hex()}")
            if n > 1:
                self._refs[dk] = n - 1
                return False
            del self._refs[dk]
            self.stats["unlinks"] += 1
        try:
            os.unlink(self._path(dk))
        except FileNotFoundError:
            pass
        return True

    def release_many(self, digests: Iterable) -> None:
        for dg in digests:
            self.decref(dg)

    # -------------------------------------------------------------- reads
    def contains(self, digest) -> bool:
        with self._lock:
            return digest_key(digest) in self._refs

    def refcount(self, digest) -> int:
        with self._lock:
            return self._refs.get(digest_key(digest), 0)

    def get(self, digest) -> Optional[bytes]:
        """Read one chunk's bytes (None when absent).  Applies the store's
        simulated read bandwidth, mirroring how the image store's reads are
        paced — a CAS hit is a LOCAL disk read, not free."""
        dk = digest_key(digest)
        with self._lock:
            if dk not in self._refs:
                return None
        try:
            with open(self._path(dk), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        if self.simulate_read_bw:
            time.sleep(len(data) / self.simulate_read_bw)
        with self._lock:
            self.stats["reads"] += 1
            self.stats["bytes_read"] += len(data)
        return data

    # ---------------------------------------------------------- ingestion
    def ingest_jif(self, path: str) -> Tuple[List[bytes], int, int]:
        """Walk a JIF's PRIVATE chunks and store each under its digest
        (one reference per occurrence).  Requires digests (v2 region or
        backfill sidecar).  Returns (digest per occurrence in data-segment
        order, unique_bytes stored, dup_bytes deduplicated)."""
        from repro_torch.core.jif import JifReader

        manifest: List[bytes] = []
        unique = dup = 0
        with JifReader(path) as r:
            ps = r.page_size
            r.ensure_digests()  # raises for delta v1 images w/o base
            for t in r.tensors:
                dgs = r.digests(t.name)
                for start, count, src in r.itable(t.name).private_runs():
                    raw = r.pread_chunks(src, count)
                    for j in range(count):
                        page = start + j
                        clen = min(ps, t.nbytes - page * ps)
                        dk = digest_key(dgs[page])
                        if self.put(dk, raw[j * ps : j * ps + clen]):
                            unique += clen
                        else:
                            dup += clen
                        manifest.append(dk)
        return manifest, unique, dup

    # -------------------------------------------------------------- audit
    def audit(self) -> Dict[str, int]:
        """Assert store invariants: every refcounted digest has its file on
        disk, every file on disk is refcounted, all counts positive."""
        with self._lock:
            refs = dict(self._refs)
        on_disk = set()
        for sub in os.listdir(self.root):
            d = os.path.join(self.root, sub)
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                if fn.endswith(".tmp"):
                    continue
                on_disk.add(bytes.fromhex(fn))
        ref_set = set(refs)
        assert on_disk == ref_set, (
            f"CAS drift: {len(on_disk - ref_set)} orphan files, "
            f"{len(ref_set - on_disk)} missing files"
        )
        assert all(n > 0 for n in refs.values()), "non-positive refcount"
        return {"chunks": len(refs), "refs": sum(refs.values())}


class NodeChunkCache:
    """Node-resident read-only chunk cache over a shared :class:`ChunkStore`.

    Two tiers: a RAM tier (LRU ``OrderedDict`` of digest → bytes, charged to
    the node ledger under ``chunk_cas``) and an implicit disk tier — every
    digest this node holds keeps ONE store reference, so demoting a chunk
    from RAM under pressure leaves it one local CAS read away.

    The cluster layer installs two hooks: ``announce`` (digest residency →
    the catalog's digest→holders index) and ``peer_fetch`` (pull a missing
    chunk from a holder over the simulated interconnect).
    """

    RECLAIM_ORDER = 2  # ladder rung: residual (0) -> device images (1) ->
    # chunk CAS -> image cache (3) -> pool (4) -> warm LRU (5).  RAM chunks
    # demote to the local disk CAS (cheap re-read); base images outrank them
    # because their eviction forces a full image re-restore.

    def __init__(
        self,
        store: ChunkStore,
        ram_capacity_bytes: int = 2 << 30,
        node: str = "node",
    ):
        self.store = store
        self.node = node
        self.capacity = ram_capacity_bytes
        self._lock = threading.Lock()
        self._ram: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._ram_bytes = 0
        # digests this node holds at least on the disk tier (each owns one
        # store reference, dropped only by drop()/release_all())
        self._held: set = set()
        self._memory: Optional[NodeMemoryManager] = None
        self._region = None  # ONE resizable chunk_cas region for the RAM tier
        # hooks wired by the cluster router
        self.announce: Callable[[str, bytes, bool], None] = lambda node, dg, present: None
        self.peer_fetch: Optional[Callable[[bytes], Optional[bytes]]] = None
        self.stats = {
            "ram_hits": 0,
            "cas_hits": 0,
            "peer_hits": 0,
            "misses": 0,
            "ingests": 0,
            "demotions": 0,
            "ram_rejects": 0,
            "bytes_served_ram": 0,
            "bytes_served_cas": 0,
            "bytes_served_peer": 0,
        }

    # --------------------------------------------------------------- ledger
    def attach(self, memory: NodeMemoryManager) -> None:
        """Charge the RAM tier to the node ledger and register this cache's
        demotion as the ladder's chunk-cas reclaimer."""
        with self._lock:
            if self._memory is memory:
                return
            self._memory = memory
            nbytes = self._ram_bytes
        region = memory.reserve(nbytes, KIND_CHUNK_CAS, owner=f"chunk-cas:{self.node}")
        region.commit()
        with self._lock:
            self._region = region
        memory.register_reclaimer("chunk-cas", self.reclaim, self.RECLAIM_ORDER)

    def _charge_to(self, nbytes: int) -> bool:
        """Resize the RAM-tier region to ``nbytes`` (under self._lock).
        Non-blocking: never runs the reclaim ladder (lock order is always
        cache → manager).  True when the charge fits."""
        if self._region is None:
            return True
        return self._region.resize(nbytes)

    # --------------------------------------------------------------- writes
    def ingest(self, digest, data) -> None:
        """Install one chunk this node now holds: store it in the CAS (one
        reference per node), cache it in RAM, announce residency."""
        dk = digest_key(digest)
        data = bytes(data)
        with self._lock:
            if dk in self._held:
                self._insert_ram_locked(dk, data)
                return
        self.store.put(dk, data)
        announce = False
        with self._lock:
            if dk not in self._held:
                self._held.add(dk)
                self.stats["ingests"] += 1
                announce = True
            else:
                self.store.decref(dk)  # raced with another ingest of dk
            self._insert_ram_locked(dk, data)
        if announce:
            self.announce(self.node, dk, True)

    def _insert_ram_locked(self, dk: bytes, data: bytes) -> None:
        if dk in self._ram:
            self._ram.move_to_end(dk)
            return
        new_total = self._ram_bytes + len(data)
        if new_total > self.capacity or not self._charge_to(new_total):
            # no RAM room (capacity or ledger): the chunk still lives on
            # the disk tier — correctness never depends on the RAM tier
            self.stats["ram_rejects"] += 1
            return
        self._ram[dk] = data
        self._ram_bytes = new_total

    # ---------------------------------------------------------------- reads
    def probe(self, digest) -> Optional[str]:
        """Non-mutating residency probe for restore PLANNING: ``"ram"`` /
        ``"cas"`` / None.  No LRU bump, no stats — plans must not bias the
        cache they are about to read."""
        dk = digest_key(digest)
        with self._lock:
            if dk in self._ram:
                return "ram"
            if dk in self._held:
                return "cas"
        return None

    def get(self, digest) -> Optional[bytes]:
        """RAM-tier read (LRU bump).  None on RAM miss — callers fall
        through to :meth:`get_cas` / :meth:`fetch_peer` explicitly because
        each tier has different cost accounting."""
        dk = digest_key(digest)
        with self._lock:
            data = self._ram.get(dk)
            if data is None:
                return None
            self._ram.move_to_end(dk)
            self.stats["ram_hits"] += 1
            self.stats["bytes_served_ram"] += len(data)
            return data

    def get_cas(self, digest) -> Optional[bytes]:
        """Disk-tier read: pull the chunk from the local CAS file (paced by
        the store's simulated bandwidth) and promote it back to RAM."""
        dk = digest_key(digest)
        with self._lock:
            if dk not in self._held:
                return None
        data = self.store.get(dk)
        if data is None:
            return None
        with self._lock:
            self.stats["cas_hits"] += 1
            self.stats["bytes_served_cas"] += len(data)
            self._insert_ram_locked(dk, data)
        return data

    def fetch_peer(self, digest) -> Optional[bytes]:
        """Pull a chunk from a peer node over the interconnect (hook wired
        by the router).  A successful fetch installs the chunk locally, so
        the next tenant's restore hits RAM/CAS instead of the wire."""
        if self.peer_fetch is None:
            return None
        dk = digest_key(digest)
        data = self.peer_fetch(dk)
        if data is None:
            return None
        with self._lock:
            self.stats["peer_hits"] += 1
            self.stats["bytes_served_peer"] += len(data)
        self.ingest(dk, data)
        return data

    def peek(self, digest) -> Optional[bytes]:
        """Serve a chunk TO a peer: RAM first (no LRU bump — a peer read is
        not local reuse), else local CAS file, else None."""
        dk = digest_key(digest)
        with self._lock:
            data = self._ram.get(dk)
            if data is not None:
                return data
            if dk not in self._held:
                return None
        return self.store.get(dk)

    def holds(self, digest) -> bool:
        with self._lock:
            return digest_key(digest) in self._held

    def held_count(self) -> int:
        with self._lock:
            return len(self._held)

    def ram_bytes(self) -> int:
        with self._lock:
            return self._ram_bytes

    # -------------------------------------------------------------- reclaim
    def reclaim(self, nbytes: int, protect=frozenset()) -> int:
        """Ladder rung 2: demote LRU RAM chunks to the disk tier until
        ``nbytes`` are freed.  The store keeps this node's reference, so a
        demoted chunk costs one local CAS read to come back — never a pull
        from the image store or a peer."""
        freed = 0
        with self._lock:
            while self._ram and freed < nbytes:
                dk, data = self._ram.popitem(last=False)
                self._ram_bytes -= len(data)
                freed += len(data)
                self.stats["demotions"] += 1
            if freed:
                self._charge_to(self._ram_bytes)  # shrink always succeeds
        return freed

    # ------------------------------------------------------------- teardown
    def drop(self, digest) -> None:
        """Forget one chunk entirely (both tiers) and return its store ref."""
        dk = digest_key(digest)
        with self._lock:
            if dk not in self._held:
                return
            self._held.discard(dk)
            data = self._ram.pop(dk, None)
            if data is not None:
                self._ram_bytes -= len(data)
                self._charge_to(self._ram_bytes)
        self.store.decref(dk)
        self.announce(self.node, dk, False)

    def release_all(self) -> None:
        """Drop every held chunk and release the ledger region (node
        teardown)."""
        with self._lock:
            held = list(self._held)
            self._held.clear()
            self._ram.clear()
            self._ram_bytes = 0
            region, self._region = self._region, None
        for dk in held:
            self.store.decref(dk)
            self.announce(self.node, dk, False)
        if region is not None:
            region.release()

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            d = dict(self.stats)
            d["held_chunks"] = len(self._held)
            d["ram_bytes"] = self._ram_bytes
            return d
