"""Cluster serving layer: control plane / data plane split + N-node routing.

The paper's thesis — disk-resident snapshots make memory elasticity free —
only pays off when a fleet can place any function on any node and still get
near-warm restores.  This module supplies the two layers that make that
expressible:

* :class:`FunctionCatalog` — the CONTROL PLANE.  Owns the
  :class:`~repro_torch.core.registry.FunctionRegistry` and the offline snapshot
  authoring path (``publish`` with pre-warm tracing, delta publishing
  against a parent JIF, ``record_access`` → ``relayout`` bookkeeping,
  registry persistence).  One catalog serves any number of nodes; it never
  touches live tenant state except through a node's explicit data-plane
  mechanisms (:meth:`~repro_torch.serve.node.NodeScheduler.trace_warm`,
  :meth:`~repro_torch.serve.node.NodeScheduler.warm_state`).

* :class:`ClusterRouter` — the DATA-PLANE FRONT DOOR.  Places invocations
  across N :class:`~repro_torch.serve.node.NodeScheduler`\\ s through a pluggable
  :class:`PlacementPolicy`, reading each node's
  :class:`~repro_torch.serve.node.NodeLoad` probe (queue depth, memory pressure,
  prefetcher backlog, warm/restoring sets, resident images).

Routing contract:

* **Sticky routing / single population per cluster** — a sticky policy
  (``LocalityFirst``, the default) pins each function to the node that
  first restored it; concurrent invocations of one function land on that
  node and *join* the in-flight restore there, so a single-replica
  function never pays two concurrent cold restores anywhere in the
  cluster.
* **Snapshot locality** — ``LocalityFirst`` ranks candidate nodes
  warm > joinable in-flight > base-image-cached > delta-parent-cached >
  least-loaded: a node that holds the function's base image (or the parent
  of its delta chain) restores it reading only private chunks, which is
  the whole point of disk-resident snapshots.
* **Scale-out knob** — with ``scale_out_queue_depth=K``, a function whose
  least-loaded replica has K or more invocations in flight gets a second
  replica placed by the same policy (opt-in; capped at the node count).

``RoundRobin`` and ``LeastLoaded`` are non-sticky baselines: they place
every request independently, which is exactly the placement regime the
cluster benchmark (``benchmarks/cluster.py``) compares against.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    ChunkStore,
    FunctionRegistry,
    FunctionSpec,
    NodeImageCache,
    SpiceRestorer,
    snapshot,
)
from repro_torch.core import baselines
from repro_torch.core.memory import NodeMemoryManager
from repro_torch.core.snapshot import SnapshotStats
from repro_torch.core.trace import trace_access_order
from repro_torch.device import resolve_device
from repro_torch.serve.instance import generate, layerwise_state
from repro_torch.serve.invocation import (
    Invocation,
    InvocationHandle,
    Overloaded,
    QosClass,
)
from repro_torch.serve.node import InvokeResult, NodeLoad, NodeScheduler

__all__ = [
    "FunctionCatalog",
    "ClusterRouter",
    "PlacementPolicy",
    "LocalityFirst",
    "RoundRobin",
    "LeastLoaded",
]


# ------------------------------------------------------------ control plane
class FunctionCatalog:
    """The serving stack's control plane: registry ownership + snapshot
    authoring.  Shared by every node of a cluster (nodes hold a reference
    to ``catalog.registry`` and resolve invocations through it).

    ``base_images`` is the *authoring-side* image cache: ``publish``
    classifies against bases installed here.  A single-node deployment
    shares it with the node's serving cache (the facade wires that up); a
    multi-node cluster instead publishes deltas against a parent JIF on
    disk, which every node can bootstrap on demand
    (``BaseImage.from_jif``) — disk, not any one node's RAM, is the
    cluster-wide source of truth.
    """

    def __init__(
        self,
        registry: Optional[FunctionRegistry] = None,
        base_images: Optional[NodeImageCache] = None,
        chunk_store: Optional[ChunkStore] = None,
        device=None,
    ):
        """``device`` (None: the GPU) runs publish's pre-warm trace."""
        self.registry = registry or FunctionRegistry()
        self.device = resolve_device(device)
        self.base_images = base_images or NodeImageCache()
        # cluster-wide content-addressed store: publish()/relayout() ingest
        # every image's chunks, so delta chains and sibling fine-tunes never
        # store an identical chunk twice; None = dedup off
        self.chunk_store = chunk_store
        # warmth-policy feed (repro_torch.serve.prewarm.ArrivalTracker): wired by
        # a router with a PrewarmEngine; record_access (a warm generation on
        # live traffic) counts as demand evidence for the function too
        self.arrival_tracker = None
        self._lock = threading.Lock()
        # recorded first-touch orders from warm generations (relayout feed)
        self._recorded: Dict[str, List[str]] = {}
        # fname -> (jif identity, base-ref name) for placement locality
        self._locality: Dict[str, Tuple[Tuple[str, int, int], Optional[str]]] = {}
        # digest -> node names holding the chunk (peer-fetch routing), fed
        # by NodeChunkCache announce hooks the router wires up
        self._chunk_holders: Dict[bytes, set] = {}
        # fname -> published manifest (one store ref per chunk occurrence;
        # a republish/relayout returns the OLD manifest's refs)
        self._chunk_manifests: Dict[str, List[bytes]] = {}
        # fname -> SnapshotStats of its last publish (delta economics feed
        # for the deployment pipeline: private_bytes vs total_bytes)
        self._publish_stats: Dict[str, SnapshotStats] = {}
        self._handoff_seq = 0  # unique handoff image names (per catalog)
        self.stats = {
            "publishes": 0,
            "relayouts": 0,
            "handoffs": 0,
            "chunks_published": 0,
            "chunk_bytes_unique": 0,
            "chunk_bytes_deduped": 0,
        }

    def _bump(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def install_base(self, img, evictable: bool = False) -> None:
        """Install an operator-provided base image into the authoring cache
        (pinned by default: there is no JIF behind it to recover from)."""
        self.base_images.put(img, evictable=evictable)

    # ------------------------------------------------- chunk store (dedup)
    def _ingest_chunks(self, fname: str, jif_path: str) -> None:
        """Write-time dedup: push the image's chunks into the CAS (one ref
        per occurrence) and swap the function's manifest.  A v1 image whose
        digests cannot be backfilled standalone (delta with BASE chunks)
        just skips dedup — never fails the publish."""
        if self.chunk_store is None:
            return
        try:
            manifest, unique, dup = self.chunk_store.ingest_jif(jif_path)
        except ValueError:
            return
        with self._lock:
            old = self._chunk_manifests.get(fname)
            self._chunk_manifests[fname] = manifest
            self.stats["chunks_published"] += len(manifest)
            self.stats["chunk_bytes_unique"] += unique
            self.stats["chunk_bytes_deduped"] += dup
        if old:
            self.chunk_store.release_many(old)

    def announce_chunk(self, node: str, digest: bytes, present: bool) -> None:
        """Node residency feed for the digest→holders index (wired to each
        NodeChunkCache by the router)."""
        with self._lock:
            holders = self._chunk_holders.setdefault(digest, set())
            if present:
                holders.add(node)
            else:
                holders.discard(node)
                if not holders:
                    del self._chunk_holders[digest]

    def chunk_holders(self, digest: bytes) -> Tuple[str, ...]:
        """Nodes currently holding ``digest`` (RAM or disk tier)."""
        with self._lock:
            return tuple(self._chunk_holders.get(digest, ()))

    # -------------------------------------------------------------- publish
    def publish(
        self,
        name: str,
        cfg: ModelConfig,
        params,
        dirpath: str,
        base_name: Optional[str] = None,
        parent: Optional[str] = None,
        warm_ttl_s: float = 0.0,
        formats: Tuple[str, ...] = ("jif", "criu", "monolith"),
        extra_state: Optional[Any] = None,
        memory: Optional[NodeMemoryManager] = None,
    ) -> FunctionSpec:
        """Offline JIF preparation: layerwise layout, pre-warm + trace,
        access-order relocation, dedup vs an in-memory base (``base_name``)
        or a parent JIF on disk (``parent`` — delta publishing: any node
        can bootstrap the parent from the snapshot store, no pre-installed
        base required); also writes the baselines' formats for comparison.
        ``memory`` (a node's ledger) charges the writer's state copy as
        scratch so publishing competes with live tenants honestly."""
        if base_name is not None and parent is not None:
            raise ValueError("pass either base_name= or parent=, not both")
        os.makedirs(dirpath, exist_ok=True)
        state = layerwise_state(cfg, params)

        # pre-warm trace: run one tiny invocation under the recorder; the
        # recorder's lazy leaves record first touch when generation resolves
        # them (once per layer, straight onto the device).
        # ``touched`` is the traced working set; untouched stragglers (and
        # any extra_state below) land after the ws boundary as residual.
        def run(view):
            generate(cfg, None, view, np.zeros((1, 4), np.int32), 2,
                     device=self.device)

        order, touched = trace_access_order(
            state, run, max_iters=2, return_touched=True
        )
        jif_path = f"{dirpath}/{name}.jif"
        base = self.base_images.get(base_name)
        if "jif" in formats:
            full_state = state
            if extra_state is not None:
                # VM-style snapshots capture scratch/optimizer memory too;
                # in the JIF it streams as residual behind the ws boundary
                full_state = dict(state)
                full_state["__extra__"] = extra_state
            stats = snapshot(
                full_state,
                jif_path,
                base=base,
                parent=parent,
                access_order=order,
                working_set=touched,
                meta={"arch": cfg.name, "function": name},
                memory=memory,
            )
            with self._lock:
                self._publish_stats[name] = stats
            self._ingest_chunks(name, jif_path)
        if "criu" in formats:
            baselines.criu_star_snapshot(state, f"{dirpath}/{name}.criu")
        if "monolith" in formats:
            baselines.monolith_snapshot(
                state, f"{dirpath}/{name}.mono", extra_state=extra_state
            )
        spec = FunctionSpec(
            name=name, arch=cfg.name, jif_path=jif_path, base_image=base_name,
            warm_ttl_s=warm_ttl_s,
        )
        self.registry.register(spec)
        self._bump("publishes")
        return spec

    def publish_stats(self, name: str) -> Optional[SnapshotStats]:
        """SnapshotStats of ``name``'s last JIF publish (None before any):
        ``private_bytes`` is what the publish actually cost in new storage —
        the per-version delta economics the rollout pipeline reports."""
        with self._lock:
            return self._publish_stats.get(name)

    def unpublish(self, name: str, unlink: bool = False) -> Optional[FunctionSpec]:
        """Retire a published function: release its CAS manifest refs
        (chunks no other image references are unlinked from the store),
        drop the catalog's bookkeeping, and unregister the spec.  With
        ``unlink=True`` the JIF file itself is deleted — the CALLER
        guarantees no live delta child still chains to it on disk (the
        rollout controller refuses to retire a version with live
        descendants for exactly this reason).  Returns the retired spec,
        or None if the name was never registered."""
        with self._lock:
            manifest = self._chunk_manifests.pop(name, None)
            self._publish_stats.pop(name, None)
            self._recorded.pop(name, None)
            self._locality.pop(name, None)
        if manifest and self.chunk_store is not None:
            self.chunk_store.release_many(manifest)
        spec = self.registry.unregister(name)
        if unlink and spec is not None:
            try:
                os.unlink(spec.jif_path)
            except OSError:
                pass
        return spec

    # ------------------------------------------------------------- locality
    def locality_key(self, fname: str) -> Optional[str]:
        """The node-cache key a restore of ``fname`` will look up (its
        in-memory base name, or its delta parent's cache key) — what
        placement means by "snapshot locality".  Read once from the JIF
        header and memoized against the file's identity (a relayout
        rewrites the file in place and may change the ref)."""
        spec = self.registry.get(fname)
        try:
            st = os.stat(spec.jif_path)
        except OSError:
            return spec.base_image
        ident = (spec.jif_path, st.st_mtime_ns, st.st_size)
        with self._lock:
            hit = self._locality.get(fname)
            if hit is not None and hit[0] == ident:
                return hit[1]
        from repro_torch.core.jif import JifReader

        try:
            with JifReader(spec.jif_path) as r:
                ref = r.base_ref
        except Exception:
            return spec.base_image
        key = ref.get("name") if ref else None
        with self._lock:
            self._locality[fname] = (ident, key)
        return key

    # ---------------------------------------------------- record → relayout
    def record_access(
        self,
        fname: str,
        node: NodeScheduler,
        prompt: Optional[np.ndarray] = None,
        max_new_tokens: int = 4,
        cfg: Optional[ModelConfig] = None,
    ) -> List[str]:
        """Trace one warm generation on ``node`` (the instance must be WARM
        there) and keep the observed first-touch order for
        :meth:`relayout`.  Returns the touched order."""
        order = node.trace_warm(fname, prompt, max_new_tokens, cfg)
        with self._lock:
            self._recorded[fname] = order
        if self.arrival_tracker is not None:
            self.arrival_tracker.record(fname)
        return order

    def recorded_order(self, fname: str) -> Optional[List[str]]:
        with self._lock:
            return self._recorded.get(fname)

    def relayout(
        self,
        fname: str,
        order: Optional[List[str]] = None,
        node: Optional[NodeScheduler] = None,
    ) -> SnapshotStats:
        """Re-snapshot a function with the recorded first-touch order: the
        JIF data segment is rewritten so the observed working set sits in
        front of the boundary — closing the record → relayout → faster-TTFT
        loop.  Uses ``node``'s warm instance state when resident (zero
        storage reads), else restores the current image from disk once.
        A delta-published function is rewritten as a delta against the
        SAME parent JIF — dropping the chain would balloon the file to
        full size and erase its placement locality key."""
        from repro_torch.core.jif import JifReader

        spec = self.registry.get(fname)
        if order is None:
            order = self.recorded_order(fname)
        if order is None:
            raise RuntimeError(
                f"{fname}: no recorded access order — call record_access first"
            )
        with JifReader(spec.jif_path) as r:
            ref = r.base_ref
        parent = ref.get("path") if ref else None
        state = node.warm_state(fname) if node is not None else None
        if state is None:
            restorer = SpiceRestorer(
                pool=node.pool if node is not None else None,
                node_cache=(
                    node.node_cache if node is not None else self.base_images
                ),
                pipelined=False,
                iosched=node.iosched if node is not None else None,
            )
            state, _, _, _ = restorer.restore(spec.jif_path)
        stats = snapshot(
            state,
            spec.jif_path,
            base=None if parent else self.base_images.get(spec.base_image),
            parent=parent,
            access_order=order,
            working_set=order,
            meta={"arch": spec.arch, "function": fname, "relayout": True},
            # rewrite copy charged as scratch against the tracing node
            memory=node.memory if node is not None else None,
        )
        # the rewrite changed the data segment: re-ingest under the new
        # identity (the old manifest's refs are returned — chunks no other
        # image or node references are unlinked from the CAS)
        self._ingest_chunks(fname, spec.jif_path)
        self._bump("relayouts")
        return stats

    # ------------------------------------------------- warm-state handoff
    def publish_handoff(
        self,
        fname: str,
        state: Dict[str, np.ndarray],
        dirpath: str,
        memory: Optional[NodeMemoryManager] = None,
    ) -> Tuple[str, SnapshotStats]:
        """Snapshot a node's LIVE warm state as a delta against the
        function's own published image (``repro_torch.core.delta_snapshot``) and
        ingest it into the chunk CAS under a handoff-scoped manifest key.

        Because warm generation is read-only over the restored tree, the
        delta's private payload is the dirty warm state only — typically
        KBs against a multi-MB image — and every base chunk the successor
        node needs is already CAS-resident / peer-fetchable from the
        original publish.  Returns ``(handoff_jif_path, stats)``;
        ``stats.private_bytes`` is the handoff's wire cost.  ``memory``
        charges the snapshot writer's state copy as scratch against the
        source node so draining competes with live tenants honestly.

        The registry is never touched: the successor restores the handoff
        image via ``Invocation(jif_override=...)``, and
        :meth:`retire_handoff` drops the manifest (and the file) once the
        successor is WARM."""
        from repro_torch.core import delta_snapshot

        spec = self.registry.get(fname)
        os.makedirs(dirpath, exist_ok=True)
        with self._lock:
            self._handoff_seq += 1
            seq = self._handoff_seq
        path = os.path.join(dirpath, f"{fname}.handoff{seq}.jif")
        stats = delta_snapshot(
            state,
            path,
            parent=spec.jif_path,
            meta={"arch": spec.arch, "function": fname, "handoff": True},
            node_cache=self.base_images,
            memory=memory,
        )
        self._ingest_chunks(self._handoff_key(fname, path), path)
        self._bump("handoffs")
        return path, stats

    @staticmethod
    def _handoff_key(fname: str, path: str) -> str:
        # manifest key disjoint from the function's own publish key, so a
        # handoff never swaps (and releases) the published image's manifest
        return f"{fname}#handoff:{path}"

    def retire_handoff(self, fname: str, path: str, unlink: bool = True) -> None:
        """Release a handoff image's CAS refs (chunks no other image or
        node references are unlinked) and optionally delete the file."""
        with self._lock:
            manifest = self._chunk_manifests.pop(self._handoff_key(fname, path), None)
        if manifest and self.chunk_store is not None:
            self.chunk_store.release_many(manifest)
        if unlink:
            try:
                os.unlink(path)
            except OSError:
                pass

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Persist the registry (the catalog's durable state — recorded
        orders are advisory and rebuilt from live traffic)."""
        self.registry.save(path)

    @classmethod
    def load(cls, path: str, base_images: Optional[NodeImageCache] = None,
             device=None) -> "FunctionCatalog":
        return cls(registry=FunctionRegistry.load(path), base_images=base_images,
                   device=device)


# -------------------------------------------------------- placement policies
class PlacementPolicy:
    """Picks a node index for one invocation.  ``place`` sees the function's
    spec, its snapshot-locality key (:meth:`FunctionCatalog.locality_key`),
    and one :class:`NodeLoad` per candidate; it returns an index into that
    candidate list.  ``sticky`` policies place each function once and the
    router pins it (replicas only grow through the scale-out knob);
    non-sticky policies place every request independently."""

    name = "policy"
    sticky = False
    # policies that ignore the probes (RoundRobin) set this False and the
    # router skips the per-request O(N × locks) load collection; place()
    # then receives placeholder NodeLoad()s of the right length
    needs_loads = True

    def place(
        self, spec: FunctionSpec, key: Optional[str], loads: Sequence[NodeLoad]
    ) -> int:
        raise NotImplementedError

    def place_urgent(
        self, spec: FunctionSpec, key: Optional[str], loads: Sequence[NodeLoad]
    ) -> int:
        """Deadline/LATENCY-aware placement: where ``place`` optimizes for
        locality or fairness, ``place_urgent`` optimizes for time-to-first-
        token NOW — a warm-holding node with a shallow queue beats a
        locality match behind a deep one.  Default: warm first, then
        least-loaded; policies may override."""
        return min(
            range(len(loads)),
            key=lambda i: (
                spec.name not in loads[i].warm,
                loads[i].queue_depth,
                loads[i].pending_io_bytes,
                loads[i].pressure,
            ),
        )

    @staticmethod
    def _least_loaded(loads: Sequence[NodeLoad]) -> int:
        return min(
            range(len(loads)),
            key=lambda i: (
                loads[i].queue_depth,
                loads[i].pending_io_bytes,
                loads[i].pressure,
            ),
        )


class LocalityFirst(PlacementPolicy):
    """warm > joinable in-flight > base-image-cached > delta-parent-cached >
    least-loaded; ties inside a tier break toward the least-loaded node."""

    name = "locality_first"
    sticky = True

    def place(self, spec, key, loads):
        def tier(load: NodeLoad) -> int:
            if spec.name in load.warm:
                return 0
            if spec.name in load.restoring:
                return 1
            if spec.base_image is not None and spec.base_image in load.images:
                return 2
            if key is not None and key in load.images:
                return 3
            return 4

        return min(
            range(len(loads)),
            key=lambda i: (
                tier(loads[i]),
                loads[i].queue_depth,
                loads[i].pending_io_bytes,
                loads[i].pressure,
            ),
        )


class RoundRobin(PlacementPolicy):
    """Spread requests blindly — the no-locality baseline."""

    name = "round_robin"
    sticky = False
    needs_loads = False

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0

    def place(self, spec, key, loads):
        with self._lock:
            idx = self._next % len(loads)
            self._next += 1
        return idx

    def place_urgent(self, spec, key, loads):
        # the base-class default ranks loads — but round-robin never probes
        # (needs_loads=False), so every load is an identical placeholder
        # and min() would pin ALL urgent traffic to node 0; keep rotating
        return self.place(spec, key, loads)


class LeastLoaded(PlacementPolicy):
    """Pure load balancing: ignore snapshot locality entirely."""

    name = "least_loaded"
    sticky = False

    def place(self, spec, key, loads):
        return self._least_loaded(loads)


_EMPTY_LOAD = NodeLoad()  # placeholder for needs_loads=False policies


# ---------------------------------------------------------------- the router
class ClusterRouter:
    """Places invocations across N node data planes (see module docstring
    for the routing contract).  The router adopts registry ownership onto
    its nodes: every node resolves specs through ``catalog.registry``."""

    def __init__(
        self,
        catalog: FunctionCatalog,
        nodes: Sequence[NodeScheduler],
        placement: Optional[PlacementPolicy] = None,
        scale_out_queue_depth: Optional[int] = None,
        latency_spill_depth: int = 2,
        urgent_deadline_s: float = 1.0,
        interconnect_bw: Optional[float] = None,
        prewarm=None,
        load_cache_ttl_s: float = 0.005,
    ):
        """``latency_spill_depth``: an urgent invocation (LATENCY class, or
        a deadline within ``urgent_deadline_s``) whose sticky replica has
        this many invocations in flight steals a replica on the node
        ``place_urgent`` picks instead of queueing — BATCH work waits where
        LATENCY work scales out.

        ``scale_out_queue_depth`` is DEPRECATED as a scaling mechanism: it
        is a static per-function replica-growth threshold, kept as an alias
        for existing callers.  New deployments should drive replica and
        node count through :class:`repro_torch.serve.autoscale.AutoScaler`, which
        reacts to declared SLOs instead of a fixed queue depth.

        ``load_cache_ttl_s`` bounds the cost of placement probes at fleet
        scale: the router sets it as every node's ``load_ttl_s``, so a
        placement decision over 50 nodes reads 50 cached snapshots instead
        of taking 50 × several locks per request.  Staleness is bounded by
        the TTL *and* by instance lifecycle edges (any state transition
        invalidates that node's cached probe immediately); 0 disables
        caching.

        ``interconnect_bw`` (bytes/s) paces peer chunk transfers between
        nodes with chunk caches, modeling the node-to-node fabric the same
        way ``simulate_read_bw``/``simulate_upload_bw`` model storage and
        PCIe (labeled benchmark runs only; None = instantaneous).

        ``prewarm`` (a :class:`repro_torch.serve.prewarm.PrewarmEngine`) turns
        on predictive warmth management: every real ``submit_invocation``
        feeds its arrival tracker, and the engine speculates restores
        back through this router (BATCH class, ``prewarm=True``) so
        placement, admission, QoS ordering and restore joining all apply
        unchanged.  ``close()`` stops the engine with the fleet."""
        if not nodes:
            raise ValueError("a cluster needs at least one node")
        self.catalog = catalog
        self.nodes: List[NodeScheduler] = list(nodes)
        taken = {n.name for n in self.nodes if n.name}
        for i, node in enumerate(self.nodes):
            node.registry = catalog.registry  # control plane owns the registry
            if not node.name and len(self.nodes) > 1:
                # single-node paths keep node=""; skip caller-taken names
                name = f"node{i}"
                while name in taken:
                    name = f"{name}x"
                node.name = name
                taken.add(name)
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"node names must be unique, got {names}")
        self.placement = placement or LocalityFirst()
        self.scale_out_queue_depth = scale_out_queue_depth
        self.latency_spill_depth = latency_spill_depth
        self.urgent_deadline_s = urgent_deadline_s
        self.interconnect_bw = interconnect_bw
        self.load_cache_ttl_s = load_cache_ttl_s
        self._lock = threading.Lock()
        self._closed = False
        self._assign: Dict[str, List[str]] = {}  # sticky fname -> node names
        self._draining: set = set()  # node names excluded from placement
        # name -> live chunk cache (peer-fetch closures read this at call
        # time, so nodes added later serve peers immediately)
        self._chunk_caches: Dict[str, Any] = {}
        self.stats = {
            "routed": 0,
            "scale_outs": 0,
            "latency_steals": 0,
            "peer_fetches": 0,
            "peer_fetch_bytes": 0,
            "nodes_added": 0,
            "nodes_removed": 0,
        }
        for node in self.nodes:
            node.load_ttl_s = load_cache_ttl_s
            self._wire_node_chunks(node)
        self.prewarm = prewarm
        if prewarm is not None:
            prewarm.attach(self)
        # staged-rollout resolver (repro_torch.serve.deploy.RolloutController):
        # rewrites a logical function name to the stable/canary version
        # name per invocation, BEFORE placement — set by its attach()
        self.deploy = None

    def _wire_node_chunks(self, node: NodeScheduler) -> None:
        """Connect one node's chunk cache to the cluster: residency
        announcements feed the catalog's digest→holders index, and the
        peer-fetch hook pulls a missing chunk from whichever peer holds it
        (paced by ``interconnect_bw``) instead of re-reading the image
        store.  The peer serves via ``peek`` — RAM first, else its local
        CAS file — so a transfer never perturbs the holder's LRU."""
        import time as _time

        if node.chunks is None:
            return
        cache = node.chunks
        self_name = node.name
        self._chunk_caches[self_name] = cache

        def fetch(digest: bytes) -> Optional[bytes]:
            for holder in self.catalog.chunk_holders(digest):
                if holder == self_name:
                    continue
                peer = self._chunk_caches.get(holder)
                if peer is None:
                    continue
                data = peer.peek(digest)
                if data is None:
                    continue  # stale index entry: try the next holder
                if self.interconnect_bw:
                    _time.sleep(len(data) / self.interconnect_bw)
                with self._lock:
                    self.stats["peer_fetches"] += 1
                    self.stats["peer_fetch_bytes"] += len(data)
                return data
            return None

        cache.node = self_name  # announce under the router-assigned name
        cache.announce = self.catalog.announce_chunk
        cache.peer_fetch = fetch

    # ------------------------------------------------------- fleet elasticity
    def add_node(self, node: NodeScheduler) -> NodeScheduler:
        """Join a node to the fleet: adopt the registry, assign a unique
        name if unnamed, apply the fleet's load-probe TTL, and wire its
        chunk cache into the peer-fetch mesh.  Placement sees it on the
        next request."""
        with self._lock:
            if self._closed:
                raise Overloaded("router is closed")
            node.registry = self.catalog.registry
            taken = {n.name for n in self.nodes}
            if not node.name:
                name = f"node{len(self.nodes)}"
                while name in taken:
                    name = f"{name}x"
                node.name = name
            if node.name in taken:
                raise ValueError(f"node name {node.name!r} already in fleet")
            node.load_ttl_s = self.load_cache_ttl_s
            self.nodes = self.nodes + [node]  # readers snapshot; never mutate
            self.stats["nodes_added"] += 1
        self._wire_node_chunks(node)
        return node

    def remove_node(self, name: str) -> NodeScheduler:
        """Detach a node from the fleet: placement stops immediately, the
        node's sticky assignments are dropped (a later request re-places
        the function), and its chunk cache leaves the peer mesh.  The
        caller still owns the node object — drain it first
        (:meth:`set_draining` + ``quiesce``) and ``close()`` it after; the
        close announces its chunks absent, cleaning the holders index."""
        with self._lock:
            node = next((n for n in self.nodes if n.name == name), None)
            if node is None:
                raise KeyError(name)
            if len(self.nodes) == 1:
                raise ValueError("cannot remove the last node")
            self.nodes = [n for n in self.nodes if n.name != name]
            for fname in list(self._assign):
                reps = [nm for nm in self._assign[fname] if nm != name]
                if reps:
                    self._assign[fname] = reps
                else:
                    del self._assign[fname]
            self._draining.discard(name)
            self._chunk_caches.pop(name, None)
            self.stats["nodes_removed"] += 1
        return node

    def set_draining(self, name: str, draining: bool = True) -> None:
        """Mark a node as draining: placement skips it (including sticky
        replicas already pinned there), but queued and in-flight work on it
        completes normally.  Reversible until :meth:`remove_node`."""
        self.node(name)  # raise KeyError for unknown names
        with self._lock:
            if draining:
                self._draining.add(name)
            else:
                self._draining.discard(name)

    def draining(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._draining)

    def active_nodes(self) -> List[NodeScheduler]:
        """Placement candidates: the fleet minus draining nodes (falling
        back to the whole fleet if everything is draining, so routing can
        never dead-end)."""
        with self._lock:
            nodes = self.nodes
            draining = set(self._draining)
        active = [n for n in nodes if n.name not in draining]
        return active or list(nodes)

    # ------------------------------------------------------------- routing
    def _probe(self, nodes: Sequence[NodeScheduler]) -> List[NodeLoad]:
        if self.placement.needs_loads:
            return [n.load() for n in nodes]
        return [_EMPTY_LOAD] * len(nodes)

    def _urgent(self, inv: Optional[Invocation]) -> bool:
        """LATENCY class, or a deadline tighter than ``urgent_deadline_s``:
        the invocations deadline-aware placement treats as urgent."""
        if inv is None:
            return False
        if inv.qos is QosClass.LATENCY:
            return True
        remaining = inv.remaining_s()
        return remaining is not None and remaining < self.urgent_deadline_s

    def _pick(self, fname: str, inv: Optional[Invocation] = None) -> NodeScheduler:
        """Load probes run OUTSIDE the router lock (each takes several node
        locks — though the fleet-wide ``load_ttl_s`` cache amortizes that
        to O(1) per node between lifecycle edges).  The lock only guards
        the sticky replica map and draining set — probes may be a beat
        stale, which placement tolerates (it ranks)."""
        spec = self.catalog.registry.get(fname)
        key = self.catalog.locality_key(fname)
        urgent = self._urgent(inv)
        with self._lock:
            self.stats["routed"] += 1
            draining = set(self._draining)
            assigned = (
                list(self._assign.get(fname, ())) if self.placement.sticky
                else None
            )
        cands = self.active_nodes()
        if assigned is None:  # non-sticky: place every request independently
            place = self.placement.place_urgent if urgent else self.placement.place
            return cands[place(spec, key, self._probe(cands))]
        by_name = {n.name: n for n in self.nodes}
        # draining replicas stop taking NEW placements; a removed node's
        # entries are pruned by remove_node but tolerate the race here
        live = [nm for nm in assigned if nm in by_name and nm not in draining]
        if not live:
            chosen = cands[self.placement.place(spec, key, self._probe(cands))]
            with self._lock:
                won = self._assign.setdefault(fname, [chosen.name])
                if won == [chosen.name]:
                    return chosen
                # lost the placement race: join the winner's replicas
                live = [nm for nm in won if nm in by_name] or [chosen.name]
        # sticky: route among this function's replicas (joins ride the
        # in-flight restore; warm hits stay warm)
        loads = {nm: by_name[nm].load() for nm in live}
        best = min(
            live,
            key=lambda nm: (loads[nm].queue_depth, loads[nm].pressure),
        )
        room = len(live) < len(cands)
        if urgent and room \
                and loads[best].urgent_depth >= self.latency_spill_depth:
            # deadline-aware steal: the least-loaded replica is backed up
            # with work the QoS queue cannot dispatch past (urgent_depth
            # discounts parked BATCH occupancy) and this invocation cannot
            # wait — grow a replica where place_urgent points (a BATCH
            # invocation queues instead)
            return self._grow_replica(
                fname, spec, key, live, by_name[best], urgent=True
            )
        if (
            self.scale_out_queue_depth is not None
            and (inv is None or inv.qos is not QosClass.BATCH)
            and room
            and loads[best].queue_depth >= self.scale_out_queue_depth
        ):
            # opt-in scale-out: the least-loaded replica is still backed
            # up — place one more replica by the same policy.  BATCH-class
            # invocations never trigger it: background work waits.
            return self._grow_replica(
                fname, spec, key, live, by_name[best], urgent=False
            )
        return by_name[best]

    def _grow_replica(
        self, fname, spec, key, live, best: NodeScheduler, urgent
    ) -> NodeScheduler:
        rest = [n for n in self.active_nodes() if n.name not in live]
        if not rest:
            return best
        place = self.placement.place_urgent if urgent else self.placement.place
        new = rest[place(spec, key, self._probe(rest))]
        with self._lock:
            current = self._assign.setdefault(fname, [best.name])
            if new.name not in current:
                current.append(new.name)
                self.stats["latency_steals" if urgent else "scale_outs"] += 1
                return new
        return best

    def submit_invocation(self, inv: Invocation) -> InvocationHandle:
        """Typed front door: place by QoS/deadline, admit on the chosen
        node (typed ``Overloaded`` / ``DeadlineExceeded`` raise here)."""
        if self._closed:
            raise Overloaded("router is closed")
        if self.prewarm is not None and not inv.prewarm and inv.payload is None:
            # feed the arrival histogram BEFORE placement (arrival time is
            # submit time); the engine's own speculations never count as
            # demand, or prediction would feed back on itself (colocated
            # compute payloads are not function demand either)
            self.prewarm.on_arrival(inv.function)
        if self.deploy is not None and inv.payload is None:
            # staged rollout: the caller addresses the LOGICAL function;
            # the controller's seeded A/B split picks the concrete version
            # (stable or canary) this invocation serves.  Resolution runs
            # AFTER the arrival feed (demand is per logical function) and
            # BEFORE placement, so sticky routing, restore joining and
            # warm hits all key on the version actually served.
            resolved = self.deploy.resolve(inv.function)
            if resolved != inv.function:
                inv = dataclasses.replace(inv, function=resolved)
        if inv.payload is not None:
            # spec-less colocated compute: nothing to place by locality —
            # run it where the queue is shallowest among active nodes
            cands = self.active_nodes()
            node = min(cands, key=lambda n: n.load().queue_depth)
            return node.submit_invocation(inv)
        return self._pick(inv.function, inv).submit_invocation(inv)

    def submit(
        self,
        fname: str,
        prompt: np.ndarray,
        max_new_tokens: int = 8,
        mode: str = "spice",
        cfg: Optional[ModelConfig] = None,
        simulate_read_bw: Optional[float] = None,
    ) -> InvocationHandle:
        """Legacy surface: a STANDARD-class :class:`Invocation` wrapper."""
        return self.submit_invocation(Invocation(
            function=fname, prompt=prompt, max_new_tokens=max_new_tokens,
            mode=mode, cfg=cfg, simulate_read_bw=simulate_read_bw,
        ))

    def invoke(self, *args, **kwargs) -> InvokeResult:
        return self.submit(*args, **kwargs).result()

    # ------------------------------------------------------------- queries
    def node(self, name: str) -> NodeScheduler:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def loads(self) -> List[NodeLoad]:
        return [n.load() for n in self.nodes]

    def replicas(self, fname: str) -> List[str]:
        """Node names a sticky function is currently placed on."""
        with self._lock:
            return list(self._assign.get(fname, []))

    def reassign(
        self, fname: str, to_name: str, from_name: Optional[str] = None
    ) -> None:
        """Rewrite the sticky replica map after a warm-state handoff:
        ``to_name`` joins ``fname``'s replicas, ``from_name`` (the drained
        source) leaves them.  No-op coverage for non-sticky policies (they
        never read the map)."""
        self.node(to_name)  # raise KeyError for unknown names
        with self._lock:
            reps = self._assign.setdefault(fname, [])
            if from_name is not None:
                reps[:] = [nm for nm in reps if nm != from_name]
            if to_name not in reps:
                reps.append(to_name)

    # ------------------------------------------------------ fleet operations
    def evict(self, fname: Optional[str] = None) -> None:
        for n in self.nodes:
            n.evict(fname)

    def reap_expired(self) -> int:
        return sum(n.reap_expired() for n in self.nodes)

    def drain_residual(self, timeout: float = 60.0) -> bool:
        return all(n.drain_residual(timeout) for n in self.nodes)

    def audit(self) -> Dict[str, Dict[str, int]]:
        """Run every node's ledger audit; returns per-node snapshots (and
        raises on the first node whose invariant is broken)."""
        return {n.name: n.memory.audit() for n in self.nodes}

    def close(self) -> None:
        """Idempotent fleet teardown: refuse new work, then close every
        node — each stops its reaper and drains its admission queue with
        typed :class:`Overloaded` rejections, so teardown can never hang on
        queued BATCH work.  In-flight invocations finish; their handles
        resolve normally.  Safe to call any number of times."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.prewarm is not None:
            self.prewarm.stop()
        for n in self.nodes:
            n.close()

    # ---------------------------------------------- control-plane passthrough
    def _warm_node(self, fname: str) -> Optional[NodeScheduler]:
        """The node currently serving ``fname`` WARM, else any node that
        holds its (evicted) instance, else None."""
        from repro_torch.serve.instance import InstanceState

        fallback = None
        for n in self.nodes:
            inst = n.instance(fname)
            if inst is None:
                continue
            if inst.state is InstanceState.WARM:
                return n
            fallback = fallback or n
        return fallback

    def record_access(self, fname: str, **kwargs) -> List[str]:
        """Trace ``fname`` on whichever node currently holds it WARM."""
        from repro_torch.serve.instance import NotWarmError

        for n in self.nodes:
            if n.instance(fname) is not None:
                try:
                    return self.catalog.record_access(fname, n, **kwargs)
                except NotWarmError:
                    continue
        raise RuntimeError(f"{fname}: no node holds a WARM instance")

    def relayout(self, fname: str, order: Optional[List[str]] = None) -> SnapshotStats:
        # prefer a node with the WARM tree resident (zero-read re-snapshot);
        # any instance-holding node is only a ledger to charge the fallback
        # disk restore against
        return self.catalog.relayout(
            fname, order=order, node=self._warm_node(fname)
        )
