"""Serverless serving engine — the ``ServerlessNode`` facade of the port.

The runtime is layered as in ``repro.serve.engine``:

* :mod:`repro_torch.core.iosched`   — node-wide prefetch I/O scheduler,
* :mod:`repro_torch.serve.instance` — per-function lifecycle state machines
  (COLD → RESTORING → WARM → EVICTED) + layer-gated generation,
* :mod:`repro_torch.serve.node`     — the per-node DATA PLANE,
* :mod:`repro_torch.serve.cluster`  — the CONTROL PLANE (`FunctionCatalog`)
  and the N-node `ClusterRouter`.

``ServerlessNode`` composes a catalog with a one-node router and keeps the
``publish`` / ``invoke`` / ``evict`` surface; ``device`` (None: the GPU) is
where restored tensors live and generation runs; ``prewarm`` (a
:class:`PrewarmEngine`) turns the router's arrival feed into speculative
restores.  The warmth-policy engine and the deployment pipeline are
re-exported here as in the reference.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import BufferPool, FunctionRegistry, NodeImageCache, PrefetchIOScheduler
from repro_torch.serve.cluster import (  # re-exported: the cluster layer
    ClusterRouter,
    FunctionCatalog,
    LeastLoaded,
    LocalityFirst,
    PlacementPolicy,
    RoundRobin,
)
from repro_torch.serve.instance import (  # re-exported: public serving helpers
    FunctionInstance,
    InstanceState,
    generate,
    layer_sequence,
    layerwise_state,
    wait_tree,
)
from repro_torch.serve.invocation import (  # re-exported: the typed request surface
    AdmissionController,
    DeadlineExceeded,
    Invocation,
    InvocationCancelled,
    InvocationError,
    InvocationHandle,
    Overloaded,
    QosClass,
    deadline_in,
)
from repro_torch.serve.node import (
    FixedTTLPolicy,
    InvokeResult,
    KeepAlivePolicy,
    NodeLoad,
    NodeScheduler,
    NoKeepAlive,
)
from repro_torch.serve.prewarm import (  # re-exported: the warmth policy engine
    ArrivalTracker,
    PrewarmEngine,
    PrewarmPolicy,
)
from repro_torch.serve.deploy import (  # re-exported: the deployment pipeline
    ColocatedTrainer,
    QualityGate,
    RolloutController,
    TokenHealthGate,
    VersionedFunction,
    VersionRecord,
)

__all__ = [
    "ServerlessNode",
    "NodeScheduler",
    "NodeLoad",
    "InvokeResult",
    "Invocation",
    "InvocationHandle",
    "QosClass",
    "AdmissionController",
    "InvocationError",
    "Overloaded",
    "DeadlineExceeded",
    "InvocationCancelled",
    "deadline_in",
    "KeepAlivePolicy",
    "FixedTTLPolicy",
    "NoKeepAlive",
    "ArrivalTracker",
    "PrewarmPolicy",
    "PrewarmEngine",
    "FunctionCatalog",
    "ClusterRouter",
    "PlacementPolicy",
    "LocalityFirst",
    "RoundRobin",
    "LeastLoaded",
    "FunctionInstance",
    "InstanceState",
    "layer_sequence",
    "layerwise_state",
    "generate",
    "wait_tree",
    "RolloutController",
    "VersionedFunction",
    "VersionRecord",
    "QualityGate",
    "TokenHealthGate",
    "ColocatedTrainer",
]


class ServerlessNode:
    """One node: catalog (control plane) + a single-node router over one
    `NodeScheduler` (data plane).

    The catalog's authoring base-image cache IS the node's serving cache
    here (one machine), so ``node_cache.put(...)`` keeps feeding both
    publish-time dedup and restore-time base resolution."""

    def __init__(
        self,
        registry: Optional[FunctionRegistry] = None,
        node_cache: Optional[NodeImageCache] = None,
        pool: Optional[BufferPool] = None,
        scheduler: Optional[NodeScheduler] = None,
        catalog: Optional[FunctionCatalog] = None,
        prewarm: Optional[PrewarmEngine] = None,
        device=None,
        **scheduler_kwargs,
    ):
        if scheduler is None and catalog is not None and node_cache is None:
            # injected catalog, default scheduler: share the catalog's
            # authoring cache as the serving cache too, so base_name-
            # published functions restore (their base lives there)
            node_cache = catalog.base_images
        self._sched = scheduler or NodeScheduler(
            registry=registry, node_cache=node_cache, pool=pool, device=device,
            **scheduler_kwargs,
        )
        self._catalog = catalog or FunctionCatalog(
            registry=self._sched.registry, base_images=self._sched.node_cache,
            device=self._sched.device,
        )
        self._router = ClusterRouter(self._catalog, [self._sched], prewarm=prewarm)

    # shared-component accessors (benchmarks swap the pool between runs)
    @property
    def device(self):
        return self._sched.device

    @property
    def scheduler(self) -> NodeScheduler:
        return self._sched

    @property
    def catalog(self) -> FunctionCatalog:
        return self._catalog

    @property
    def router(self) -> ClusterRouter:
        return self._router

    @property
    def registry(self) -> FunctionRegistry:
        return self._catalog.registry

    @property
    def node_cache(self) -> NodeImageCache:
        return self._sched.node_cache

    @property
    def iosched(self) -> PrefetchIOScheduler:
        return self._sched.iosched

    @property
    def memory(self):
        """The node's memory ledger (:class:`NodeMemoryManager`)."""
        return self._sched.memory

    @property
    def pool(self) -> BufferPool:
        return self._sched.pool

    @pool.setter
    def pool(self, new_pool: BufferPool) -> None:
        self._sched.pool = new_pool
        # a zero-capacity pool means "no pooling", not "no memory": leave
        # the ledger unlimited rather than refusing every restore
        self._sched.memory_budget = new_pool.capacity or None

    def publish(self, *args, **kwargs):
        # the writer's state copy is node memory too: charge it as scratch
        kwargs.setdefault("memory", self._sched.memory)
        return self._catalog.publish(*args, **kwargs)

    def invoke(self, *args, **kwargs) -> InvokeResult:
        return self._router.invoke(*args, **kwargs)

    def submit(self, *args, **kwargs):
        return self._router.submit(*args, **kwargs)

    def submit_invocation(self, inv: Invocation) -> InvocationHandle:
        """The typed surface (QoS class, deadline, cancellation)."""
        return self._router.submit_invocation(inv)

    def close(self) -> None:
        self._router.close()

    def evict(self, fname: Optional[str] = None) -> None:
        self._sched.evict(fname)

    def record_access(self, fname, *args, **kwargs):
        return self._catalog.record_access(fname, self._sched, *args, **kwargs)

    def relayout(self, fname, order=None):
        return self._catalog.relayout(fname, order=order, node=self._sched)
