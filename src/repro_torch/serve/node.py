"""Node scheduler: multi-tenant admission, keep-alive, and eviction.

The serving stack is layered (bottom up):

* ``repro_torch.core.iosched``  — ONE prefetch I/O scheduler per node; every
  concurrent restore submits chunk reads there (bandwidth arbitration +
  demand boost).
* ``repro_torch.serve.instance`` — per-function lifecycle state machines that own
  restore handles and generation state.
* ``repro_torch.serve.node``     — this module: the per-node DATA PLANE.  It
  admits concurrent invocations through a thread pool, routes them warm /
  joined / cold, enforces keep-alive TTLs (including a background reaper
  for idle nodes), and drives the pressure reclaim ladder (residual tails
  → cached base images → LRU warm state) over the node's single memory
  ledger (:class:`repro_torch.core.memory.NodeMemoryManager`).  Restores admit
  images straight from disk on demand (delta parents bootstrap through
  the node's image cache via ``BaseImage.from_jif``), so a node needs
  nothing but the snapshot store and a registry reference.

The CONTROL PLANE — snapshot authoring (``publish`` / ``relayout``),
recorded-access bookkeeping, and registry ownership — lives in
:class:`repro_torch.serve.cluster.FunctionCatalog`; this module only exposes the
data-plane *mechanisms* the catalog drives (:meth:`NodeScheduler.trace_warm`,
:meth:`NodeScheduler.warm_state`) and the :class:`NodeLoad` probe surface
that cluster placement policies read.

Invocations of a function whose restore is already in flight *join* that
restore (generate over the same tracked-handle tree) rather than re-reading
the snapshot — the paper's single-population guarantee per node.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    BufferPool,
    FunctionRegistry,
    FunctionSpec,
    NodeChunkCache,
    NodeImageCache,
    PrefetchIOScheduler,
    SpiceRestorer,
)
from repro_torch.core import baselines
from repro_torch.core.memory import (
    KIND_WORKING_SET,
    MemoryPressureError,
    NodeMemoryManager,
)
from repro_torch.core.restore import RestoreStats, estimate_rerestore_cost
from repro_torch.core.trace import AccessRecorder
from repro_torch.core.upload import DeviceImageCache, DevicePath, UploadStream
from repro_torch.device import resolve_device
from repro_torch.interop import to_numpy, to_torch, tree_map
from repro_torch.serve.invocation import (
    EVT_ADMITTED,
    EVT_PLACED,
    EVT_RESTORING,
    EVT_RUNNING,
    EVT_WS_READY,
    AdmissionController,
    DeadlineExceeded,
    Invocation,
    InvocationCancelled,
    InvocationHandle,
    Overloaded,
    QosClass,
)
from repro_torch.core.treeutil import unflatten_state
from repro_torch.serve.instance import (
    FunctionInstance,
    InstanceState,
    NotWarmError,
    _FaasnapLeaf,
    _tree_bytes as _tree_nbytes,
    faasnap_wait,
    generate,
    wait_tree,
)


@dataclasses.dataclass
class InvokeResult:
    tokens: np.ndarray
    cold: bool
    mode: str
    restore_wait_s: float = 0.0
    ttft_s: float = 0.0
    total_s: float = 0.0
    stats: Optional[Dict] = None
    function: str = ""
    queue_s: float = 0.0  # admission delay in the node's invoke pool
    joined: bool = False  # rode an in-flight restore instead of starting one
    node: str = ""  # serving node's name ("" on single-node paths)
    qos: str = "standard"  # QosClass.value of the request
    # derived from the handle's event timeline (time.monotonic() domain):
    # queue_wait_s splits queueing delay from restore delay in benchmarks
    queue_wait_s: float = 0.0   # ADMITTED -> first work on the request
    admitted_ts: float = 0.0    # monotonic timestamps of the named events
    placed_ts: float = 0.0
    running_ts: float = 0.0
    timeline: Optional[List[Tuple[str, float]]] = None  # full event list


@dataclasses.dataclass(frozen=True)
class NodeLoad:
    """One node's probe surface for cluster placement — a consistent-enough
    snapshot (each field is read under its own lock; placement tolerates
    the skew, it only ranks nodes).  ``queue_depth`` counts invocations
    submitted but not yet finished (queued + running), ``pending_io_bytes``
    the bytes the node's prefetch arbiter still has to land."""

    node: str = ""
    queue_depth: int = 0
    pressure: float = 0.0          # memory ledger: held / budget
    pending_io_bytes: int = 0      # iosched: bytes still to land
    inflight_streams: int = 0      # iosched: live (uncompleted) streams
    warm: FrozenSet[str] = frozenset()       # WARM/WARMING function names
    restoring: FrozenSet[str] = frozenset()  # RESTORING (joinable) names
    images: FrozenSet[str] = frozenset()     # resident base-image names
    warm_bytes: int = 0
    batch_inflight: int = 0  # BATCH-class admitted (queued + running)
    urgent_depth: int = 0    # QUEUED non-BATCH invocations: the backlog an
    # urgent (LATENCY) arrival actually waits behind in the run queue.
    # Queued BATCH work is excluded (the QoS dispatcher jumps past it);
    # running work of any class is excluded too — worker occupancy is the
    # admission controller's problem (max_batch_inflight), and counting it
    # here made urgent placement steal replicas that queue-priority alone
    # would have served warm.  Under genuine worker saturation the queued
    # urgent arrivals themselves grow this number, so the spill still
    # fires after ~latency_spill_depth of them.


# a prewarm invocation's result carries no generation output
_EMPTY_TOKENS = np.zeros((0,), np.int32)


def _cancel_collateral(exc: BaseException) -> bool:
    """True when ``exc`` was caused by SOMEONE ELSE cancelling the restore
    this invocation merely rode (the cause chain bottoms out in
    InvocationCancelled): the rider is innocent and may retry once."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, InvocationCancelled):
            return True
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return False


# ------------------------------------------------------------ keep-alive
class KeepAlivePolicy:
    """Pluggable keep-alive: decides each instance's warm TTL and which
    warm instances to sacrifice under memory pressure (LRU default)."""

    def ttl_for(self, spec: FunctionSpec) -> float:
        return spec.warm_ttl_s

    def victims(
        self, warm: List[FunctionInstance], need_evict: int
    ) -> List[FunctionInstance]:
        """Pick AT MOST ``need_evict`` idle warm instances to sacrifice,
        in eviction order (LRU-first here).  ``need_evict`` is the
        caller's upper bound on how many evictions could possibly be
        needed — honoring it keeps a large warm set from being fully
        sorted (and lets policies stop scoring early); the caller still
        stops as soon as enough bytes came back."""
        return heapq.nsmallest(
            max(0, need_evict), warm, key=lambda i: i.last_used
        )


class FixedTTLPolicy(KeepAlivePolicy):
    """Same keep-alive window for every function (SPES-style knob)."""

    def __init__(self, ttl_s: float):
        self.ttl_s = ttl_s

    def ttl_for(self, spec: FunctionSpec) -> float:
        return self.ttl_s


class NoKeepAlive(KeepAlivePolicy):
    """Aggressive reclamation: every invocation is a cold start."""

    def ttl_for(self, spec: FunctionSpec) -> float:
        return 0.0


# ---------------------------------------------------------------- scheduler
class NodeScheduler:
    """Concurrent serving runtime for one node — pure data plane.

    ``registry`` is a *reference*: the control plane
    (:class:`repro_torch.serve.cluster.FunctionCatalog`) owns registration; the
    node only resolves specs.  ``name`` identifies the node in a cluster
    (stamped on every :class:`InvokeResult`; "" on single-node paths).
    ``reap_interval_s`` starts a background keep-alive reaper so expired
    warm instances release their ledger bytes even on an idle node."""

    def __init__(
        self,
        registry: Optional[FunctionRegistry] = None,
        node_cache: Optional[NodeImageCache] = None,
        pool: Optional[BufferPool] = None,
        iosched: Optional[PrefetchIOScheduler] = None,
        max_workers: int = 8,
        memory_budget_bytes: Optional[int] = None,
        keepalive: Optional[KeepAlivePolicy] = None,
        memory: Optional[NodeMemoryManager] = None,
        name: str = "",
        reap_interval_s: Optional[float] = None,
        admission: Optional[AdmissionController] = None,
        install: object = "eager",
        upload_depth: int = 2,
        simulate_upload_bw: Optional[float] = None,
        chunks: Optional[NodeChunkCache] = None,
        load_ttl_s: float = 0.0,
        device=None,
    ):
        """``install`` selects the device-install policy for restores on
        this node — "eager" (per-tensor device copy on the prefetcher
        thread, the default), "host" (tensors stay host numpy), "fused"
        (device fast path: UploadStream + DeviceImageCache, private pages
        upload and overlay-patch against HBM-resident bases), or a callable
        (custom per-tensor transform, eager-style).  ``upload_depth`` sizes
        the fused path's upload ring (staging slots in flight);
        ``simulate_upload_bw`` models the interconnect roofline on the ring
        (labeled benchmark runs only, like ``simulate_read_bw``).
        ``chunks`` (a :class:`repro_torch.core.chunkstore.NodeChunkCache` over
        the cluster's shared CAS) enables content-addressed dedup on every
        spice restore this node runs; its RAM tier attaches to the ledger
        as rung 2.  ``load_ttl_s`` > 0 caches the :meth:`load` probe for
        that long (staleness-bounded: any instance lifecycle transition
        invalidates it immediately via the load epoch) so cluster placement
        stays O(1)-amortized per node instead of taking several node locks
        on every submission; the router sets it fleet-wide.  ``device``
        (None: the GPU, which must be present) is where restored tensors
        are installed and generation runs."""
        self.name = name
        self.device = resolve_device(device)
        self.registry = registry or FunctionRegistry()
        self.node_cache = node_cache or NodeImageCache()
        self._pool = pool or BufferPool()
        self.iosched = iosched or PrefetchIOScheduler(name="node-iosched")
        self.keepalive = keepalive or KeepAlivePolicy()
        # a cost-aware policy (PrewarmPolicy) adopts this node's residency-
        # aware re-restore estimate for its eviction ranking
        bind = getattr(self.keepalive, "bind_node", None)
        if callable(bind):
            bind(self)
        # ONE ledger covers everything competing for node RAM: pool staging
        # buffers, cached base images, warm working sets, residual tails,
        # snapshot scratch.  The budget is an invariant of the manager, not
        # an estimate summed across subsystems.
        budget = (
            memory_budget_bytes if memory_budget_bytes is not None else self._pool.capacity
        )
        self.memory = memory or NodeMemoryManager(budget)
        self._pool.attach(self.memory)
        self.node_cache.attach(self.memory)  # registers ladder rung 3
        self.chunks = chunks
        if chunks is not None:
            chunks.attach(self.memory)  # chunk-cas RAM tier, ladder rung 2
        self.install = install
        self.upload_stream: Optional[UploadStream] = None
        self.device_images: Optional[DeviceImageCache] = None
        if install == "fused":
            # device fast path: one upload ring + one HBM base cache per
            # node, shared by every restore.  The cache attaches as ladder
            # rung 1 (cheaper to drop than host bases: re-upload, not
            # re-read); its capacity is ledger-bounded anyway, so the LRU
            # cap just tracks the node budget.
            self.upload_stream = UploadStream(
                depth=upload_depth, name=f"{name or 'node'}-upload",
                simulate_bw=simulate_upload_bw, device=self.device,
            )
            self.device_images = DeviceImageCache(
                capacity_bytes=budget if budget else 4 << 30, device=self.device,
            )
            self.device_images.attach(self.memory)
        # reclaim ladder: residual tails first (cheapest to re-restore),
        # then device-resident base pages (rung 1, above, fused nodes only),
        # then RAM chunk-CAS demotions (rung 2, above, dedup nodes only —
        # re-readable from the local disk CAS), then recoverable host base
        # images (rung 3, above), then idle pool staging (pure perf cache —
        # without this rung the free list's charge would ratchet up
        # unreclaimably), then LRU warm instances
        self.memory.register_reclaimer("residual", self._reclaim_residual, order=0)
        self.memory.register_reclaimer("pool", self._reclaim_pool, order=4)
        self.memory.register_reclaimer("warm-lru", self._reclaim_warm_lru, order=5)
        self._instances: Dict[str, FunctionInstance] = {}
        self._ilock = threading.Lock()
        self._slock = threading.Lock()
        self._exec = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="invoke"
        )
        # in-flight residual streams (fname -> RestoreStats of a WARMING
        # instance): counted against the memory budget until they drain
        self._residual: Dict[str, RestoreStats] = {}
        # invocations submitted but not finished (queued + running): the
        # cluster router's queue-depth signal
        self._pending = 0
        # QoS-ordered run queue: the pool's workers pull the best admitted
        # invocation (class rank, then priority, then earliest deadline,
        # then FIFO) instead of raw submission order
        self.admission = admission or AdmissionController()
        self._queue: List[Tuple] = []  # heap of (rank,-prio,deadline,seq,t,handle)
        self._queued = 0        # entries in the heap (not yet claimed)
        self._batch_queued = 0  # BATCH entries in the heap
        self._batch_active = 0  # BATCH admitted (queued + running)
        self._fn_active: Dict[str, int] = {}  # per-fn admitted (queued+running)
        self._seq = 0
        self._closed = False
        self._reaper_stop: Optional[threading.Event] = None
        self.reap_interval_s = reap_interval_s
        # cached NodeLoad probe: (monotonic ts, epoch at build, NodeLoad).
        # The epoch bumps on every instance lifecycle transition, so a
        # cached snapshot can never claim a function warm/restoring that
        # is not — queue-depth staleness is bounded by load_ttl_s.
        self.load_ttl_s = load_ttl_s
        self._load_epoch = 0
        self._load_cache: Optional[Tuple[float, int, NodeLoad]] = None
        # completion observer (autoscaler SLO feed): called with every
        # successful InvokeResult right after the handle resolves; must be
        # fast and non-raising (runs on the worker thread)
        self.on_result = None
        self.stats = {
            "invocations": 0,
            "warm_hits": 0,
            "cold_starts": 0,
            "joined_restores": 0,
            "ttl_evictions": 0,
            "lru_evictions": 0,
            "ws_promotions": 0,
            "residual_evictions": 0,
            "ws_rerestores": 0,
            "rejected_overloaded": 0,
            "rejected_deadline": 0,
            "cancellations": 0,
            "speculative_restores": 0,  # prewarm invocations that restored
            "prewarm_redundant": 0,     # prewarms finding warm/restoring state
            "payload_runs": 0,          # colocated compute thunks executed
        }
        if reap_interval_s is not None:
            self.start_reaper(reap_interval_s)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._slock:
            self.stats[key] += n

    # ------------------------------------------------------- memory ledger
    @property
    def pool(self) -> BufferPool:
        return self._pool

    @pool.setter
    def pool(self, new_pool: BufferPool) -> None:
        """Swap the staging pool (benchmarks do this between runs): the old
        pool's ledger charge is released, the new pool is attached."""
        old, self._pool = self._pool, new_pool
        if old is not None and old is not new_pool:
            old.detach()
        new_pool.attach(self.memory)

    @property
    def memory_budget(self) -> Optional[int]:
        return self.memory.budget

    @memory_budget.setter
    def memory_budget(self, nbytes: Optional[int]) -> None:
        self.memory.budget = nbytes

    # --------------------------------------------------------------- invoke
    def submit_invocation(self, inv: Invocation,
                          handle: Optional[InvocationHandle] = None,
                          ) -> InvocationHandle:
        """Admit a typed :class:`Invocation` into the node's QoS-ordered
        run queue.  Admission-time refusals RAISE (typed
        :class:`Overloaded` / :class:`DeadlineExceeded`); anything after
        admission resolves through the returned handle."""
        fname = inv.function
        if handle is None:
            handle = InvocationHandle(inv, node=self.name)
        else:
            handle.node = self.name
        if inv.deadline_s is not None and time.monotonic() >= inv.deadline_s:
            self._bump("rejected_deadline")
            raise DeadlineExceeded(f"{fname}: deadline already passed at submit")
        t_submit = time.perf_counter()
        with self._slock:
            if self._closed:
                raise Overloaded(f"node {self.name or 'node'!r} is closed")
            try:
                self.admission.admit(
                    inv, queued=self._queued,
                    fn_active=self._fn_active.get(fname, 0),
                    batch_queued=self._batch_queued,
                    batch_active=self._batch_active,
                )
            except Overloaded:
                self.stats["rejected_overloaded"] += 1
                raise
            self._pending += 1
            self._queued += 1
            if inv.qos is QosClass.BATCH:
                self._batch_queued += 1
                self._batch_active += 1
            self._fn_active[fname] = self._fn_active.get(fname, 0) + 1
            seq = self._seq
            self._seq += 1
            # record BEFORE the entry becomes poppable: a free worker may
            # claim it the instant the lock drops, and the timeline must
            # still read ADMITTED -> PLACED -> <work>
            handle.record(EVT_ADMITTED)
            handle.record(EVT_PLACED)
            heapq.heappush(self._queue, (
                inv.qos.dispatch_rank, -inv.priority,
                inv.deadline_s if inv.deadline_s is not None else float("inf"),
                seq, t_submit, handle,
            ))
        try:
            self._exec.submit(self._drain_one)
        except BaseException:
            # raced a close(): the admission check above passed before the
            # flag flipped, so the entry is either in the queue close() is
            # draining (typed rejection incoming) or already claimed by a
            # worker — either way the handle resolves; return it instead
            # of surfacing the executor's untyped RuntimeError.  _retire
            # is idempotent, so the doubled return cannot skew the caps.
            self._retire(handle)
            if handle._done_ev.wait(5.0):
                return handle
            raise
        return handle

    def submit(
        self,
        fname: str,
        prompt: np.ndarray,
        max_new_tokens: int = 8,
        mode: str = "spice",
        cfg: Optional[ModelConfig] = None,
        simulate_read_bw: Optional[float] = None,
    ) -> InvocationHandle:
        """Legacy surface: a thin wrapper building a STANDARD-class
        :class:`Invocation` (the returned handle duck-types the Future the
        old surface handed back)."""
        return self.submit_invocation(Invocation(
            function=fname, prompt=prompt, max_new_tokens=max_new_tokens,
            mode=mode, cfg=cfg, simulate_read_bw=simulate_read_bw,
        ))

    def invoke(
        self,
        fname: str,
        prompt: np.ndarray,
        max_new_tokens: int = 8,
        mode: str = "spice",
        cfg: Optional[ModelConfig] = None,
        simulate_read_bw: Optional[float] = None,
    ) -> InvokeResult:
        return self.submit(
            fname, prompt, max_new_tokens, mode, cfg, simulate_read_bw
        ).result()

    def _retire(self, handle: InvocationHandle) -> None:
        """Return one admitted invocation's counters (dispatch done, or the
        enqueue failed after admission).  Idempotent per handle: a racing
        ``close()`` and a failed enqueue may both try to retire the same
        admission, and returning it twice would corrupt the caps."""
        fname = handle.invocation.function
        with self._slock:
            if handle._retired:
                return
            handle._retired = True
            self._pending -= 1
            if handle.invocation.qos is QosClass.BATCH:
                self._batch_active -= 1
            left = self._fn_active.get(fname, 0) - 1
            if left > 0:
                self._fn_active[fname] = left
            else:
                self._fn_active.pop(fname, None)

    def _drain_one(self) -> None:
        """Worker-pool entry: claim the best queued invocation and run it.
        One `_drain_one` is scheduled per enqueue, so the heap is non-empty
        unless `close()` drained it first."""
        with self._slock:
            if not self._queue:
                return  # close() rejected the queued work already
            _, _, _, _, t_submit, handle = heapq.heappop(self._queue)
            self._queued -= 1
            if handle.invocation.qos is QosClass.BATCH:
                self._batch_queued -= 1
        inv = handle.invocation
        try:
            if not handle._claim_for_run():
                self._bump("cancellations")
                handle._finish_cancelled(InvocationCancelled(
                    f"{inv.function}: cancelled while queued"
                ))
                return
            if inv.deadline_s is not None and time.monotonic() >= inv.deadline_s:
                self._bump("rejected_deadline")
                handle._finish_rejected(DeadlineExceeded(
                    f"{inv.function}: deadline passed after "
                    f"{time.perf_counter() - t_submit:.3f}s in queue"
                ))
                return
            result = None
            for attempt in range(3):
                try:
                    result = self._invoke_inner(inv, handle, t_submit)
                    break
                except BaseException as exc:
                    if handle.cancel_requested:
                        self._bump("cancellations")
                        handle._finish_cancelled(InvocationCancelled(
                            f"{inv.function}: cancelled mid-restore"
                        ))
                        return
                    if attempt < 2 and _cancel_collateral(exc):
                        # rode a restore someone ELSE cancelled: this
                        # invocation is innocent — restore afresh (under a
                        # cancellation wave the retry itself may join
                        # another doomed restore, hence more than one).
                        # Re-open the phase machine so the retry is
                        # cancellable again.
                        handle._reset_for_retry()
                        continue
                    raise
            result.qos = inv.qos.value
            result.queue_wait_s = handle.queue_wait_s()
            result.admitted_ts = handle.event_ts(EVT_ADMITTED) or 0.0
            result.placed_ts = handle.event_ts(EVT_PLACED) or 0.0
            result.running_ts = handle.event_ts(EVT_RUNNING) or 0.0
            result.timeline = handle.events()
            handle._finish_ok(result)
            if self.on_result is not None:
                try:
                    self.on_result(result)
                except Exception:
                    pass  # an observer must never fail the invocation path
        except BaseException as exc:  # noqa: BLE001 — typed via the handle
            handle._finish_failed(exc)
        finally:
            self._retire(handle)

    # ------------------------------------------------------------- teardown
    def close(self) -> None:
        """Idempotent node shutdown: stop the reaper, refuse new work, and
        drain the admission queue with typed rejections so queued BATCH
        work cannot hang fleet teardown.  Running invocations finish."""
        with self._slock:
            if self._closed:
                return
            self._closed = True
            drained = [entry[-1] for entry in self._queue]
            self._queue.clear()
            self._queued = 0
            self._batch_queued = 0
        self.stop_reaper()
        for handle in drained:
            if handle.cancel_requested:
                self._bump("cancellations")
                handle._finish_cancelled(InvocationCancelled(
                    f"{handle.invocation.function}: cancelled while queued"
                ))
            else:
                self._bump("rejected_overloaded")
                handle._finish_rejected(Overloaded(
                    f"node {self.name or 'node'!r}: shutting down"
                ))
            self._retire(handle)
        self._exec.shutdown(wait=False)
        if self.upload_stream is not None:
            self.upload_stream.close()
        if self.chunks is not None:
            # return this node's CAS references and ledger charge; chunks
            # other holders still reference stay in the shared store
            self.chunks.release_all()

    # ------------------------------------------------------------- eviction
    def evict(self, fname: Optional[str] = None, timeout: float = 30.0) -> None:
        """Force-evict warm instances (all, or one) — manual reclamation.
        A WARMING instance (residual still landing) is waited on until its
        finalizer flips it WARM, so a manual evict really leaves a cold
        slate instead of silently skipping the in-flight instance."""
        with self._ilock:
            insts = (
                list(self._instances.values())
                if fname is None
                else [i for n, i in self._instances.items() if n == fname]
            )
        for inst in insts:
            with inst.cond:
                inst.cond.wait_for(
                    lambda: inst.state is not InstanceState.WARMING,
                    timeout=timeout,
                )
                inst.evict("manual")

    def reap_expired(self, now: Optional[float] = None) -> int:
        """Enforce keep-alive TTLs across the node; returns evictions."""
        now = time.time() if now is None else now
        n = 0
        with self._ilock:
            insts = list(self._instances.values())
        for inst in insts:
            with inst.cond:
                if inst.expired(now) and inst.evict("ttl"):
                    n += 1
        if n:
            self._bump("ttl_evictions", n)
        return n

    # ------------------------------------------------------ background reaper
    def start_reaper(self, interval_s: float) -> None:
        """Enforce keep-alive TTLs periodically on a daemon thread, so an
        idle node releases expired warm instances' ledger bytes instead of
        holding them until the next invocation's budget sweep.  The thread
        holds only a weakref to the scheduler: a dropped node (benchmarks
        build short-lived per-policy fleets) is GC-able without an explicit
        ``stop_reaper`` and its reaper exits on the next tick."""
        import weakref

        self.stop_reaper()
        stop = threading.Event()
        self._reaper_stop = stop
        self.reap_interval_s = interval_s
        ref = weakref.ref(self)

        def loop():
            while not stop.wait(interval_s):
                node = ref()
                if node is None:
                    return  # scheduler got collected: nothing left to reap
                try:
                    if node.reap_expired():
                        # expired state released: settle the ledger too
                        # (frees any blocked reserve waiting on these bytes)
                        node._enforce_budget()
                except Exception:
                    pass  # a failed sweep must not kill the reaper
                finally:
                    node = None  # never hold the node across the sleep

        threading.Thread(
            target=loop, name=f"reaper-{self.name or 'node'}", daemon=True
        ).start()

    def stop_reaper(self) -> None:
        if self._reaper_stop is not None:
            self._reaper_stop.set()
            self._reaper_stop = None

    # -------------------------------------------------------------- probes
    def _bump_load_epoch(self, _inst=None) -> None:
        """Invalidate the cached load probe (instance lifecycle hook; may
        run under an instance's cond, so it must never take a lock)."""
        self._load_epoch += 1

    def load(self) -> NodeLoad:
        """The placement probe surface (see :class:`NodeLoad`).  With
        ``load_ttl_s`` set, a recent snapshot is served as long as no
        instance transitioned since it was built (the load epoch is the
        staleness bound on the warm/restoring sets; counters like
        queue_depth tolerate the sub-TTL skew — placement only ranks)."""
        ttl = self.load_ttl_s
        if ttl > 0:
            cached = self._load_cache
            if (
                cached is not None
                and cached[1] == self._load_epoch
                and time.monotonic() - cached[0] < ttl
            ):
                return cached[2]
        # capture the epoch BEFORE building: a transition racing the build
        # leaves a stale epoch behind, so the next probe rebuilds
        epoch = self._load_epoch
        fresh = self._load_uncached()
        if ttl > 0:
            self._load_cache = (time.monotonic(), epoch, fresh)
        return fresh

    def _load_uncached(self) -> NodeLoad:
        with self._slock:
            queue_depth = self._pending
            batch_inflight = self._batch_active
            urgent_depth = max(0, self._queued - self._batch_queued)
        with self._ilock:
            insts = list(self._instances.items())
        warm = frozenset(
            n for n, i in insts
            if i.state in (InstanceState.WARM, InstanceState.WARMING)
        )
        restoring = frozenset(
            n for n, i in insts if i.state is InstanceState.RESTORING
        )
        warm_bytes = sum(
            i.memory_bytes for n, i in insts if n in warm
        )
        io = self.iosched.inflight()
        return NodeLoad(
            node=self.name,
            queue_depth=queue_depth,
            pressure=self.memory.pressure(),
            pending_io_bytes=io["pending_bytes"],
            inflight_streams=io["streams"],
            warm=warm,
            restoring=restoring,
            images=self.node_cache.resident_names(),
            warm_bytes=warm_bytes,
            batch_inflight=batch_inflight,
            urgent_depth=urgent_depth,
        )

    def warm_bytes(self) -> int:
        """Resident warm-state bytes — WARMING instances count too: their
        working set is resident and their residual stream is landing into
        the same budgeted memory."""
        with self._ilock:
            insts = list(self._instances.values())
        return sum(
            i.memory_bytes
            for i in insts
            if i.state in (InstanceState.WARM, InstanceState.WARMING)
        )

    def residual_streams(self) -> int:
        """In-flight residual streams (WARMING instances' background tails)."""
        with self._slock:
            return sum(1 for s in self._residual.values() if not s.complete)

    def drain_residual(self, timeout: float = 60.0) -> bool:
        """Block until every residual stream has drained and every WARMING
        instance finalized (benchmarks/eviction barriers)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._slock:
                pending = bool(self._residual)
            if not pending:
                with self._ilock:
                    insts = list(self._instances.values())
                if not any(i.state is InstanceState.WARMING for i in insts):
                    return True
            time.sleep(0.01)
        return False

    def quiesce(self, timeout: float = 60.0) -> bool:
        """Block until every admitted invocation (queued + running) has
        finished — the drain barrier: placement must already be stopped, or
        new arrivals keep the node busy forever."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._slock:
                if self._pending == 0:
                    return True
            time.sleep(0.005)
        return False

    def warm_instances(self) -> List[FunctionInstance]:
        """WARM/WARMING instances, unsorted (drain/handoff enumeration)."""
        with self._ilock:
            insts = list(self._instances.values())
        return [
            i for i in insts
            if i.state in (InstanceState.WARM, InstanceState.WARMING)
        ]

    def instance(self, fname: str) -> Optional[FunctionInstance]:
        with self._ilock:
            return self._instances.get(fname)

    def rerestore_cost(self, inst: FunctionInstance) -> int:
        """Estimated storage-pull bytes to bring ``inst`` back if evicted
        now — this node's residency (chunk CAS, HBM bases) folded into
        the instance-level estimate.  Cost-aware keep-alive policies
        (``PrewarmPolicy``) rank eviction candidates with it."""
        return estimate_rerestore_cost(
            inst.restore_stats,
            image_bytes=inst.memory_bytes,
            ws_pinned=inst.ws_pinned is not None,
            residual_bytes=(
                inst.residual_region.nbytes
                if inst.residual_region is not None else 0
            ),
            # the last spice restore ingested every pulled chunk into the
            # node CAS, so a re-read comes from local disk, not the store
            chunks_hot=self.chunks is not None,
            device_base_resident=(
                self.device_images is not None
                and self.device_images.resident_bytes() > 0
            ),
        )

    # ------------------------------------------------- residual finalization
    def _watch_residual(self, fname, inst, state, getter, stats) -> None:
        """Track a WARMING instance's residual stream and finalize WARM (on
        a dedicated thread) once it drains; a failed residual evicts."""
        with self._slock:
            self._residual[fname] = stats
        generation = inst.generation

        def finalize():
            try:
                if not stats.wait_complete(timeout=600):
                    # stalled residual: never leave an unevictable WARMING
                    # instance pinned against the budget forever
                    raise TimeoutError(f"{fname}: residual stream stalled")
                resolved = getter(state)
                with inst.cond:
                    if (
                        inst.state is InstanceState.WARMING
                        and inst.generation == generation
                    ):
                        inst.finalize_warm(resolved, time.time())
            except BaseException:
                with inst.cond:
                    if (
                        inst.state is InstanceState.WARMING
                        and inst.generation == generation
                    ):
                        inst.abort_warming()
            finally:
                with self._slock:
                    if self._residual.get(fname) is stats:
                        del self._residual[fname]
                self._enforce_budget(keep=fname)

        threading.Thread(
            target=finalize, name=f"residual-{fname}", daemon=True
        ).start()

    # ------------------------------------------------ warm-state mechanisms
    # Data-plane primitives the control plane (FunctionCatalog) drives: the
    # instances — and the locks guarding them — live here, so tracing and
    # state capture must too; what to DO with the results (record →
    # relayout bookkeeping, JIF rewrites) is the catalog's business.
    def trace_warm(
        self,
        fname: str,
        prompt: Optional[np.ndarray] = None,
        max_new_tokens: int = 4,
        cfg: Optional[ModelConfig] = None,
    ) -> List[str]:
        """Capture the ACTUAL first-touch order from a warm generation (the
        paper's §5 kernel tracing module, fed by production traffic instead
        of the offline pre-warm run).  The instance must be WARM."""
        from repro_torch.configs import get_config

        spec = self.registry.get(fname)
        cfg = cfg or get_config(spec.arch)
        inst = self.instance(fname)
        if inst is None:
            raise RuntimeError(f"{fname}: trace_warm needs a WARM instance")
        if prompt is None:
            prompt = np.zeros((1, 4), np.int32)
        with inst.pinned_warm_tree() as tree:
            rec = AccessRecorder(tree)
            generate(cfg, None, rec.view(), prompt, max_new_tokens,
                     device=self.device)
            return rec.touched

    def warm_state(self, fname: str):
        """Host (numpy) copy of a WARM instance's resolved tree, or None
        when the function is not warm on this node — the catalog uses it to
        re-snapshot live state without a disk restore."""
        inst = self.instance(fname)
        if inst is None:
            return None
        try:
            with inst.pinned_warm_tree() as tree:
                return tree_map(to_numpy, tree)
        except NotWarmError:
            # ONLY the not-warm signal falls back; a failure materializing
            # the pinned tree is a real error and must surface
            return None

    # ------------------------------------------------------------ internals
    def _get_instance(self, fname: str, spec, cfg) -> FunctionInstance:
        with self._ilock:
            inst = self._instances.get(fname)
            if inst is None:
                inst = self._instances[fname] = FunctionInstance(spec, cfg)
                inst.on_transition = self._bump_load_epoch
            return inst

    def _invoke_inner(
        self, inv: Invocation, handle: InvocationHandle, t_submit: float
    ) -> InvokeResult:
        from repro_torch.configs import get_config

        fname = inv.function
        prompt, max_new_tokens = inv.prompt, inv.max_new_tokens
        mode = inv.mode
        if inv.payload is not None:
            # colocated compute lane: no spec, no snapshot, no instance —
            # the thunk runs on this worker after waiting its turn in the
            # QoS-ordered queue under the admission caps (a BATCH payload
            # parks behind LATENCY work and max_batch_inflight bounds its
            # worker occupancy; that is the serve/train colocation contract)
            t0 = time.perf_counter()
            self._bump("invocations")
            self._bump("payload_runs")
            handle._pin()
            handle.record(EVT_RUNNING)
            out = inv.payload()
            return InvokeResult(
                _EMPTY_TOKENS, cold=False, mode="payload",
                total_s=time.perf_counter() - t0, function=fname,
                queue_s=t0 - t_submit, node=self.name,
                stats=out if isinstance(out, dict) else None,
            )
        spec = self.registry.get(fname)
        if inv.jif_override is not None:
            # warm-state handoff: restore THIS image (a delta of the live
            # warm state against the function's own base) instead of the
            # registered one; the override is per-invocation — later
            # restores of the function read the registered image again
            spec = dataclasses.replace(spec, jif_path=inv.jif_override)
        cfg = inv.cfg
        if cfg is None:
            # cfg-less invocations (speculative pre-warms) reuse the cfg the
            # function's prior real traffic ran with; named-arch lookup is
            # the last resort (reduced/bench variants aren't in the table)
            with self._ilock:
                prior = self._instances.get(fname)
            cfg = prior.cfg if prior is not None else get_config(spec.arch)
        t0 = time.perf_counter()
        queue_s = t0 - t_submit
        self._bump("invocations")
        inst = self._get_instance(fname, spec, cfg)
        role = None
        tree = getter = None
        preloaded = pinned_region = None
        with inst.cond:
            while role is None:
                now = time.time()
                if inst.expired(now) and inst.evict("ttl"):
                    self._bump("ttl_evictions")
                if inst.state in (InstanceState.WARM, InstanceState.WARMING):
                    # WARMING counts as warm: the working set is resident;
                    # generation stays layer-gated over the residual handles
                    role = "warm"
                    if not inv.prewarm:
                        # a speculative probe finding warm state is a no-op:
                        # it must not refresh recency or the TTL window
                        inst.counters["warm_hits"] += 1
                        inst.last_used = now
                        if inst.state is InstanceState.WARM:
                            # sliding keep-alive: every real hit re-derives
                            # the window (adaptive policies shrink/grow it
                            # as the arrival histogram evolves)
                            ttl = self.keepalive.ttl_for(spec)
                            if ttl > 0:
                                inst.warm_expiry = max(
                                    inst.warm_expiry, now + ttl
                                )
                    tree, getter = inst.tree, inst.getter
                    inst.inflight += 1
                elif inst.state is InstanceState.RESTORING:
                    if inst.tree is not None:
                        role = "joined"
                        inst.counters["joined"] += 1
                        tree, getter = inst.tree, inst.getter
                        inst.inflight += 1
                    else:  # owner claimed but handles not published yet
                        inst.cond.wait(timeout=0.05)
                else:  # COLD / EVICTED — this thread owns the restore
                    role = "owner"
                    inst.begin_restore(mode)
                    # EVICTED → RESTORING with a pinned working set: hand
                    # the resident ws to the restorer so only the dropped
                    # residual bytes are read again
                    preloaded, pinned_region = inst.take_ws_pinned()
                    inst.inflight += 1

        try:
            if role == "warm":
                handle._pin()  # state resident: cancel is a no-op from here
                handle.record(EVT_WS_READY)
                handle.record(EVT_RUNNING)
                if inv.prewarm:
                    # speculation raced a real arrival (or a stale
                    # prediction): the state it wanted resident already is
                    self._bump("prewarm_redundant")
                    return InvokeResult(
                        _EMPTY_TOKENS, cold=False, mode="prewarm",
                        total_s=time.perf_counter() - t0,
                        function=fname, queue_s=queue_s, node=self.name,
                    )
                toks, ttft = generate(cfg, getter, tree, prompt, max_new_tokens,
                                      device=self.device)
                dt = time.perf_counter() - t0
                self._bump("warm_hits")
                return InvokeResult(
                    toks, cold=False, mode="warm", ttft_s=ttft, total_s=dt,
                    function=fname, queue_s=queue_s, node=self.name,
                )
            if role == "joined":
                handle._pin()  # joiners ride a shared stream: not abortable
                handle.record(EVT_RESTORING)
                if inst.ws_ready:
                    handle.record(EVT_WS_READY)
                if inv.prewarm:
                    # someone else (most likely the real invocation the
                    # speculation aimed at) owns the restore: nothing to add
                    self._bump("prewarm_redundant")
                    return InvokeResult(
                        _EMPTY_TOKENS, cold=True, mode="prewarm",
                        total_s=time.perf_counter() - t0, joined=True,
                        function=fname, queue_s=queue_s, node=self.name,
                    )
                handle.record(EVT_RUNNING)
                toks, ttft = generate(cfg, getter, tree, prompt, max_new_tokens,
                                      device=self.device)
                dt = time.perf_counter() - t0
                self._bump("joined_restores")
                return InvokeResult(
                    toks, cold=True, mode=mode, ttft_s=ttft, total_s=dt,
                    function=fname, queue_s=queue_s, joined=True, node=self.name,
                )

            # ------------------------------------------------- owner (cold)
            # any failure before promotion (restore, generation, resolve)
            # must not strand the instance in RESTORING: abort releases
            # joiners and makes the next invocation restore afresh
            try:
                handle.record(EVT_RESTORING)
                if preloaded:
                    self._bump("ws_rerestores")

                def _ws_ready():  # fired by the restorer (prefetcher thread)
                    handle.record(EVT_WS_READY)
                    handle._pin()

                # pinned_region rides along: the spice restorer resizes it
                # in place into the new ws region, so the resident pinned
                # bytes stay charged across the re-restore
                state, stats, getter, regions, stream = self._cold_restore(
                    spec, mode, inv.simulate_read_bw, preloaded, pinned_region,
                    io_priority=inv.qos.io_priority, on_working_set=_ws_ready,
                )
                with inst.cond:
                    inst.publish_restore(state, getter, stats, regions)
                    generation = inst.generation
                if stream is not None:
                    # arm mid-restore cancellation: aborts the stream (which
                    # releases every ledger reservation through the restore
                    # failure paths) iff no joiner shares the handle tree
                    handle._attach_canceller(
                        self._restore_canceller(inst, stream, generation)
                    )
                else:
                    # synchronous restore: baseline modes never fire the
                    # callback; spice_sync already did (don't re-record)
                    handle._pin()
                    if handle.event_ts(EVT_WS_READY) is None:
                        handle.record(EVT_WS_READY)
                restore_wait = time.perf_counter() - t0  # sync restore part
                handle.record(EVT_RUNNING)
                if inv.prewarm:
                    # speculative restore: promote to warm below, but there
                    # is no request to serve — generation is skipped
                    toks, ttft = _EMPTY_TOKENS, 0.0
                else:
                    toks, ttft = generate(
                        cfg, getter, state, prompt, max_new_tokens,
                        device=self.device,
                    )
                ttl = self.keepalive.ttl_for(spec)
                now = time.time()
                if (
                    isinstance(stats, RestoreStats)
                    and stats.residual_tensors > 0
                    and ttl > 0
                    and getter is not None
                    # two-phase promotion: WARM-at-working-set.  Wait only
                    # for the traced working set, promote to WARMING so the
                    # next invocations route warm immediately, and finalize
                    # WARM in the background once the residual drains.  A
                    # timed-out working set (stalled storage) falls through
                    # to the synchronous full-restore path: an instance must
                    # never claim warm without its working set resident.
                    and stats.wait_working_set(timeout=300)
                ):
                    with inst.cond:
                        inst.promote_warming(ttl, now, est_bytes=stats.image_bytes)
                        inst.counters["ws_promotions"] += 1
                    self._bump("ws_promotions")
                    self._watch_residual(fname, inst, state, getter, stats)
                    total = time.perf_counter() - t0
                else:
                    if isinstance(stats, RestoreStats):
                        # snapshot-consistent stats: wait for the stream to
                        # finish (it closes the JIF reader) before reporting
                        stats.wait_complete(timeout=300)
                    total = time.perf_counter() - t0
                    with inst.cond:
                        resolved = getter(state) if (getter and ttl > 0) else state
                        inst.promote_warm(resolved, ttl, now)
            except BaseException:
                with inst.cond:
                    inst.abort_restore()
                raise
            # a speculative restore is accounted apart from demand cold
            # starts: the whole point is that it happens BEFORE a request
            # needs it, so it must not inflate the cold-start count
            self._bump("speculative_restores" if inv.prewarm else "cold_starts")
            if ttl > 0:
                self._charge_warm_instance(inst)
                self._enforce_budget(keep=fname)
            return InvokeResult(
                toks, cold=True, mode="prewarm" if inv.prewarm else mode,
                restore_wait_s=restore_wait,
                ttft_s=restore_wait + ttft,  # time-to-first-token from request
                total_s=total,
                stats=stats.as_dict() if stats else None,
                function=fname, queue_s=queue_s, node=self.name,
            )
        finally:
            with inst.cond:
                inst.inflight -= 1
                inst.cond.notify_all()

    def _enforce_budget(self, keep: Optional[str] = None) -> None:
        """Bring the ledger back under budget: reap expired TTLs, then run
        the reclaim ladder (residual → image cache → warm LRU) for exactly
        the overshoot.  ``keep`` protects a just-promoted instance."""
        if self.memory_budget is None:
            return
        self.reap_expired()  # free expired TTLs before sacrificing LRU state
        over = self.memory.over_budget()
        if over > 0:
            self.memory.reclaim(over, protect=frozenset((keep,)) if keep else None)

    # ------------------------------------------------------- reclaim ladder
    def evict_residual(self, fname: str) -> int:
        """Drop one WARM instance's residual pages, pinning its working set
        (manual trigger of ladder rung 0).  Returns the bytes freed."""
        inst = self.instance(fname)
        if inst is None:
            return 0
        with inst.cond:
            freed = inst.evict_residual()
        if freed:
            self._bump("residual_evictions")
        return freed

    def _reclaim_residual(self, nbytes: int, protect=frozenset()) -> int:
        """Ladder rung 0: drop residual tails of idle WARM instances (LRU
        order).  Their working sets stay pinned, so the re-restore reads
        only the bytes dropped here — the cheapest memory on the node."""
        with self._ilock:
            insts = list(self._instances.values())
        freed = 0
        for inst in sorted(insts, key=lambda i: i.last_used):
            if freed >= nbytes:
                break
            if inst.spec.name in protect:
                continue
            with inst.cond:
                got = inst.evict_residual()
            if got:
                freed += got
                self._bump("residual_evictions")
        return freed

    def _reclaim_pool(self, nbytes: int, protect=frozenset()) -> int:
        """Ladder rung 2: trim the pool's free staging buffers (the pool
        may have been swapped since registration, so resolve it live)."""
        return self._pool.reclaim(nbytes, protect)

    def _reclaim_warm_lru(self, nbytes: int, protect=frozenset()) -> int:
        """Ladder rung 3: first drop pinned working sets of residual-evicted
        instances, then LRU-evict idle WARM instances (keep-alive policy
        picks the order)."""
        with self._ilock:
            insts = list(self._instances.values())
        freed = 0
        pinned = [
            i for i in insts
            if i.ws_pinned is not None and i.spec.name not in protect
        ]
        for inst in sorted(pinned, key=lambda i: i.last_used):
            if freed >= nbytes:
                return freed
            with inst.cond:
                got = inst.drop_ws_pinned()
            if got:
                freed += got
                self._bump("lru_evictions")
        warm = [
            i for i in insts
            if i.state is InstanceState.WARM and i.idle
            and i.spec.name not in protect
        ]
        for victim in self.keepalive.victims(warm, need_evict=len(warm)):
            if freed >= nbytes:
                break
            with victim.cond:
                # count only what the ledger actually gets back (regions);
                # an uncharged instance still gets evicted, but reporting
                # its bytes as reclaimed would let reclaim() over-promise
                got = sum(
                    reg.nbytes
                    for reg in (victim.ws_region, victim.residual_region)
                    if reg is not None
                )
                if victim.evict("lru"):
                    freed += got
                    self._bump("lru_evictions")
        return freed

    def _restore_canceller(self, inst: FunctionInstance, stream, generation: int):
        """Build the mid-restore cancel hook for one restore generation:
        abort the prefetch stream (failing its handles and returning every
        ledger reservation through the restore's existing failure paths) —
        but only while this invocation is the restore's SOLE rider, so a
        cancel never fails joiners that trusted the shared tree."""

        def cancel() -> bool:
            if not inst.restore_abortable(generation):
                return False
            stream.abort(InvocationCancelled(
                f"{inst.spec.name}: invocation cancelled mid-restore"
            ))
            # abort() no-ops on a completed stream: only report success
            # when the stream actually died with our cancellation
            return isinstance(stream.error, InvocationCancelled)

        return cancel

    def _install_policy(self):
        """Resolve the node's ``install`` policy to SpiceRestorer kwargs:
        (transform, device_path) — exactly one is non-None, except "host"
        where both are (tensors stay host numpy)."""
        if callable(self.install):
            return self.install, None
        if self.install == "host":
            return None, None
        if self.install == "fused":
            return None, DevicePath(
                upload=self.upload_stream, images=self.device_images
            )
        if self.install == "eager":
            # eager install: numpy -> device tensor on the prefetcher thread
            # (the PTE-install analogue), so execution never pays conversion
            # copies.  MUST copy: on the CPU torch.from_numpy aliases the
            # staging buffer, which the restorer recycles into the zero pool.
            dev = self.device
            return (lambda a: to_torch(a, dev, copy=True)), None
        raise ValueError(f"unknown install policy {self.install!r}")

    @staticmethod
    def _baseline_install(transform, device_path):
        """Per-leaf install for baseline modes (no upload ring there):
        fused degrades to an eager device copy, host stays a no-op."""
        if transform is not None:
            return transform
        if device_path is not None:
            return device_path.installer()
        return lambda a: a

    def _cold_restore(self, spec: FunctionSpec, mode: str, sim_bw=None,
                      preloaded=None, pinned_region=None, io_priority: int = 0,
                      on_working_set=None):
        """Returns (state, stats, getter, (ws_region, residual_region),
        stream).  Spice restores reserve their regions up front through the
        node ledger — a restore that cannot fit fails fast
        (MemoryPressureError) or triggers the reclaim ladder instead of
        over-committing.  ``pinned_region`` (a residual-evicted instance's
        retained ws charge) transfers into the spice restore's ws region;
        baseline modes re-read everything, so it is released here.
        ``io_priority`` (the QoS class's stream priority) ranks this
        restore's reads at the shared arbiter; ``stream`` is the live
        prefetch stream for cancellation (None for baseline modes)."""
        if pinned_region is not None and mode not in ("spice", "spice_sync"):
            pinned_region.release()
            pinned_region = None
        transform, device_path = self._install_policy()
        install = self._baseline_install(transform, device_path)
        if mode == "spice":
            restorer = SpiceRestorer(
                pool=self.pool, node_cache=self.node_cache,
                transform=transform, simulate_read_bw=sim_bw,
                iosched=self.iosched, memory=self.memory,
                stream_priority=io_priority, device_path=device_path,
                chunks=self.chunks,
            )
            state, meta, handles, stats = restorer.restore(
                spec.jif_path, wait=False, preloaded=preloaded,
                preloaded_region=pinned_region, on_working_set=on_working_set,
            )
            return state, stats, wait_tree, restorer.regions, restorer.stream
        if mode == "spice_sync":
            restorer = SpiceRestorer(
                pool=self.pool, node_cache=self.node_cache, pipelined=False,
                transform=transform, simulate_read_bw=sim_bw,
                iosched=self.iosched, memory=self.memory,
                stream_priority=io_priority, device_path=device_path,
                chunks=self.chunks,
            )
            state, meta, handles, stats = restorer.restore(
                spec.jif_path, wait=True, preloaded=preloaded,
                preloaded_region=pinned_region, on_working_set=on_working_set,
            )
            # inline stream already drained: nothing left to cancel
            return state, stats, None, restorer.regions, None
        if mode == "criu_star":
            state, stats = baselines.criu_star_restore(
                spec.jif_path.replace(".jif", ".criu"), simulate_read_bw=sim_bw
            )
            state = tree_map(install, state)
            return state, stats, None, (self._charge_baseline(spec, state), None), None
        if mode == "reap_star":
            state, stats = baselines.reap_star_restore(
                spec.jif_path.replace(".jif", ".mono"), simulate_read_bw=sim_bw
            )
            state = tree_map(install, state)
            return state, stats, None, (self._charge_baseline(spec, state), None), None
        if mode == "faasnap_star":
            r = baselines.FaasnapAsyncRestorer(
                spec.jif_path.replace(".jif", ".mono"), simulate_read_bw=sim_bw
            )
            # rebuild a handle-like tree backed by ensure()
            leaves = {
                t["name"]: _FaasnapLeaf(r, t["name"])
                for t in r.r.header["tensors"]
                if not t["name"].startswith("__extra__/")
            }
            state = unflatten_state(r.r.header["tree"], leaves)
            getter = partial(faasnap_wait, device=self.device)
            return state, r.stats, getter, (None, None), None
        raise ValueError(f"unknown restore mode {mode!r}")

    def _charge_baseline(self, spec: FunctionSpec, state):
        """Baseline restores bypass the spice admission path; charge their
        resident bytes to the ledger anyway so eviction pressure sees them.
        Best-effort: a baseline run on an over-subscribed node proceeds
        uncharged (the measured systems never refused admission either)."""
        try:
            return self.memory.reserve(
                _tree_nbytes(state), KIND_WORKING_SET,
                owner=spec.name, timeout=5.0, protect=(spec.name,),
            )
        except MemoryPressureError:
            return None

    def _charge_warm_instance(self, inst: FunctionInstance) -> None:
        """Post-promotion charge for instances that reached WARM without
        ledger regions — baseline modes whose state only materialized at
        promotion (faasnap's lazy fault-in tree).  Without this, their warm
        residency would be invisible to budget pressure."""
        with inst.cond:
            if inst.state is not InstanceState.WARM or inst.ws_region is not None:
                return
            nbytes = inst.memory_bytes
            generation = inst.generation
            fname = inst.spec.name
        if not nbytes:
            return
        try:
            region = self.memory.reserve(
                nbytes, KIND_WORKING_SET, owner=fname,
                timeout=5.0, protect=(fname,),
            )
        except MemoryPressureError:
            return  # best-effort, like _charge_baseline
        region.commit(pinned="working_set")
        with inst.cond:
            if (
                inst.state is InstanceState.WARM
                and inst.ws_region is None
                and inst.generation == generation
            ):
                inst.ws_region = region
            else:  # evicted/re-restored while we reserved
                region.release()
