"""Predictive pre-warm & cost-aware warmth policy engine.

Spice makes cold restores near-warm; this module drives the cold-start
*count* toward zero at a bounded memory premium, following the two
results PAPERS.md retrieved for this exact trade-off:

* SPES (arxiv 2403.17574): per-function invocation *prediction* — not a
  fleet-wide TTL knob — optimizes the performance/resource frontier.
* The cold-start survey (arxiv 2310.08437) taxonomizes hybrid-histogram
  keep-alive as the state of the art: serve the histogram *head* with an
  adaptive keep-alive window, and push the *long tail* onto the fast
  restore path instead of burning memory on idle instances.

Three pieces, each mapping onto machinery the stack already has:

* :class:`ArrivalTracker` — per-function inter-arrival histograms fed
  from the invocation front door (``ClusterRouter.submit_invocation``)
  and the control plane's warm-trace hook
  (``FunctionCatalog.record_access``).  Log-spaced buckets keep the
  state O(1) per function; per-bucket max gives tight upper-bound
  quantiles for periodic traffic.
* :class:`PrewarmPolicy` — a :class:`~repro_torch.serve.node.KeepAlivePolicy`
  whose ``ttl_for`` derives a per-function window from the histogram
  head (gap quantile × margin, clamped), falling back to a short
  ``tail_ttl_s`` for long-tail functions (rely on restore + speculation
  instead of residency), and whose ``victims`` ranks eviction
  candidates by *expected re-restore penalty*: predicted
  time-to-next-invoke versus the estimated bytes a re-restore would
  actually pull (residual-only re-reads, chunk-CAS and device-image
  residency — :func:`repro_torch.core.restore.estimate_rerestore_cost`).
* :class:`PrewarmEngine` — speculates restores of likely-next functions
  *through the existing admission/QoS path*: each speculation is a
  BATCH-class :class:`~repro_torch.serve.invocation.Invocation` with
  ``prewarm=True`` submitted to the router, so it lands on the node
  ``LocalityFirst`` would pick, queues behind every LATENCY/STANDARD
  request, streams at BATCH I/O priority, bounces off the admission
  controller under load, and — because restores are joinable — merges
  with a real invocation that arrives mid-restore instead of doubling
  the I/O.  A mispredicted speculation is just an idle warm instance:
  the reaper or the reclaim ladder takes it back.
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from repro_torch.core.restore import estimate_rerestore_cost
from repro_torch.serve.invocation import (
    DeadlineExceeded,
    Invocation,
    InvocationHandle,
    Overloaded,
    QosClass,
)
from repro_torch.serve.node import KeepAlivePolicy

__all__ = ["ArrivalTracker", "PrewarmPolicy", "PrewarmEngine"]

# log2-spaced gap buckets: bucket 0 holds gaps <= _BASE_S, bucket i holds
# (_BASE_S * 2**(i-1), _BASE_S * 2**i]; 40 buckets span 1 ms .. ~6 days.
_BASE_S = 1e-3
_N_BUCKETS = 40


def _bucket(gap_s: float) -> int:
    if gap_s <= _BASE_S:
        return 0
    return min(_N_BUCKETS - 1, 1 + int(math.log2(gap_s / _BASE_S)))


class _FnArrivals:
    __slots__ = ("last_ts", "gaps", "counts", "maxima")

    def __init__(self) -> None:
        self.last_ts: Optional[float] = None
        self.gaps = 0  # total inter-arrival samples
        self.counts = [0] * _N_BUCKETS
        self.maxima = [0.0] * _N_BUCKETS  # max gap seen per bucket


class ArrivalTracker:
    """Per-function inter-arrival histograms (``time.monotonic`` domain).

    ``record`` is called on the router's submit path, so it is O(1) and
    takes one short lock.  Quantiles come back as the *observed maximum*
    of the bucket the quantile falls in — a tight upper bound for the
    periodic traffic keep-alive windows are derived from."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fns: Dict[str, _FnArrivals] = {}

    # ------------------------------------------------------------- feeding
    def record(self, fname: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            fn = self._fns.get(fname)
            if fn is None:
                fn = self._fns[fname] = _FnArrivals()
            if fn.last_ts is not None:
                gap = now - fn.last_ts
                if gap > 0:
                    b = _bucket(gap)
                    fn.counts[b] += 1
                    fn.gaps += 1
                    if gap > fn.maxima[b]:
                        fn.maxima[b] = gap
            fn.last_ts = now

    # ------------------------------------------------------------- queries
    def functions(self) -> List[str]:
        with self._lock:
            return list(self._fns)

    def observations(self, fname: str) -> int:
        """Inter-arrival samples recorded for ``fname`` (arrivals - 1)."""
        with self._lock:
            fn = self._fns.get(fname)
            return fn.gaps if fn else 0

    def last_arrival(self, fname: str) -> Optional[float]:
        with self._lock:
            fn = self._fns.get(fname)
            return fn.last_ts if fn else None

    def gap_quantile(
        self, fname: str, q: float, min_observations: int = 1
    ) -> Optional[float]:
        """The ``q``-quantile inter-arrival gap (seconds), or None when
        fewer than ``min_observations`` gaps were recorded."""
        with self._lock:
            fn = self._fns.get(fname)
            if fn is None or fn.gaps < max(1, min_observations):
                return None
            target = q * fn.gaps
            cum = 0
            for b in range(_N_BUCKETS):
                cum += fn.counts[b]
                if fn.counts[b] and cum >= target:
                    return fn.maxima[b]
            return fn.maxima[_N_BUCKETS - 1] or None

    def predict_eta(
        self,
        fname: str,
        now: Optional[float] = None,
        min_observations: int = 1,
        q: float = 0.5,
    ) -> Optional[float]:
        """Seconds until the *predicted* next arrival of ``fname`` (the
        median gap after its last arrival); negative = overdue; None =
        not enough history."""
        gap = self.gap_quantile(fname, q, min_observations)
        if gap is None:
            return None
        with self._lock:
            last = self._fns[fname].last_ts
        now = time.monotonic() if now is None else now
        return (last + gap) - now

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            items = list(self._fns.items())
        for name, fn in items:
            out[name] = {
                "gaps": fn.gaps,
                "median_gap_s": self.gap_quantile(name, 0.5) or 0.0,
                "p90_gap_s": self.gap_quantile(name, 0.9) or 0.0,
            }
        return out


# ---------------------------------------------------------------- the policy
class PrewarmPolicy(KeepAlivePolicy):
    """Hybrid-histogram keep-alive + cost-aware eviction ranking.

    ``ttl_for``: the histogram-head window ``gap_quantile(head_quantile)
    × ttl_margin``, clamped into ``[min_ttl_s, max_ttl_s]``.  A function
    whose head window would exceed ``max_ttl_s`` is *long tail*: keeping
    it resident buys nothing per byte, so it gets the short
    ``tail_ttl_s`` grace (sized to cover the engine's speculation
    horizon) and relies on the fast restore path.  Unknown functions
    fall back to ``default_ttl_s`` (or the spec's static
    ``warm_ttl_s``).

    ``victims``: eviction candidates ranked by expected re-restore
    penalty ``cost_bytes / eta_s`` — the instance that is cheapest to
    bring back *and* least likely to be needed soon goes first; an
    imminent (or overdue) predicted arrival makes the penalty spike so
    the instance survives.  The cost estimate accounts for pinned
    working sets (residual-only re-read), chunk-CAS residency and
    device-resident bases via the node-bound ``cost_fn``
    (:meth:`repro_torch.serve.node.NodeScheduler.rerestore_cost` — wired
    automatically when a node adopts this policy).  Honors
    ``need_evict``: at most that many instances come back.

    Share one :class:`ArrivalTracker` across a fleet but give each node
    its own policy instance, so each node's residency feeds its own
    cost function."""

    def __init__(
        self,
        tracker: ArrivalTracker,
        *,
        default_ttl_s: Optional[float] = None,
        min_ttl_s: float = 0.05,
        max_ttl_s: float = 30.0,
        tail_ttl_s: Optional[float] = None,
        head_quantile: float = 0.9,
        ttl_margin: float = 1.25,
        min_observations: int = 3,
        unknown_eta_s: float = 60.0,
        cost_fn=None,
    ):
        self.tracker = tracker
        self.default_ttl_s = default_ttl_s
        self.min_ttl_s = min_ttl_s
        self.max_ttl_s = max_ttl_s
        self.tail_ttl_s = tail_ttl_s if tail_ttl_s is not None else max(
            min_ttl_s, 0.5
        )
        self.head_quantile = head_quantile
        self.ttl_margin = ttl_margin
        self.min_observations = min_observations
        self.unknown_eta_s = unknown_eta_s
        self.cost_fn = cost_fn

    def bind_node(self, node) -> None:
        """Adopt the node's residency-aware re-restore cost estimate
        (called by :class:`~repro_torch.serve.node.NodeScheduler` on
        construction; an explicitly injected ``cost_fn`` wins)."""
        if self.cost_fn is None:
            self.cost_fn = node.rerestore_cost

    # ---------------------------------------------------------------- TTL
    def ttl_for(self, spec) -> float:
        gap = self.tracker.gap_quantile(
            spec.name, self.head_quantile, self.min_observations
        )
        if gap is None:
            if self.default_ttl_s is not None:
                return self.default_ttl_s
            return spec.warm_ttl_s
        ttl = gap * self.ttl_margin
        if ttl > self.max_ttl_s:
            return self.tail_ttl_s  # long tail: restore, don't idle
        return max(ttl, self.min_ttl_s)

    # ----------------------------------------------------------- eviction
    def _cost(self, inst) -> int:
        if self.cost_fn is not None:
            return self.cost_fn(inst)
        return estimate_rerestore_cost(
            inst.restore_stats, image_bytes=inst.memory_bytes
        )

    def victims(self, warm, need_evict: int):
        now = time.monotonic()
        scored: List[Tuple[float, float, int, object]] = []
        for inst in warm:
            eta = self.tracker.predict_eta(
                inst.spec.name, now=now,
                min_observations=self.min_observations,
            )
            if eta is None:
                eta = self.unknown_eta_s
            # imminent or overdue arrival -> near-zero eta -> the penalty
            # spikes and the instance is sacrificed last
            eta = max(eta, 1e-3)
            penalty = self._cost(inst) / eta
            scored.append((penalty, inst.last_used, id(inst), inst))
        scored.sort(key=lambda s: (s[0], s[1]))
        return [s[3] for s in scored[: max(0, need_evict)]]


# ---------------------------------------------------------------- the engine
class PrewarmEngine:
    """Issues speculative restores of likely-next functions.

    Attach to a :class:`~repro_torch.serve.cluster.ClusterRouter` (pass it as
    ``ClusterRouter(prewarm=engine)``); the router feeds every real
    arrival into the tracker and the engine ticks on a daemon thread
    (weakref'd, like the node reaper: a dropped fleet is GC-able).

    Admission rules for speculation — all inherited, none bespoke:

    * placement: the speculation is a normal router submit, so it lands
      on the node the placement policy (``LocalityFirst``) picks —
      warm > joinable > image-cached — and sticky routing guarantees a
      real invocation arriving mid-restore lands on the SAME node and
      joins the in-flight restore (exactly one set of storage reads).
    * QoS: BATCH class — dispatched after every LATENCY/STANDARD entry
      in the run queue, prefetch stream opened at I/O priority −1
      (above only residual tails), never triggers scale-out or steals.
    * backpressure: the node's :class:`AdmissionController` caps apply
      (``max_batch_queued`` / ``max_batch_inflight``); a refusal is
      counted and dropped, never retried into a loaded node.  The
      engine additionally caps its own in-flight speculations.

    A ``prewarm=True`` invocation restores and promotes but skips
    generation; one that finds its function already warm (or restoring)
    is a no-op."""

    def __init__(
        self,
        tracker: Optional[ArrivalTracker] = None,
        *,
        horizon_s: float = 0.3,
        overdue_grace_s: float = 0.25,
        interval_s: Optional[float] = 0.05,
        max_inflight: int = 4,
        min_observations: int = 3,
        speculative: bool = True,
        mode: str = "spice",
        simulate_read_bw: Optional[float] = None,
    ):
        """``horizon_s``: speculate when the predicted next arrival is
        within this window (pair with a ``PrewarmPolicy.tail_ttl_s``
        comfortably above it, so the speculative instance survives
        until the predicted arrival).  ``speculative=False`` keeps the
        arrival feed (adaptive TTLs still learn) but never restores —
        the "adaptive, no speculation" ablation regime."""
        self.tracker = tracker if tracker is not None else ArrivalTracker()
        self.horizon_s = horizon_s
        self.overdue_grace_s = overdue_grace_s
        self.interval_s = interval_s
        self.max_inflight = max_inflight
        self.min_observations = min_observations
        self.speculative = speculative
        self.mode = mode
        self.simulate_read_bw = simulate_read_bw
        self._router_ref = None
        self._lock = threading.Lock()
        self._inflight: Dict[str, InvocationHandle] = {}
        self._stop: Optional[threading.Event] = None
        self.stats = {
            "ticks": 0,
            "speculative_submitted": 0,
            "speculative_ok": 0,
            "speculative_failed": 0,
            "suppressed_resident": 0,
            "suppressed_inflight": 0,
            "suppressed_admission": 0,
        }

    # -------------------------------------------------------------- wiring
    def attach(self, router) -> None:
        """Bind to a router (called by ``ClusterRouter.__init__``): wire
        the catalog's access feed to the tracker and start ticking."""
        self._router_ref = weakref.ref(router)
        if router.catalog is not None:
            router.catalog.arrival_tracker = self.tracker
        if self.interval_s is not None and self.speculative:
            self.start(self.interval_s)

    def on_arrival(self, fname: str, now: Optional[float] = None) -> None:
        self.tracker.record(fname, now)

    def start(self, interval_s: Optional[float] = None) -> None:
        self.stop()
        interval = interval_s if interval_s is not None else self.interval_s
        if interval is None:
            return
        stop = threading.Event()
        self._stop = stop
        ref = weakref.ref(self)

        def loop():
            while not stop.wait(interval):
                eng = ref()
                if eng is None:
                    return
                try:
                    eng.tick()
                except Exception:
                    pass  # a failed tick must not kill the engine
                finally:
                    eng = None  # never hold the engine across the sleep

        threading.Thread(
            target=loop, name="prewarm-engine", daemon=True
        ).start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    # --------------------------------------------------------------- ticking
    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def _reap_done(self) -> None:
        with self._lock:
            done = [(f, h) for f, h in self._inflight.items() if h.done()]
            for f, _ in done:
                del self._inflight[f]
        for _, h in done:
            ok = h.exception() is None
            self._bump("speculative_ok" if ok else "speculative_failed")

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every in-flight speculation resolved (benchmark
        barrier); returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._reap_done()
            if not self._inflight:
                return True
            time.sleep(0.01)
        return False

    def tick(self, now: Optional[float] = None) -> int:
        """One speculation pass; returns speculations issued.  Runs on
        the background thread, but callable directly (tests)."""
        self._bump("ticks")
        router = self._router_ref() if self._router_ref is not None else None
        if router is None or not self.speculative:
            return 0
        self._reap_done()
        now = time.monotonic() if now is None else now
        due: List[Tuple[float, str]] = []
        for fname in self.tracker.functions():
            eta = self.tracker.predict_eta(
                fname, now=now, min_observations=self.min_observations
            )
            if eta is None or eta > self.horizon_s:
                continue
            if eta < -self.overdue_grace_s:
                continue  # stale prediction: the arrival never came
            due.append((eta, fname))
        if not due:
            return 0
        resident = set()
        for load in router.loads():
            resident |= load.warm | load.restoring
        issued = 0
        for _, fname in sorted(due):
            with self._lock:
                if fname in self._inflight:
                    self.stats["suppressed_inflight"] += 1
                    continue
                if len(self._inflight) >= self.max_inflight:
                    break
            if fname in resident:
                self._bump("suppressed_resident")
                continue
            try:
                router.catalog.registry.get(fname)
            except KeyError:
                continue  # tracked name that was never published here
            inv = Invocation(
                function=fname,
                prompt=None,
                max_new_tokens=0,
                mode=self.mode,
                simulate_read_bw=self.simulate_read_bw,
                qos=QosClass.BATCH,
                prewarm=True,
            )
            try:
                handle = router.submit_invocation(inv)
            except (Overloaded, DeadlineExceeded):
                self._bump("suppressed_admission")
                continue
            with self._lock:
                self._inflight[fname] = handle
                self.stats["speculative_submitted"] += 1
            issued += 1
        return issued
