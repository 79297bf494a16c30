"""SLO-driven elastic autoscaling with warm-state handoff on scale-in.

The static ``scale_out_queue_depth`` knob sizes a fleet for its worst
minute: a queue-depth threshold neither knows what latency the user
actually experiences nor ever gives a node back.  This module closes the
loop against *declared service objectives* instead:

* :class:`ServiceSLO` — per-QoS-class targets (TTFT p99, queue-wait p95),
  the contract the operator writes down.
* :class:`SLOMonitor` — sliding-window per-class percentile tracker, fed
  by every node's ``on_result`` hook (speculative pre-warms and handoff
  restores are excluded: they are not requests).
* :class:`AutoScaler` — the control loop.  On *sustained* violation it
  joins a node to the fleet (hysteresis: one slow request never buys a
  machine); on sustained slack it DRAINS the least-loaded node:

  1. stop placement (``router.set_draining``) — queued work completes;
  2. quiesce, then hand off the node's warm instances to successors,
     most-valuable-first (:class:`~repro_torch.serve.prewarm.PrewarmPolicy`'s
     cost-aware score, reversed), via
     :func:`repro_torch.serve.handoff.handoff_warm` — scale-in converts ZERO
     warm instances into future cold starts;
  3. release the node's residual stream and ledger (audit-clean) and
     remove it from the fleet.

``tick()`` is a plain method: benchmarks call it from the replay loop for
determinism, deployments run :meth:`AutoScaler.start` for a daemon-thread
loop (weakref'd like the node reaper — a dropped fleet is GC-able).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import weakref
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.serve.handoff import HandoffStats, handoff_warm
from repro_torch.serve.invocation import QosClass
from repro_torch.serve.node import InvokeResult, NodeScheduler

__all__ = ["ServiceSLO", "SLOMonitor", "AutoScaler"]


# ------------------------------------------------------------- the contract
@dataclasses.dataclass(frozen=True)
class ServiceSLO:
    """Targets for one QoS class; ``None`` leaves that metric unbounded."""

    qos: QosClass
    ttft_p99_s: Optional[float] = None
    queue_wait_p95_s: Optional[float] = None


def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in (0, 1]) over a non-empty list."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[rank - 1]


# -------------------------------------------------------------- the monitor
class SLOMonitor:
    """Sliding-window per-class latency percentiles.

    ``observe`` is wired as every node's ``on_result`` hook — it runs on
    the node's drain thread, so it is O(1) append under one short lock.
    Pre-warm results (speculative restores, warm-state handoffs) are
    excluded: they are infrastructure, not requests."""

    def __init__(self, window_s: float = 10.0, min_samples: int = 8):
        self.window_s = window_s
        self.min_samples = min_samples
        self._lock = threading.Lock()
        # (monotonic ts, qos value, ttft_s, queue_wait_s)
        self._samples: Deque[Tuple[float, str, float, float]] = (
            collections.deque()
        )

    def observe(self, result: InvokeResult) -> None:
        if result.mode == "prewarm":
            return
        with self._lock:
            self._samples.append((
                time.monotonic(), result.qos,
                float(result.ttft_s), float(result.queue_wait_s),
            ))

    def _window(self, now: float) -> List[Tuple[float, str, float, float]]:
        cutoff = now - self.window_s
        with self._lock:
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            return list(self._samples)

    def percentile(
        self, qos: QosClass, metric: str, q: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed percentile of ``metric`` ("ttft" | "queue_wait") for
        one class; None when the window holds no samples of that class."""
        now = time.monotonic() if now is None else now
        idx = 2 if metric == "ttft" else 3
        values = [s[idx] for s in self._window(now) if s[1] == qos.value]
        if not values:
            return None
        return _percentile(values, q)

    # ------------------------------------------------------------ assessment
    def assess(
        self, slos: List[ServiceSLO], now: Optional[float] = None,
        slack_margin: float = 0.5,
    ) -> Tuple[List[str], bool]:
        """Evaluate the window against the declared SLOs.

        Returns ``(violations, slack)``: human-readable violation strings
        (empty = within SLO), and whether EVERY bounded metric sits under
        ``slack_margin`` × its target (an idle window — no samples — also
        counts as slack: nothing is arriving that a smaller fleet would
        hurt).  A class needs ``min_samples`` in-window samples before it
        can violate — one slow request is noise, not a trend."""
        now = time.monotonic() if now is None else now
        window = self._window(now)
        violations: List[str] = []
        slack = True
        for slo in slos:
            rows = [s for s in window if s[1] == slo.qos.value]
            checks: List[Tuple[str, int, float, float]] = []
            if slo.ttft_p99_s is not None:
                checks.append(("ttft", 2, 0.99, slo.ttft_p99_s))
            if slo.queue_wait_p95_s is not None:
                checks.append(("queue_wait", 3, 0.95, slo.queue_wait_p95_s))
            for name, idx, q, target in checks:
                if not rows:
                    continue  # idle class: no evidence either way -> slack
                value = _percentile([r[idx] for r in rows], q)
                if len(rows) >= self.min_samples and value > target:
                    violations.append(
                        f"{slo.qos.value}:{name} p{int(q * 100)}"
                        f"={value:.3f}s > {target:.3f}s"
                    )
                    slack = False
                elif value > slack_margin * target:
                    slack = False
        return violations, slack


# ----------------------------------------------------------- the control loop
class AutoScaler:
    """Elastic fleet controller: grow on sustained SLO violation, drain
    (with warm-state handoff) on sustained slack.

    ``node_factory(name) -> NodeScheduler`` provisions a node when the
    loop scales out (the benchmark builds one with the fleet's chunk
    cache/ledger shape; a deployment would boot a machine).  ``keepalive``
    (a :class:`~repro_torch.serve.prewarm.PrewarmPolicy`) ranks a draining
    node's warm instances by re-restore cost / predicted demand; handoffs
    run most-valuable-first so, if the drain budget runs out, what is
    dropped is what was cheapest to lose.  ``handoff=False`` is the
    drain-and-evict ablation: scale-in simply evicts warm state, and the
    next request for each function pays a full cold restore.

    Node-seconds (the cost metric benchmarks compare) accrue per node from
    join (or :meth:`attach`) to removal."""

    def __init__(
        self,
        router,
        slos: List[ServiceSLO],
        *,
        handoff_dir: str,
        node_factory: Optional[Callable[[str], NodeScheduler]] = None,
        monitor: Optional[SLOMonitor] = None,
        keepalive=None,
        min_nodes: int = 1,
        max_nodes: Optional[int] = None,
        scale_out_after: int = 2,
        scale_in_after: int = 5,
        slack_margin: float = 0.5,
        handoff: bool = True,
        drain_timeout_s: float = 30.0,
        simulate_read_bw: Optional[float] = None,
    ):
        self.router = router
        self.slos = list(slos)
        self.handoff_dir = handoff_dir
        self.node_factory = node_factory
        self.monitor = monitor or SLOMonitor()
        self.keepalive = keepalive
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.scale_out_after = scale_out_after
        self.scale_in_after = scale_in_after
        self.slack_margin = slack_margin
        self.handoff = handoff
        self.drain_timeout_s = drain_timeout_s
        self.simulate_read_bw = simulate_read_bw
        self._lock = threading.Lock()
        self._violating_ticks = 0
        self._slack_ticks = 0
        self._next_node_id = 0
        self._active_since: Dict[str, float] = {}
        self._node_seconds = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self.handoffs: List[HandoffStats] = []
        self.events: List[Dict] = []  # (t, action, node, detail) audit trail
        self.stats = {
            "ticks": 0,
            "scale_outs": 0,
            "scale_ins": 0,
            "handoffs_ok": 0,
            "handoffs_failed": 0,
            "drain_evictions": 0,
            "handoff_delta_bytes": 0,
            "handoff_restore_read_bytes": 0,
        }
        self.attach()

    # ------------------------------------------------------------- plumbing
    def attach(self) -> None:
        """Wire the monitor into every current node and start their
        node-seconds clocks (idempotent)."""
        now = time.monotonic()
        for node in list(self.router.nodes):
            node.on_result = self.monitor.observe
            self._active_since.setdefault(node.name, now)

    def node_seconds(self, now: Optional[float] = None) -> float:
        """Accumulated fleet cost: sum over nodes of active wall-clock."""
        now = time.monotonic() if now is None else now
        with self._lock:
            live = sum(now - t0 for t0 in self._active_since.values())
            return self._node_seconds + live

    def _event(self, action: str, node: str, detail: str = "") -> None:
        self.events.append({
            "t": time.monotonic(), "action": action,
            "node": node, "detail": detail,
        })

    # ----------------------------------------------------------- the loop
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control decision; returns "scale_out"/"scale_in"/None.
        Callable inline (deterministic benchmarks) or from the daemon
        thread (:meth:`start`)."""
        self.stats["ticks"] += 1
        now = time.monotonic() if now is None else now
        violations, slack = self.monitor.assess(
            self.slos, now=now, slack_margin=self.slack_margin
        )
        if violations:
            self._violating_ticks += 1
            self._slack_ticks = 0
            if (
                self._violating_ticks >= self.scale_out_after
                and (self.max_nodes is None
                     or len(self.router.nodes) < self.max_nodes)
                and self.node_factory is not None
            ):
                self._violating_ticks = 0
                return self._scale_out("; ".join(violations))
            return None
        self._violating_ticks = 0
        if slack:
            self._slack_ticks += 1
            if (
                self._slack_ticks >= self.scale_in_after
                and len(self.router.nodes) > self.min_nodes
            ):
                self._slack_ticks = 0
                return self._scale_in()
        else:
            self._slack_ticks = 0
        return None

    def _scale_out(self, reason: str) -> str:
        with self._lock:
            self._next_node_id += 1
            name = f"scale{self._next_node_id}"
        node = self.node_factory(name)
        if not node.name:
            node.name = name
        self.router.add_node(node)
        node.on_result = self.monitor.observe
        with self._lock:
            self._active_since[node.name] = time.monotonic()
        self.stats["scale_outs"] += 1
        self._event("scale_out", node.name, reason)
        return "scale_out"

    def _pick_drain_victim(self) -> Optional[NodeScheduler]:
        """Least-loaded non-draining node (fewest in-flight, then fewest
        warm instances — prefer giving back the node with least state to
        move)."""
        draining = set(self.router.draining())
        cands = [n for n in self.router.nodes if n.name not in draining]
        if len(cands) <= self.min_nodes:
            return None
        loads = {n.name: n.load() for n in cands}
        return min(
            cands,
            key=lambda n: (
                loads[n.name].queue_depth,
                len(loads[n.name].warm),
                loads[n.name].pressure,
            ),
        )

    def _scale_in(self) -> Optional[str]:
        victim = self._pick_drain_victim()
        if victim is None:
            return None
        self.drain_node(victim.name)
        self.stats["scale_ins"] += 1
        return "scale_in"

    # -------------------------------------------------------------- draining
    def drain_node(self, name: str) -> NodeScheduler:
        """Drain ``name`` out of the fleet: stop placement, let queued and
        in-flight work complete, hand off (or evict) its warm instances,
        release its residual stream and ledger, remove it.  Returns the
        closed node (its final ``memory.audit()`` ran clean or raised)."""
        node = self.router.node(name)
        self.router.set_draining(name)
        self._event("drain_start", name)
        node.quiesce(self.drain_timeout_s)
        warm = node.warm_instances()
        # most-valuable-first: PrewarmPolicy.victims ranks cheapest-to-lose
        # first, so the handoff order is its reverse — if the drain budget
        # runs out, what is dropped is what was cheapest to re-restore
        if self.keepalive is not None and len(warm) > 1:
            ranked = list(self.keepalive.victims(warm, need_evict=len(warm)))
            ranked.reverse()
            # WARMING instances are absent from a cost ranking (no final
            # restore stats yet); hand them off after the ranked ones
            warm = ranked + [i for i in warm if i not in ranked]
        for inst in warm:
            fname = inst.spec.name
            if self.handoff:
                dst = self._handoff_target(exclude=name)
                if dst is not None:
                    hs = handoff_warm(
                        self.router, fname, name, dst.name,
                        handoff_dir=self.handoff_dir,
                        timeout=self.drain_timeout_s,
                        simulate_read_bw=self.simulate_read_bw,
                    )
                    self.handoffs.append(hs)
                    if hs.ok:
                        self.stats["handoffs_ok"] += 1
                        self.stats["handoff_delta_bytes"] += hs.delta_bytes
                        self.stats["handoff_restore_read_bytes"] += (
                            hs.restore_read_bytes
                        )
                        self._event(
                            "handoff", name,
                            f"{fname} -> {dst.name} "
                            f"({hs.delta_bytes}B delta)",
                        )
                        continue
                    self.stats["handoffs_failed"] += 1
                    self._event("handoff_failed", name,
                                f"{fname}: {hs.reason}")
            # ablation path / handoff fallback: plain eviction — the next
            # request for fname pays a full cold restore somewhere else
            node.evict(fname)
            self.stats["drain_evictions"] += 1
            self._event("drain_evict", name, fname)
        # return the ledger to pre-restore residency: finish any residual
        # streams, drop every remaining instance, then audit
        node.drain_residual(self.drain_timeout_s)
        node.evict()
        self.router.remove_node(name)
        node.close()
        node.memory.audit()  # raises if the drain leaked a reservation
        with self._lock:
            started = self._active_since.pop(name, None)
            if started is not None:
                self._node_seconds += time.monotonic() - started
        self._event("drain_done", name)
        return node

    def _handoff_target(self, exclude: str) -> Optional[NodeScheduler]:
        """Successor for a drained instance: the least-loaded active node
        (locality does not help — the instance exists nowhere else — so
        load headroom decides)."""
        draining = set(self.router.draining())
        cands = [
            n for n in self.router.nodes
            if n.name != exclude and n.name not in draining
        ]
        if not cands:
            return None
        loads = {n.name: n.load() for n in cands}
        return min(
            cands,
            key=lambda n: (
                loads[n.name].queue_depth,
                loads[n.name].pressure,
                len(loads[n.name].warm),
            ),
        )

    # ------------------------------------------------------- daemon thread
    def start(self, interval_s: float = 0.25) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()
        ref = weakref.ref(self)

        def loop(stop: threading.Event) -> None:
            while not stop.wait(interval_s):
                scaler = ref()
                if scaler is None:
                    return
                try:
                    scaler.tick()
                except Exception:
                    pass  # a failed decision must not kill the loop
                del scaler

        self._thread = threading.Thread(
            target=loop, args=(self._stop,),
            name="autoscaler", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._stop = None
