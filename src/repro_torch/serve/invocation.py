"""Invocation API v2 — typed requests, QoS classes, deadlines, cancellation.

The serving stack's original surface was an untyped ``invoke(*args)`` /
bare ``Future`` pair: no way to tell urgent work from background work, no
deadline, no cancellation, no backpressure.  "Near-warm" restores only stay
near-warm under load if the stack can rank work — a burst of batch traffic
must not starve latency-critical restores at the I/O arbiter or the memory
ledger.  This module is the typed front door every layer now speaks:

* :class:`Invocation` — one request: function, prompt, a
  :class:`QosClass` (LATENCY / STANDARD / BATCH), an optional absolute
  deadline, and a within-class priority.
* :class:`InvocationHandle` — replaces the raw Future.  ``result()``,
  best-effort ``cancel()``, and ``events()``: the ADMITTED → PLACED →
  RESTORING → WS_READY → RUNNING → DONE timeline with monotonic
  timestamps (benchmarks split queueing delay from restore delay with it).
* :class:`AdmissionController` — per-function concurrency caps and
  bounded queues; refusals are *typed* (:class:`Overloaded`,
  :class:`DeadlineExceeded`) instead of unbounded thread-pool growth.

QoS threads through every layer: the node dispatches its run queue in
class order, the restorer opens its prefetch stream at the class's I/O
priority (a LATENCY stream overtakes BATCH residual streaming at the
arbiter), and the cluster router may steal a least-loaded node for a
LATENCY invoke where a BATCH invoke waits.  ``invoke()``/``submit()``
survive as thin wrappers building a STANDARD-class :class:`Invocation`.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "QosClass",
    "Invocation",
    "InvocationHandle",
    "AdmissionController",
    "InvocationError",
    "Overloaded",
    "DeadlineExceeded",
    "InvocationCancelled",
    "deadline_in",
    "EVT_ADMITTED",
    "EVT_PLACED",
    "EVT_RESTORING",
    "EVT_WS_READY",
    "EVT_RUNNING",
    "EVT_DONE",
    "EVT_CANCELLED",
    "EVT_REJECTED",
    "EVT_FAILED",
]

# Event names of the invocation timeline (recorded with time.monotonic()
# timestamps).  The canonical order is ADMITTED → PLACED → RESTORING →
# WS_READY → RUNNING → DONE; for a restore OWNER, RUNNING (layer-gated
# generation start) legitimately overlaps the restore and may precede
# WS_READY — execution resuming while memory streams is the paper's whole
# point, and the timeline reports what actually happened.
EVT_ADMITTED = "ADMITTED"     # passed the node's admission controller
EVT_PLACED = "PLACED"         # entered a node's run queue (handle.node set)
EVT_RESTORING = "RESTORING"   # owns (or rides) an in-flight restore
EVT_WS_READY = "WS_READY"     # traced working set resident (cancel no-ops after)
EVT_RUNNING = "RUNNING"       # generation started
EVT_DONE = "DONE"             # result delivered
EVT_CANCELLED = "CANCELLED"   # terminal: cancelled (queued or mid-restore)
EVT_REJECTED = "REJECTED"     # terminal: typed rejection (overload/deadline)
EVT_FAILED = "FAILED"         # terminal: real failure


class InvocationError(RuntimeError):
    """Base of every typed invocation outcome that is not a result."""


class Overloaded(InvocationError):
    """Admission refused: a bounded queue or concurrency cap is full (or
    the node/router is shutting down).  Back off and retry elsewhere."""


class DeadlineExceeded(InvocationError):
    """The invocation's absolute deadline passed before it could run."""


class InvocationCancelled(InvocationError):
    """The invocation was cancelled (while queued, or mid-restore)."""


def deadline_in(seconds: float) -> float:
    """Absolute deadline ``seconds`` from now, in the ``time.monotonic()``
    domain :class:`Invocation.deadline_s` uses."""
    return time.monotonic() + float(seconds)


class QosClass(enum.Enum):
    """Service class of one invocation — the single knob every layer reads.

    * ``LATENCY`` — interactive traffic: dispatched first at the node,
      prefetch stream opened above everyone else at the I/O arbiter, and
      the router may steal/scale out a node for it.
    * ``STANDARD`` — the default; exactly the pre-v2 behavior.
    * ``BATCH`` — background work: dispatched last, streams below demand
      traffic (but above residual tails), never triggers scale-out.
    """

    LATENCY = "latency"
    STANDARD = "standard"
    BATCH = "batch"

    @property
    def dispatch_rank(self) -> int:
        """Node run-queue order: lower runs first."""
        return {QosClass.LATENCY: 0, QosClass.STANDARD: 1, QosClass.BATCH: 2}[self]

    @property
    def io_priority(self) -> int:
        """Prefetch-stream priority at the I/O arbiter.  BATCH demand (-1)
        still sits above residual background tails (-2, see
        ``repro_torch.core.restore.BACKGROUND_PRIORITY``)."""
        return {QosClass.LATENCY: 2, QosClass.STANDARD: 0, QosClass.BATCH: -1}[self]


@dataclasses.dataclass
class Invocation:
    """One typed request.  ``deadline_s`` is an *absolute*
    ``time.monotonic()`` value (build one with :func:`deadline_in`);
    ``priority`` breaks ties within a QoS class (higher first)."""

    function: str
    prompt: Any = None
    max_new_tokens: int = 8
    mode: str = "spice"
    cfg: Any = None
    simulate_read_bw: Optional[float] = None
    qos: QosClass = QosClass.STANDARD
    deadline_s: Optional[float] = None
    priority: int = 0
    # speculative pre-warm (PrewarmEngine): restore + promote but skip
    # generation; a no-op when the function is already warm/restoring.
    # Never fed back into the arrival tracker.
    prewarm: bool = False
    # warm-state handoff (repro_torch.serve.handoff): restore this JIF — a delta
    # of live warm state against the function's own base — instead of the
    # registered image.  Per-invocation: the registry is never touched, so
    # any later restore of the function reads the published image.
    jif_override: Optional[str] = None
    # colocated compute lane (repro_torch.serve.deploy.ColocatedTrainer): run
    # this thunk on a worker instead of restore+generate.  The function
    # name is a label (never resolved through the registry); admission
    # caps, QoS run-queue order, deadlines and queued-cancel all apply —
    # which is the point: BATCH-class training competes for the node
    # under the same contract as BATCH invocations.
    payload: Optional[Callable[[], Any]] = None

    def remaining_s(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (time.monotonic() if now is None else now)


class InvocationHandle:
    """The caller's grip on one in-flight invocation (replaces the raw
    ``concurrent.futures.Future``; duck-types the parts the old surface
    used: ``result()`` / ``done()`` / ``exception()`` / ``cancelled()``).

    ``cancel()`` is best-effort and phase-aware:

    * queued            — always succeeds; the invocation never runs;
    * mid-restore       — succeeds iff this invocation *owns* the restore
      and no concurrent invocation joined it (aborting a shared stream
      would fail innocent riders); the stream is aborted and every ledger
      reservation is returned through the restore's failure paths;
    * after WS_READY    — no-op (returns False); the result is delivered.

    ``cancel() -> True`` means the cancel was *accepted*; the authoritative
    outcome is ``result()`` (a cancel racing the final tensor may lose).
    """

    def __init__(self, invocation: Invocation, node: str = ""):
        self.invocation = invocation
        self.node = node
        self._lock = threading.Lock()
        self._events: List[Tuple[str, float]] = []
        self._done_ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        # phase: queued -> running -> (restoring | pinned) -> done
        self._phase = "queued"
        self._cancel_requested = False
        self._was_cancelled = False
        self._canceller: Optional[Callable[[], bool]] = None
        self._retired = False  # scheduler-side: admission counters returned

    # -------------------------------------------------------------- events
    def record(self, event: str, ts: Optional[float] = None) -> None:
        with self._lock:
            self._events.append((event, time.monotonic() if ts is None else ts))

    def events(self) -> List[Tuple[str, float]]:
        """The timeline so far: ``[(event, monotonic_ts), ...]``."""
        with self._lock:
            return list(self._events)

    def event_ts(self, event: str) -> Optional[float]:
        with self._lock:
            for name, ts in self._events:
                if name == event:
                    return ts
        return None

    def queue_wait_s(self) -> float:
        """ADMITTED → first of {RESTORING, WS_READY, RUNNING} (or the
        terminal event): how long the request sat in queues before any
        work happened on its behalf."""
        admitted = self.event_ts(EVT_ADMITTED)
        if admitted is None:
            return 0.0
        for evt in (EVT_RESTORING, EVT_WS_READY, EVT_RUNNING,
                    EVT_CANCELLED, EVT_REJECTED, EVT_FAILED, EVT_DONE):
            ts = self.event_ts(evt)
            if ts is not None:
                return max(0.0, ts - admitted)
        return 0.0

    # ------------------------------------------------------------- outcome
    def result(self, timeout: Optional[float] = None):
        """Block for the :class:`~repro_torch.serve.node.InvokeResult`; raises
        the typed outcome (:class:`InvocationCancelled`,
        :class:`DeadlineExceeded`, :class:`Overloaded`) or the failure."""
        if not self._done_ev.wait(timeout):
            raise TimeoutError(
                f"invocation of {self.invocation.function!r} still in flight"
            )
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._done_ev.wait(timeout):
            raise TimeoutError(
                f"invocation of {self.invocation.function!r} still in flight"
            )
        return self._exc

    def done(self) -> bool:
        return self._done_ev.is_set()

    def cancelled(self) -> bool:
        return self._was_cancelled

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_requested

    # -------------------------------------------------------------- cancel
    def cancel(self) -> bool:
        with self._lock:
            if self._phase == "done":
                return self._was_cancelled
            if self._cancel_requested:
                return True
            if self._phase in ("queued", "running"):
                # queued: the dispatcher observes the flag at claim time and
                # never runs the invocation.  running (restore being set
                # up, role not yet determined): the flag is honored the
                # moment the owner arms its canceller — accepted now, so
                # the set-up window is not a cancellation dead zone.
                self._cancel_requested = True
                return True
            if self._phase == "restoring" and self._canceller is not None:
                canceller = self._canceller
                # set the flag BEFORE aborting: the abort releases the
                # owner's tensor waiters synchronously, and the owner must
                # never misread its own cancellation as collateral from
                # someone else's (which would trigger a retry restore)
                self._cancel_requested = True
            else:  # pinned (working set resident / warm hit): too late
                return False
        ok = canceller()  # aborts the stream; runs OUTSIDE the handle lock
        if ok:
            return True
        with self._lock:
            if self._phase != "done":
                self._cancel_requested = False  # abort did not take: revert
        return False

    # ----------------------------------------- dispatcher-side transitions
    def _claim_for_run(self) -> bool:
        """Queued → running (dispatcher thread).  False when a queued
        cancel already decided this invocation's fate."""
        with self._lock:
            if self._cancel_requested:
                return False
            self._phase = "running"
            return True

    def _attach_canceller(self, fn: Callable[[], bool]) -> None:
        """Arm mid-restore cancellation (restore owner only).  A no-op when
        the handle already pinned (working set landed before the owner got
        here — the synchronous restore path).  A cancel accepted during
        set-up fires the canceller immediately; its outcome surfaces
        through the restore failure path."""
        with self._lock:
            if self._phase != "running":
                return
            self._canceller = fn
            self._phase = "restoring"
            pending = self._cancel_requested
        if pending:
            fn()

    def _pin(self) -> None:
        """Point of no return (working set resident / warm hit): cancel()
        is a no-op from here on; the result will be delivered."""
        with self._lock:
            if self._phase != "done":
                self._phase = "pinned"
                self._canceller = None

    def _reset_for_retry(self) -> None:
        """Re-open the phase machine before a dispatcher retry (a rider
        failed by someone else's cancel restores afresh): without this the
        stale pinned/restoring phase would block the retry's canceller and
        make the retry un-cancellable."""
        with self._lock:
            if self._phase != "done":
                self._phase = "running"
                self._canceller = None

    def _finish(self, event: str, result=None, exc: Optional[BaseException] = None,
                cancelled: bool = False) -> None:
        with self._lock:
            if self._phase == "done":
                return
            self._phase = "done"
            self._canceller = None
            self._result = result
            self._exc = exc
            self._was_cancelled = cancelled
            if not cancelled:
                self._cancel_requested = False  # a raced cancel lost: outcome wins
            self._events.append((event, time.monotonic()))
        self._done_ev.set()

    def _finish_ok(self, result) -> None:
        self._finish(EVT_DONE, result=result)

    def _finish_cancelled(self, exc: InvocationCancelled) -> None:
        self._finish(EVT_CANCELLED, exc=exc, cancelled=True)

    def _finish_rejected(self, exc: InvocationError) -> None:
        self._finish(EVT_REJECTED, exc=exc)

    def _finish_failed(self, exc: BaseException) -> None:
        self._finish(EVT_FAILED, exc=exc)


class AdmissionController:
    """Typed backpressure at the node: bounded queues + per-function
    concurrency caps, refusing with :class:`Overloaded` instead of letting
    the run queue grow without bound.

    * ``max_queue_depth``     — cap on invocations *queued* (not yet
      running) on the node; ``None`` = unbounded (the pre-v2 behavior).
    * ``max_batch_queued``    — tighter bound on queued BATCH work, so a
      batch burst fills its own lane instead of the whole queue.
    * ``max_batch_inflight``  — cap on BATCH work admitted at all (queued +
      running).  A restore-blocked BATCH invocation holds a worker thread;
      without this cap a batch wave can occupy every worker and starve
      LATENCY dispatch no matter how the queue is ordered.
    * ``function_caps`` / ``default_function_cap`` — cap on one function's
      admitted (queued + running) invocations; joiners and warm hits count
      too, because each holds a worker thread.
    """

    def __init__(
        self,
        max_queue_depth: Optional[int] = None,
        max_batch_queued: Optional[int] = None,
        max_batch_inflight: Optional[int] = None,
        function_caps: Optional[Dict[str, int]] = None,
        default_function_cap: Optional[int] = None,
    ):
        self.max_queue_depth = max_queue_depth
        self.max_batch_queued = max_batch_queued
        self.max_batch_inflight = max_batch_inflight
        self.function_caps = dict(function_caps or {})
        self.default_function_cap = default_function_cap

    def cap_for(self, fname: str) -> Optional[int]:
        return self.function_caps.get(fname, self.default_function_cap)

    def admit(self, inv: Invocation, queued: int, fn_active: int,
              batch_queued: int, batch_active: int = 0) -> None:
        """Raise :class:`Overloaded` when ``inv`` must be refused; called
        under the scheduler's stats lock with its current counters."""
        if self.max_queue_depth is not None and queued >= self.max_queue_depth:
            raise Overloaded(
                f"{inv.function}: node queue full "
                f"({queued}/{self.max_queue_depth} queued)"
            )
        if inv.qos is QosClass.BATCH:
            if (
                self.max_batch_queued is not None
                and batch_queued >= self.max_batch_queued
            ):
                raise Overloaded(
                    f"{inv.function}: batch lane full "
                    f"({batch_queued}/{self.max_batch_queued} queued)"
                )
            if (
                self.max_batch_inflight is not None
                and batch_active >= self.max_batch_inflight
            ):
                raise Overloaded(
                    f"{inv.function}: batch in-flight cap reached "
                    f"({batch_active}/{self.max_batch_inflight} admitted)"
                )
        cap = self.cap_for(inv.function)
        if cap is not None and fn_active >= cap:
            raise Overloaded(
                f"{inv.function}: per-function concurrency cap reached "
                f"({fn_active}/{cap} in flight)"
            )
