"""Shared prefetch I/O scheduler — one arbiter for every restore on a node.

The seed restorer gave each `SpiceRestorer` a private prefetch thread, so N
concurrent cold starts issued N independent sequential streams and the disk
arbitrated them blindly (the piecemeal/contention regime of §4.2).  Here all
restorers submit their chunk-read work to one node-wide scheduler:

* **per-function streams** — each restore opens an `IOStream` holding an
  ordered queue of per-tensor jobs (the JIF access order).  A single reader
  thread serves streams round-robin (weighted by priority), so concurrent
  restores share read bandwidth fairly instead of FIFO-starving each other.
* **demand boost** — `TensorHandle.wait` on a tensor that is not yet
  resident promotes that tensor's pending reads to the head of its stream
  AND promotes the stream over background prefetch.  This is the paper's
  tracked-completion contract under contention: execution-demanded data is
  never stuck behind another function's advisory stream.
* **bandwidth arbitration** — one reader thread serializes storage access
  (the single-disk model); aggregate `stats` expose total bytes/ops so
  benchmarks can report achieved read bandwidth across all tenants.

Jobs are plain callables returning the number of bytes they read from
storage; the scheduler stays agnostic of JIF layout.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple


class _TensorJob:
    """All I/O for one tensor: ordered ops, then a finalize callback."""

    __slots__ = ("name", "ops", "finalize")

    def __init__(self, name: str, ops, finalize: Optional[Callable[[], None]]):
        self.name = name
        self.ops: Deque[Callable[[], int]] = deque(ops)
        self.finalize = finalize


class IOStream:
    """One restore's ordered I/O queue inside the shared scheduler."""

    def __init__(
        self,
        sched: "PrefetchIOScheduler",
        name: str,
        priority: int = 0,
        on_complete: Optional[Callable[[], None]] = None,
        region=None,
    ):
        self.sched = sched
        self.name = name
        self.priority = priority
        # optional ledger region (repro_torch.core.memory.MemoryRegion): storage
        # bytes this stream reads are recorded as in-flight fill against
        # it, so the node's memory ledger sees prefetch progress live.  The
        # restorer swaps it for the residual region at the ws boundary.
        self.region = region
        self._jobs: Deque[_TensorJob] = deque()
        self._by_name: Dict[str, _TensorJob] = {}
        self._sealed = False
        self._active = 0  # ops/finalizes running outside the lock right now
        self._completed = False
        self._on_complete = on_complete
        self._done = threading.Event()
        self.error: Optional[BaseException] = None
        self.stats = {"bytes_read": 0, "io_ops": 0, "tensors": 0, "boosts": 0}

    # Called by the submitting (restorer) thread.
    def submit(self, tensor_name: str, ops, finalize=None) -> None:
        with self.sched._cv:
            if self.error is not None:
                return  # stream already failed: drop silently, done is set
            if self._sealed:
                raise RuntimeError(f"stream {self.name!r} already sealed")
            job = _TensorJob(tensor_name, ops, finalize)
            self._jobs.append(job)
            self._by_name[tensor_name] = job
            self.sched._cv.notify_all()

    def seal(self) -> None:
        """No more submissions; the stream completes when the queue drains.
        A stream sealed with an empty queue (every tensor was served from
        pinned memory) completes immediately."""
        with self.sched._cv:
            self._sealed = True
            self.sched._cv.notify_all()
        self.sched._maybe_complete(self)

    def boost(self, tensor_name: str) -> bool:
        """Demand-promote one tensor's pending I/O (see module docstring)."""
        return self.sched._boost(self, tensor_name)

    def set_priority(self, priority: int) -> None:
        """Re-prioritize a live stream (e.g. demote the residual tail of a
        restore to background once its working set has landed); pending
        demand boosts are unaffected — they are checked before priority."""
        with self.sched._cv:
            self.priority = priority
            self.sched._cv.notify_all()

    def abort(self, exc: BaseException) -> None:
        """Fail the stream: drop pending work, release waiters, complete."""
        self.sched._fail_stream(self, exc)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    # internal, under scheduler lock
    def _has_work(self) -> bool:
        return bool(self._jobs)


class PrefetchIOScheduler:
    """Node-wide prefetch arbiter: per-stream queues, one reader thread."""

    def __init__(self, name: str = "iosched"):
        self.name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._streams: List[IOStream] = []
        # (stream, job) pairs: a boost entry expires as soon as its demanded
        # job's I/O completes, so one boost cannot monopolize the reader
        # against other tenants' later demands
        self._boosted: Deque[Tuple[IOStream, _TensorJob]] = deque()
        self._rr = 0
        self._running = False
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None
        self.stats = {
            "bytes_read": 0,
            "io_ops": 0,
            "tensors": 0,
            "streams_opened": 0,
            "streams_completed": 0,
            "demand_boosts": 0,
            "busy_s": 0.0,
        }

    # ------------------------------------------------------------- streams
    def open_stream(
        self,
        name: str,
        priority: int = 0,
        on_complete: Optional[Callable[[], None]] = None,
        inline: bool = False,
        region=None,
    ) -> IOStream:
        """``inline`` streams are never served by the reader thread — the
        caller drains them synchronously via :meth:`drain_inline`.
        ``region`` (optional ledger region) receives in-flight I/O
        accounting for every storage byte this stream reads."""
        stream = IOStream(self, name, priority=priority, on_complete=on_complete,
                          region=region)
        with self._cv:
            if self._shutdown:
                raise RuntimeError("scheduler is shut down")
            self.stats["streams_opened"] += 1
            if not inline:
                self._streams.append(stream)
                if not self._running:
                    self._running = True
                    self._thread = threading.Thread(
                        target=self._loop, name=f"{self.name}-reader", daemon=True
                    )
                    self._thread.start()
            self._cv.notify_all()
        return stream

    def drain_inline(self, stream: IOStream) -> None:
        """Execute a stream synchronously on the caller's thread (the
        non-pipelined restore path); the stream must be sealed."""
        while True:
            with self._cv:
                if not stream._jobs:
                    break
                job = stream._jobs[0]
                op = job.ops.popleft() if job.ops else None
                if op is None:
                    stream._jobs.popleft()
                    stream._by_name.pop(job.name, None)
            try:
                if op is not None:
                    self._run_op(stream, op)
                elif job.finalize is not None:
                    job.finalize()
                    with self._cv:
                        stream.stats["tensors"] += 1
                        self.stats["tensors"] += 1
            except BaseException as exc:  # noqa: BLE001
                self._fail_stream(stream, exc)
                raise
        self._maybe_complete(stream)

    # -------------------------------------------------------------- boost
    def _boost(self, stream: IOStream, tensor_name: str) -> bool:
        with self._cv:
            job = stream._by_name.get(tensor_name)
            if job is None or not stream._jobs:
                return False  # already finalized (or never submitted): no-op
            if stream._jobs[0] is not job:
                try:
                    stream._jobs.remove(job)
                except ValueError:
                    return False
                stream._jobs.appendleft(job)
            # promote the stream over background prefetch — but only until
            # THIS job's I/O is done (the entry expires with the job)
            if not any(j is job for _, j in self._boosted):
                self._boosted.append((stream, job))
            stream.stats["boosts"] += 1
            self.stats["demand_boosts"] += 1
            self._cv.notify_all()
            return True

    # --------------------------------------------------------------- loop
    def _pick_stream(self) -> Optional[IOStream]:
        """Under lock: demand-boosted first — QoS-weighted: among live
        boost entries the highest-priority STREAM wins (a LATENCY restore's
        demand overtakes a BATCH restore's earlier demand), FIFO within a
        tier — else stream priority + RR."""
        best = None
        for entry in list(self._boosted):
            s, job = entry
            # entry expires once the demanded job left the queue (I/O done)
            if s._by_name.get(job.name) is not job or not s._has_work():
                self._boosted.remove(entry)
                continue
            if best is None or s.priority > best.priority:
                best = s
        if best is not None:
            return best
        ready = [s for s in self._streams if s._has_work()]
        if not ready:
            return None
        top = max(s.priority for s in ready)
        ready = [s for s in ready if s.priority == top]
        self._rr = (self._rr + 1) % len(ready)
        return ready[self._rr]

    def _run_op(self, stream: IOStream, op: Callable[[], int]) -> None:
        t0 = time.perf_counter()
        nbytes = int(op() or 0)
        dt = time.perf_counter() - t0
        region = stream.region
        if region is not None and nbytes:
            region.note_io(nbytes)
        with self._cv:
            stream.stats["io_ops"] += 1
            stream.stats["bytes_read"] += nbytes
            self.stats["io_ops"] += 1
            self.stats["bytes_read"] += nbytes
            self.stats["busy_s"] += dt

    def _maybe_complete(self, stream: IOStream) -> None:
        with self._cv:
            # _active guards the window where the reader popped the last
            # job but its op/finalize is still executing outside the lock:
            # completing then would commit regions and close the JifReader
            # under a finalize that is still installing the tensor
            if (
                stream._completed or not stream._sealed
                or stream._jobs or stream._active
            ):
                return
            stream._completed = True
            if stream in self._streams:
                self._streams.remove(stream)
            self.stats["streams_completed"] += 1
        if stream._on_complete is not None:
            stream._on_complete()
        stream._done.set()

    def _fail_stream(self, stream: IOStream, exc: BaseException) -> None:
        """Fail one stream without killing the shared reader: drop its
        pending work, record the error, and run completion so waiters are
        released (the stream owner propagates ``stream.error`` to its
        tensor handles / caller)."""
        with self._cv:
            if stream._completed:
                return
            stream.error = exc
            stream._jobs.clear()
            stream._by_name.clear()
            stream._sealed = True
        self._maybe_complete(stream)

    def _loop(self) -> None:
        while True:
            finalize = None
            op = None
            with self._cv:
                stream = self._pick_stream()
                while stream is None:
                    if self._shutdown or not self._streams:
                        self._running = False
                        return
                    self._cv.wait(timeout=0.25)
                    stream = self._pick_stream()
                job = stream._jobs[0]
                op = job.ops.popleft() if job.ops else None
                if op is None:
                    stream._jobs.popleft()
                    stream._by_name.pop(job.name, None)
                    finalize = job.finalize
                stream._active += 1  # completion must wait for this work
            # a failing op/finalize fails ITS stream only; the shared
            # reader must survive to serve every other tenant
            error = None
            try:
                if op is not None:
                    self._run_op(stream, op)
                elif finalize is not None:
                    finalize()
            except BaseException as exc:  # noqa: BLE001
                error = exc
            finally:
                with self._cv:
                    stream._active -= 1
            if error is not None:
                self._fail_stream(stream, error)
                continue
            if op is not None:
                # a concurrent abort may have emptied the stream while this
                # op ran; its _fail_stream deferred completion to us
                self._maybe_complete(stream)
                continue
            with self._cv:
                stream.stats["tensors"] += 1
                self.stats["tensors"] += 1
            self._maybe_complete(stream)

    # ------------------------------------------------------------- probes
    def inflight(self) -> Dict[str, int]:
        """Live load probe for placement: the number of registered
        (uncompleted) streams and an estimate of the bytes still to land
        across them (``region.nbytes - region.filled`` for streams that
        carry a ledger region; region-less streams count bytes as 0).
        Inline streams never register here, so this is exactly the work
        queued against the reader thread."""
        with self._cv:
            streams = [s for s in self._streams if not s._completed]
            pending = 0
            for s in streams:
                region = s.region
                if region is not None:
                    pending += max(0, region.nbytes - region.filled)
        return {"streams": len(streams), "pending_bytes": pending}

    # ----------------------------------------------------------- lifecycle
    def shutdown(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
            th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout)

    def snapshot_stats(self) -> Dict[str, float]:
        with self._cv:
            return dict(self.stats)
