"""Spans of the port: one recorder for what each thread of a request did.

A cold start runs on three kinds of thread: the node worker that serves
the invocation, the prefetch scheduler's reader threads and the node's
uploader thread.  Each layer boundary on that path records a span (name,
start, end, its id, its parent's id, the request's id, the thread, a few
integer attributes), so one request reads as a tree: ``invoke`` →
``invoke.queue``, ``restore`` (→ ``restore.metadata``, ``restore.read``,
``install.job`` → ``install.copy`` / ``install.patch`` / ``install.sync``),
``gen.prefill`` (→ ``gen.layer_wait``, ``gen.moe`` → ``moe.experts``),
``gen.decode_step`` (→ ``gen.moe``), ``invoke.complete_wait``.  With the
recorder on, the invocation handle's timeline events are recorded as
instant events of their request.

* Off by default: a span site then costs one test of :data:`ON` and
  allocates nothing.  :func:`enable`, :func:`disable`, :func:`drain`.
* Spans go into per-thread lists, with no lock on the record path; nothing
  is written during a run.  :func:`write_chrome_trace` writes what was
  drained as trace-event JSON (Perfetto, ``chrome://tracing``).
* Stamps are ``time.perf_counter_ns()``: on Linux the ``CLOCK_MONOTONIC``
  of ``time.monotonic()``, which the invocation timeline uses, so spans and
  timeline events share one clock.  :func:`clock_pair` reads it beside the
  wall clock, which is the profiler's, to map one onto the other.
* A request's id and its root span ride on the objects the threads share:
  the invocation handle carries them to the worker (:func:`bind`), the
  restore's ``RestoreStats`` to its reads and upload jobs.

:func:`on_step_logits` is the documented hook for the logits of each
generation step (per thread, off by default).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

ON = False  # the recorder's switch, tested at every span site
HOOKS = 0  # threads with a step-logits hook set

now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start: int  # perf_counter_ns
    end: int
    id: int
    parent: int  # 0: a root
    req: int  # 0: no request
    thread: str
    attrs: Dict[str, int]
    ph: str = "X"  # "X" an interval, "i" an instant event (start == end)


class Open(NamedTuple):
    """A span begun and not yet ended (:func:`begin`)."""

    name: str
    start: int
    id: int
    parent: int
    req: int
    thread: str
    attrs: Dict[str, int]


_ids = itertools.count(1)
_reqs = itertools.count(1)
_reg = threading.Lock()  # guards _buffers (thread registration, drain)
_buffers: List[Tuple[threading.Thread, List[Span]]] = []


class _Local(threading.local):
    def __init__(self):
        th = threading.current_thread()
        self.spans: List[Span] = []
        self.stack: List[int] = []  # ids of the open span() blocks
        self.req = 0  # the request this thread serves
        self.root = 0  # parent of a span opened outside any span() block
        self.cause = 0  # a span every span recorded here names as its cause
        self.logits: Optional[Callable] = None
        self.thread = th.name
        with _reg:
            _buffers.append((th, self.spans))


_tls = _Local()


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def drain() -> List[Span]:
    """Every span recorded so far, by start; the buffers are emptied."""
    out: List[Span] = []
    with _reg:
        keep = []
        for th, buf in _buffers:
            n = len(buf)
            out.extend(buf[:n])
            del buf[:n]  # a span appended meanwhile stays for the next drain
            if th.is_alive() or buf:
                keep.append((th, buf))
        _buffers[:] = keep
    out.sort(key=lambda s: s.start)
    return out


def clock_pair() -> Tuple[int, int]:
    """(``perf_counter_ns``, ``time_ns``) read back to back: the offset
    between the spans' clock and the wall clock."""
    return time.perf_counter_ns(), time.time_ns()


def request_id() -> int:
    return next(_reqs)


def bind(req: int = 0, root: int = 0, cause: int = 0) -> Tuple[int, int, int]:
    """Make the calling thread record for request ``req`` under span
    ``root`` (and name ``cause`` on each span); returns the previous
    binding, for :func:`unbind`."""
    t = _tls
    prev = (t.req, t.root, t.cause)
    t.req, t.root, t.cause = req, root, cause
    return prev


def unbind(prev: Tuple[int, int, int]) -> None:
    t = _tls
    t.req, t.root, t.cause = prev


def begin(name: str, start: Optional[int] = None, parent: Optional[int] = None,
          req: Optional[int] = None, **attrs: int) -> Open:
    """Open a span that may end on another thread (:func:`end`).  The
    parent and request default to the calling thread's."""
    t = _tls
    if parent is None:
        parent = t.stack[-1] if t.stack else t.root
    if t.cause:
        attrs.setdefault("cause", t.cause)
    return Open(name, now() if start is None else start, next(_ids), parent,
                t.req if req is None else req, t.thread, attrs)


def end(op: Open, stop: Optional[int] = None) -> Span:
    """Record ``op`` as ending at ``stop`` (default: now), on the calling
    thread's list."""
    s = Span(op.name, op.start, now() if stop is None else stop, op.id, op.parent,
             op.req, op.thread, op.attrs)
    _tls.spans.append(s)
    return s


def add(name: str, start: int, stop: int, parent: Optional[int] = None,
        req: Optional[int] = None, **attrs: int) -> int:
    """Record a finished span from two stamps; returns its id."""
    t = _tls
    if parent is None:
        parent = t.stack[-1] if t.stack else t.root
    if t.cause:
        attrs.setdefault("cause", t.cause)
    sid = next(_ids)
    t.spans.append(Span(name, start, stop, sid, parent, t.req if req is None else req,
                        t.thread, attrs))
    return sid


def instant(name: str, ts: int, req: int = 0, parent: int = 0) -> None:
    t = _tls
    t.spans.append(Span(name, ts, ts, next(_ids), parent, req, t.thread, {}, "i"))


class _Block:
    __slots__ = ("op", "stop")

    def __init__(self, op: Open):
        self.op = op
        self.stop: Optional[int] = None  # the end stamp, where not the block's exit

    def __enter__(self) -> Open:
        _tls.stack.append(self.op.id)
        return self.op

    def __exit__(self, *exc) -> bool:
        _tls.stack.pop()
        end(self.op, self.stop)
        return False


class _Null:
    __slots__ = ()
    stop = property(lambda self: None, lambda self, stop: None)  # set and forgotten

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


def span(name: str, **attrs: int):
    """``with span(name):`` records the block; spans recorded inside it on
    this thread are its children.  ``start`` may be given as a stamp, and
    the returned block's ``stop`` set to end the span at a stamp of its
    own (with the recorder off, setting it does nothing)."""
    if not ON:
        return _NULL
    return _Block(begin(name, **attrs))


def on_step_logits(callback: Optional[Callable]) -> None:
    """Call ``callback(logits)`` on this thread with the last position's
    logits (B, V) each time generation's head computes them, prefill and
    every decode step; None removes it."""
    global HOOKS
    t = _tls
    with _reg:
        HOOKS += (callback is not None) - (t.logits is not None)
    t.logits = callback


def step_logits(logits) -> None:
    cb = _tls.logits
    if cb is not None:
        cb(logits)


def write_chrome_trace(path: str, spans: Optional[List[Span]] = None) -> int:
    """Write ``spans`` (default: :func:`drain`) as trace-event JSON, one
    track a thread; returns the number of spans written."""
    spans = drain() if spans is None else spans
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        ev = {"name": s.name, "ph": s.ph, "ts": s.start / 1e3, "pid": pid, "tid": tid,
              "args": {"id": s.id, "parent": s.parent, "req": s.req, **s.attrs}}
        if s.ph == "X":
            ev["dur"] = (s.end - s.start) / 1e3
        else:
            ev["s"] = "t"
        events.append(ev)
    events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name}} for name, tid in tids.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(spans)
