"""The port's twin of ``tests/test_iosched.py``, case for case, against
``repro_torch.core`` (an identical copy of the reference's module but for
its imports).  Prefetch I/O scheduler: stream completion, round-robin fairness across
concurrent streams, and demand-boost reordering ahead of background
prefetch."""
import threading
import time

import pytest

from repro_torch.core import PrefetchIOScheduler


def _op(nbytes=1000, sleep=0.0):
    def op():
        if sleep:
            time.sleep(sleep)
        return nbytes
    return op


def test_stream_runs_in_order_and_completes():
    sched = PrefetchIOScheduler("t")
    done = []
    completed = []
    stream = sched.open_stream("s", on_complete=lambda: completed.append(True))
    for i in range(5):
        stream.submit(f"t{i}", [_op(), _op()], (lambda n=i: done.append(n)))
    stream.seal()
    assert stream.wait(5)
    assert done == list(range(5))  # FIFO without boosts
    assert completed == [True]
    s = sched.snapshot_stats()
    assert s["io_ops"] == 10 and s["bytes_read"] == 10_000 and s["tensors"] == 5
    assert s["streams_completed"] == 1


def test_demand_boost_reorders_ahead_of_background_prefetch():
    sched = PrefetchIOScheduler("t")
    gate = threading.Event()
    done = []
    stream = sched.open_stream("s")

    def gated():
        gate.wait(5)
        return 10
    stream.submit("t0", [gated], lambda: done.append("t0"))
    for i in range(1, 6):
        stream.submit(f"t{i}", [_op()], (lambda n=f"t{i}": done.append(n)))
    stream.seal()
    # while t0's read is in flight, execution demands t4
    assert stream.boost("t4")
    gate.set()
    assert stream.wait(5)
    assert done.index("t4") < done.index("t1")  # overtook background order
    assert sched.snapshot_stats()["demand_boosts"] == 1
    # boosting an already-finalized tensor is a no-op
    assert not stream.boost("t1")


def test_round_robin_shares_bandwidth_across_streams():
    sched = PrefetchIOScheduler("t")
    gate = threading.Event()
    order = []
    streams = []
    for s in ("a", "b"):
        stream = sched.open_stream(s)
        stream.submit(f"{s}-gate", [lambda: (gate.wait(5), 0)[1]],
                      (lambda n=f"{s}0": order.append(n)))
        for i in range(1, 4):
            stream.submit(f"{s}-t{i}", [_op()],
                          (lambda n=f"{s}{i}": order.append(n)))
        stream.seal()
        streams.append(stream)
    gate.set()
    for stream in streams:
        assert stream.wait(5)
    # neither stream ran to completion before the other started: the first
    # tensors of both finish before the last tensor of either
    a_first, b_first = order.index("a0"), order.index("b0")
    a_last, b_last = order.index("a3"), order.index("b3")
    assert a_first < b_last and b_first < a_last
    assert sched.snapshot_stats()["streams_completed"] == 2


def test_priority_preempts_round_robin():
    sched = PrefetchIOScheduler("t")
    gate = threading.Event()
    order = []
    lo = sched.open_stream("lo", priority=0)
    hi = sched.open_stream("hi", priority=1)
    lo.submit("l-gate", [lambda: (gate.wait(5), 0)[1]], lambda: order.append("l0"))
    for i in range(1, 4):
        lo.submit(f"l{i}", [_op()], (lambda n=f"l{i}": order.append(n)))
    for i in range(3):
        hi.submit(f"h{i}", [_op()], (lambda n=f"h{i}": order.append(n)))
    lo.seal()
    hi.seal()
    gate.set()
    assert hi.wait(5) and lo.wait(5)
    # all high-priority tensors complete before the low stream's tail
    assert max(order.index(f"h{i}") for i in range(3)) < order.index("l3")


def test_failing_op_fails_only_its_stream():
    """One tenant's I/O error must not kill the shared reader thread."""
    sched = PrefetchIOScheduler("t")
    bad = sched.open_stream("bad")
    good = sched.open_stream("good")

    def boom():
        raise IOError("disk gone")

    bad.submit("t0", [boom], lambda: None)
    bad.seal()
    done = []
    good.submit("t0", [_op()], lambda: done.append(1))
    good.seal()
    assert bad.wait(5) and good.wait(5)
    assert isinstance(bad.error, IOError)
    assert done == [1]  # the other stream completed
    # and the scheduler still serves streams opened afterwards
    later = sched.open_stream("later")
    later.submit("x", [_op()], lambda: done.append(2))
    later.seal()
    assert later.wait(5) and done[-1] == 2


def test_boost_entry_expires_with_its_job():
    """A boost stops privileging its stream once the demanded tensor's
    I/O is done — it must not monopolize the reader for the whole queue."""
    sched = PrefetchIOScheduler("t")
    gate = threading.Event()
    order = []
    a = sched.open_stream("a")
    b = sched.open_stream("b")
    a.submit("a-gate", [lambda: (gate.wait(5), 0)[1]], lambda: order.append("a0"))
    for i in range(1, 4):
        a.submit(f"a{i}", [_op()], (lambda n=f"a{i}": order.append(n)))
    for i in range(3):
        b.submit(f"b{i}", [_op()], (lambda n=f"b{i}": order.append(n)))
    a.seal()
    b.seal()
    a.boost("a1")  # demand ONE tensor of stream a
    gate.set()
    assert a.wait(5) and b.wait(5)
    # a1 was served first after the in-flight op, but a's remaining
    # background tensors did not starve b's queue: b got service before
    # a's tail finished
    assert order.index("a1") < order.index("b1")
    assert order.index("b0") < order.index("a3")


def test_inline_stream_drains_on_caller_thread():
    sched = PrefetchIOScheduler("t")
    done = []
    stream = sched.open_stream("sync", inline=True)
    for i in range(3):
        stream.submit(f"t{i}", [_op(500)], (lambda n=i: done.append(n)))
    stream.seal()
    sched.drain_inline(stream)
    assert stream.done and done == [0, 1, 2]
    assert sched.snapshot_stats()["bytes_read"] == 1500
