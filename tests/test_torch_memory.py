"""The port's twin of ``tests/test_memory.py``, case for case, against
``repro_torch.core`` (an identical copy of the reference's module but for
its imports); the concurrent-restore case publishes the JAX initializer's
weights through the port's node on the CPU.  Unified node memory subsystem: ledger invariant, region primitives,
reclaim ladder, pool capacity accounting, and budget-bounded concurrent
restores (the paper's "memory budget is an invariant" property).

The interleaving tests are deterministic (seeded RandomState) like
test_core.py; a hypothesis-powered variant is not needed — the seeds cover
the same op-sequence space reproducibly."""
import gc
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (
    BufferPool,
    KIND_IMAGE_CACHE,
    KIND_POOL,
    KIND_RESIDUAL,
    KIND_SCRATCH,
    KIND_WORKING_SET,
    MEMORY_KINDS,
    MemoryPressureError,
    NodeMemoryManager,
)


# ------------------------------------------------------------ region basics
def test_reserve_commit_release_accounting():
    mm = NodeMemoryManager(1000)
    a = mm.reserve(400, KIND_WORKING_SET, owner="a")
    b = mm.reserve(300, KIND_RESIDUAL, owner="b")
    assert mm.held_bytes() == 700
    assert mm.kind_bytes()[KIND_WORKING_SET] == 400
    assert mm.kind_bytes()[KIND_RESIDUAL] == 300
    a.populate(250)
    a.commit(pinned="working_set")
    assert a.state == "committed" and a.pinned == "working_set"
    snap = mm.audit()
    assert snap["total"] == 700
    assert b.release() == 300
    assert b.release() == 0  # idempotent
    assert mm.held_bytes() == 400
    a.release()
    assert mm.held_bytes() == 0
    assert mm.audit()["total"] == 0


def test_reserve_fails_fast_over_budget():
    mm = NodeMemoryManager(100)
    mm.reserve(80, KIND_WORKING_SET)
    with pytest.raises(MemoryPressureError):
        mm.reserve(40, KIND_WORKING_SET, block=False)
    # accounting unchanged by the failed admission
    assert mm.held_bytes() == 80
    mm.audit()


def test_unlimited_budget_accounting_only():
    mm = NodeMemoryManager(None)
    r = mm.reserve(10 << 30, KIND_SCRATCH)  # admits anything
    assert mm.over_budget() == 0 and mm.pressure() == 0.0
    r.release()


def test_blocking_reserve_waits_for_release():
    mm = NodeMemoryManager(100)
    a = mm.reserve(90, KIND_WORKING_SET)
    got = []

    def reserver():
        got.append(mm.reserve(50, KIND_WORKING_SET, timeout=10))

    t = threading.Thread(target=reserver)
    t.start()
    time.sleep(0.1)
    assert not got  # blocked: 90 + 50 > 100
    a.release()
    t.join(timeout=10)
    assert got and mm.held_bytes() == 50
    got[0].release()


def test_region_resize_respects_budget():
    mm = NodeMemoryManager(100)
    r = mm.reserve(40, KIND_POOL)
    assert r.resize(90)
    assert not r.resize(110)  # would exceed the budget: charge unchanged
    assert mm.held_bytes() == 90
    assert r.resize(10)  # shrink always succeeds
    assert mm.held_bytes() == 10
    mm.audit()
    r.release()


def test_high_water_marks_per_kind():
    mm = NodeMemoryManager(1000)
    a = mm.reserve(400, KIND_WORKING_SET)
    b = mm.reserve(200, KIND_IMAGE_CACHE)
    a.release()
    c = mm.reserve(100, KIND_WORKING_SET)
    hw = mm.high_water()
    assert hw[KIND_WORKING_SET] == 400
    assert hw[KIND_IMAGE_CACHE] == 200
    assert hw["total"] == 600
    b.release(); c.release()


# ------------------------------------------------------------ reclaim ladder
def test_reclaim_ladder_runs_in_order():
    mm = NodeMemoryManager(100)
    calls = []
    regions = {}
    for kind, name, order in [
        (KIND_RESIDUAL, "residual", 0),
        (KIND_IMAGE_CACHE, "image-cache", 1),
        (KIND_WORKING_SET, "warm-lru", 2),
    ]:
        regions[name] = mm.reserve(30, kind)

        def rung(nbytes, protect, _n=name):
            calls.append(_n)
            return regions[_n].release()

        mm.register_reclaimer(name, rung, order)
    # 90 held; a 40-byte reserve needs 30 freed: rung 0 suffices
    r = mm.reserve(40, KIND_WORKING_SET)
    assert calls == ["residual"]
    # next 40 needs 40 freed: residual is empty now, so the ladder walks
    # down through image-cache and warm-lru in order
    r2 = mm.reserve(40, KIND_WORKING_SET)
    assert calls == ["residual", "residual", "image-cache", "warm-lru"]
    r.release(); r2.release()
    mm.audit()


def test_reclaim_returns_freed_bytes_and_stops_early():
    mm = NodeMemoryManager(None)
    freed_log = []
    r1 = mm.reserve(60, KIND_RESIDUAL)
    r2 = mm.reserve(60, KIND_IMAGE_CACHE)

    mm.register_reclaimer("a", lambda n, p: freed_log.append(n) or r1.release(), 0)
    mm.register_reclaimer("b", lambda n, p: freed_log.append(n) or r2.release(), 1)
    assert mm.reclaim(50) == 60  # rung 0 covered it
    assert freed_log == [50]    # rung 1 never ran
    assert mm.reclaim(100) == 60  # rung 0 empty now; rung 1 runs
    assert freed_log == [50, 100, 100]


# ------------------------------------------------- pool capacity (satellite)
def test_pool_miss_allocations_are_charged():
    """Regression: the seed's acquire() miss path allocated np.zeros without
    charging capacity, so N concurrent restores staged unbounded untracked
    memory.  Misses now charge; held_bytes covers outstanding buffers."""
    pool = BufferPool(capacity_bytes=64 << 10)
    bufs = [pool.acquire(16 << 10) for _ in range(4)]  # 4 x 16K = capacity
    assert pool.held_bytes == 64 << 10
    extra = pool.acquire(16 << 10)  # over capacity: unmanaged transient
    assert pool.held_bytes == 64 << 10
    assert pool.snapshot_stats()["unmanaged_allocs"] == 1
    # the overshoot is a live gauge, not a silent count
    assert pool.snapshot_stats()["unmanaged_bytes"] == 16 << 10
    assert pool.snapshot_stats()["unmanaged_bytes_hw"] == 16 << 10
    pool.release(extra)  # dropped, not pooled; gauge settles back
    assert pool.held_bytes == 64 << 10
    assert pool.snapshot_stats()["dropped_releases"] == 1
    assert pool.snapshot_stats()["unmanaged_bytes"] == 0
    for b in bufs:
        pool.release(b)
    assert pool.held_bytes == 64 << 10  # all charged bytes now in free lists


def test_pool_foreign_release_is_dropped():
    pool = BufferPool(capacity_bytes=1 << 20)
    pool.release(np.zeros(4096, np.uint8))  # never acquired from this pool
    assert pool.held_bytes == 0
    assert pool.snapshot_stats()["dropped_releases"] == 1


def test_pool_gc_sweep_reclaims_leaked_charges():
    """A caller that drops an acquired buffer without releasing it (e.g. a
    non-pipelined restore whose state tree dies) must not pin the charge."""
    pool = BufferPool(capacity_bytes=64 << 10)
    buf = pool.acquire(32 << 10)
    assert pool.held_bytes == 32 << 10
    del buf
    gc.collect()
    assert pool.held_bytes == 0
    assert pool.snapshot_stats()["gc_reclaimed_bytes"] == 32 << 10


def test_pool_region_mirrors_held_bytes():
    mm = NodeMemoryManager(1 << 20)
    pool = BufferPool(capacity_bytes=1 << 20)
    pool.attach(mm)
    b = pool.acquire(10_000)
    assert mm.kind_bytes()[KIND_POOL] == pool.held_bytes > 0
    pool.release(b)
    assert mm.kind_bytes()[KIND_POOL] == pool.held_bytes
    mm.audit()
    pool.detach()
    assert mm.kind_bytes()[KIND_POOL] == 0


def test_pool_respects_node_budget_not_just_capacity():
    """With a ledger attached, a pool miss that fits capacity but not the
    node budget becomes an unmanaged transient instead of over-committing."""
    mm = NodeMemoryManager(8 << 10)
    other = mm.reserve(6 << 10, KIND_WORKING_SET)
    pool = BufferPool(capacity_bytes=1 << 20)
    pool.attach(mm)
    buf = pool.acquire(4 << 10)  # 4K + 6K > 8K budget
    assert pool.held_bytes == 0
    assert pool.snapshot_stats()["unmanaged_allocs"] == 1
    assert mm.held_bytes() == 6 << 10
    pool.release(buf)
    assert pool.snapshot_stats()["dropped_releases"] == 1
    other.release()
    mm.audit()


def test_image_cache_capacity_evict_honors_pin():
    """An unrecoverable (pinned) base must survive both the pressure
    reclaimer AND the capacity LRU — evicting it would crash every restore
    deduplicated against it."""
    from repro_torch.core import BaseImage, NodeImageCache

    img_nbytes = 4096 * 4
    cache = NodeImageCache(capacity_bytes=int(2.5 * img_nbytes))
    cache.put(BaseImage.from_state("pinned", {"x": np.ones(4096, np.float32)}),
              evictable=False)
    cache.put(BaseImage.from_state("lru-1", {"x": np.ones(4096, np.float32)}))
    cache.put(BaseImage.from_state("lru-2", {"x": np.ones(4096, np.float32)}))
    assert cache.get("pinned") is not None   # pin survived capacity churn
    assert cache.get("lru-1") is None        # recoverable LRU went first
    assert cache.get("lru-2") is not None
    # the pressure reclaimer also skips the pin
    mm = NodeMemoryManager(None)
    cache.attach(mm)
    freed = cache.reclaim(1 << 30)
    assert freed > 0
    assert cache.get("pinned") is not None
    assert cache.get("lru-2") is None
    mm.audit()


# --------------------------------------- ledger invariant (property, seeded)
def _interleave(seed: int, mm: NodeMemoryManager, budget, victims, steps=400):
    """Random reserve/populate/commit/release/reclaim interleaving; the
    audit invariant must hold after EVERY op.  ``victims`` feeds the
    registered reclaimer (regions it may sacrifice under pressure)."""
    r = np.random.RandomState(seed)
    live = []
    for _ in range(steps):
        op = r.randint(7)
        if op <= 1:  # reserve
            kind = MEMORY_KINDS[r.randint(len(MEMORY_KINDS))]
            nb = int(r.randint(1, budget // 2))
            try:
                live.append(mm.reserve(nb, kind, block=False))
            except MemoryPressureError:
                pass
        elif op == 2 and live:  # populate
            reg = live[r.randint(len(live))]
            reg.populate(int(r.randint(1, 1 + reg.nbytes)))
        elif op == 3 and live:  # commit
            reg = live[r.randint(len(live))]
            reg.commit(pinned="working_set" if r.randint(2) else None)
        elif op == 4 and live:  # release
            live.pop(r.randint(len(live))).release()
        elif op == 5 and live:  # mark reclaimable (an idle warm instance)
            victims.append(live.pop(r.randint(len(live))))
        else:  # reclaim under pressure
            mm.reclaim(int(r.randint(1, budget)))
        snap = mm.audit()  # asserts sum(regions) == held <= budget
        assert snap["total"] <= budget
    for reg in live + victims:
        reg.release()
    assert mm.held_bytes() == 0


@pytest.mark.parametrize("seed", range(6))
def test_ledger_invariant_random_interleavings(seed):
    budget = 10_000
    mm = NodeMemoryManager(budget)
    # a reclaimer that sacrifices marked regions oldest-first, like the
    # node's ladder rungs do
    victims = []

    def rung(nbytes, protect):
        freed = 0
        while victims and freed < nbytes:
            freed += victims.pop(0).release()
        return freed

    mm.register_reclaimer("drop-oldest", rung, order=0)
    _interleave(seed, mm, budget, victims)


@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_invariant_threaded(seed):
    """Concurrent reserve/release from several threads: the audit must stay
    coherent at every observation point (taken from a sampler thread)."""
    budget = 100_000
    mm = NodeMemoryManager(budget)
    errors = []
    stop = threading.Event()

    def worker(wseed):
        r = np.random.RandomState(wseed)
        held = []
        try:
            for _ in range(300):
                if held and r.randint(2):
                    held.pop(r.randint(len(held))).release()
                else:
                    try:
                        held.append(mm.reserve(
                            int(r.randint(1, 5000)),
                            MEMORY_KINDS[r.randint(len(MEMORY_KINDS))],
                            block=False,
                        ))
                    except MemoryPressureError:
                        pass
            for reg in held:
                reg.release()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def sampler():
        while not stop.is_set():
            try:
                assert mm.audit()["total"] <= budget
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=worker, args=(seed * 31 + i,)) for i in range(6)]
    s = threading.Thread(target=sampler)
    s.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    s.join()
    assert not errors
    assert mm.held_bytes() == 0
    mm.audit()


# ---------------------------------- budget-bounded concurrent cold restores
ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)


def test_concurrent_restores_over_budget_complete_via_reclaim(tmp_path):
    """Acceptance: a node with budget B runs 4 concurrent cold restores
    whose images sum to > B; every invocation completes via the reclaim
    ladder, and at no observation point does held_bytes exceed B or
    disagree with the sum of live region charges."""
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    from repro_torch.core.jif import JifReader
    from repro_torch.serve.engine import ServerlessNode
    from repro_torch.serve.node import FixedTTLPolicy
    from torch_twins import CPU, jax_params, port_params

    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(keepalive=FixedTTLPolicy(3600.0), device=CPU)
    fnames = [f"mp-{i}" for i in range(4)]
    extra = {"opt": np.ones((1 << 20,), np.float32)}  # 4 MB residual tail
    for i, fname in enumerate(fnames):
        params = port_params(jax_params(jget_config(ARCH).reduced(), 40 + i))
        node.publish(fname, cfg, params, str(tmp_path), formats=("jif",),
                     extra_state=extra)
    # compile-cache warmup, then a clean slate
    node.invoke(fnames[0], PROMPT, max_new_tokens=2, mode="spice_sync", cfg=cfg)
    node.evict()
    node.scheduler.drain_residual()

    img_bytes = []
    for fname in fnames:
        with JifReader(node.registry.get(fname).jif_path) as r:
            img_bytes.append(sum(t.nbytes for t in r.tensors))
    budget = node.pool.held_bytes + int(2.2 * max(img_bytes))
    assert sum(img_bytes) > budget  # the burst genuinely over-subscribes
    node.scheduler.memory_budget = budget

    futures = [
        node.submit(f, PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        for f in fnames
    ]
    peak = 0
    while not all(f.done() for f in futures):
        snap = node.memory.audit()  # asserts ledger equality + budget
        peak = max(peak, snap["total"])
        time.sleep(0.002)
    results = [f.result() for f in futures]
    assert all(r.cold for r in results)
    assert peak <= budget
    # completing the burst REQUIRED the ladder
    mstats = node.memory.snapshot_stats()
    assert mstats["reclaims"] > 0 and mstats["reclaimed_bytes"] > 0
    assert mstats["pressure_failures"] == 0
    node.scheduler.drain_residual()
    node.memory.audit()
