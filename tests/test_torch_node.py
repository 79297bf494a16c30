"""The port's twin of ``tests/test_node.py``: concurrent restores through
the shared prefetch I/O scheduler, instance lifecycle (TTL + LRU
eviction), and joined in-flight restores, case for case on the CPU.  The
functions carry the JAX initializer's weights, and the tokens a cold start
must give are the JAX package's on them."""
import time

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.serve.engine import ServerlessNode
from repro_torch.serve.instance import InstanceState
from repro_torch.serve.node import FixedTTLPolicy
from torch_twins import CPU, jax_params, jax_tokens, port_params

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)
FNAMES = ["fn-a", "fn-b", "fn-c", "fn-d"]


def _params(key):
    return port_params(jax_params(jget_config(ARCH).reduced(), key))


@pytest.fixture(scope="module")
def node_with_zoo(tmp_path_factory):
    """Four functions of one arch (distinct weights) on one node, and the
    JAX package's tokens for each."""
    d = tmp_path_factory.mktemp("zoo")
    cfg = get_config(ARCH).reduced()
    jcfg = jget_config(ARCH).reduced()
    node = ServerlessNode(device=CPU)
    ref = {}
    for i, fname in enumerate(FNAMES):
        np_params = jax_params(jcfg, i)
        node.publish(fname, cfg, port_params(np_params), str(d), warm_ttl_s=0.0,
                     formats=("jif", "monolith"))
        ref[fname] = jax_tokens(jcfg, np_params, PROMPT, 4)
    node.invoke(FNAMES[0], PROMPT, max_new_tokens=3, mode="spice_sync", cfg=cfg)
    yield node, cfg, ref
    node.close()


def test_concurrent_cold_invokes_match_warm_reference(node_with_zoo):
    node, cfg, ref = node_with_zoo
    node.evict()

    before = node.iosched.snapshot_stats()
    futures = [
        node.submit(fname, PROMPT, max_new_tokens=4, mode="spice", cfg=cfg)
        for fname in FNAMES
    ]
    results = {f.result().function: f.result() for f in futures}
    after = node.iosched.snapshot_stats()

    assert set(results) == set(FNAMES)
    for fname in FNAMES:
        assert results[fname].cold
        np.testing.assert_array_equal(results[fname].tokens, ref[fname],
                                      err_msg=fname)
    # every restore went through the SHARED scheduler
    assert after["streams_opened"] - before["streams_opened"] >= len(FNAMES)
    assert after["bytes_read"] > before["bytes_read"]


def test_concurrent_same_function_joins_inflight_restore(node_with_zoo):
    node, cfg, ref = node_with_zoo
    node.evict()
    futures = [
        node.submit(FNAMES[0], PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        for _ in range(4)
    ]
    results = [f.result() for f in futures]
    for r in results:
        np.testing.assert_array_equal(r.tokens, ref[FNAMES[0]][:, :3])
    assert all(r.cold for r in results)
    # exactly one owner restored; the rest joined its handle tree
    assert sum(1 for r in results if r.joined) == len(results) - 1


def test_contended_restores_issue_demand_boosts(node_with_zoo):
    """With several functions restoring through one arbiter at simulated
    NVMe bandwidth, execution demand must overtake background prefetch."""
    node, cfg, _ = node_with_zoo
    node.evict()
    before = node.iosched.snapshot_stats()["demand_boosts"]
    futures = [
        node.submit(fname, PROMPT, max_new_tokens=3, mode="spice", cfg=cfg,
                    simulate_read_bw=1e9)
        for fname in FNAMES[:3]
    ]
    for f in futures:
        assert f.result().cold
    assert node.iosched.snapshot_stats()["demand_boosts"] > before


def test_warm_ttl_expiry_takes_cold_path(tmp_path):
    """Regression: warm instances past their TTL must be evicted and the
    next invocation must take the cold path."""
    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(device=CPU)
    try:
        node.publish("ttl-fn", cfg, _params(9), str(tmp_path), warm_ttl_s=0.4,
                     formats=("jif",))
        r1 = node.invoke("ttl-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        r2 = node.invoke("ttl-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        assert r1.cold and not r2.cold  # within TTL: warm
        inst = node.scheduler.instance("ttl-fn")
        assert inst.state is InstanceState.WARM
        time.sleep(0.5)
        r3 = node.invoke("ttl-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        assert r3.cold  # expired: evicted, cold path again
        assert node.scheduler.stats["ttl_evictions"] >= 1
        assert inst.counters["ttl_evictions"] >= 1
        np.testing.assert_array_equal(r1.tokens, r3.tokens)
    finally:
        node.close()


def test_background_reaper_evicts_idle_expired_instance(tmp_path):
    """Regression: an expired warm instance on an IDLE node must not hold
    its ledger bytes forever.  The background reaper must evict it — and
    release its ledger regions — without any further invocation arriving."""
    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(reap_interval_s=0.05, device=CPU)
    try:
        node.publish("reap-fn", cfg, _params(13), str(tmp_path), warm_ttl_s=0.3,
                     formats=("jif",))
        r = node.invoke("reap-fn", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert r.cold
        node.scheduler.drain_residual()
        inst = node.scheduler.instance("reap-fn")
        assert inst.state is InstanceState.WARM
        assert node.memory.kind_bytes()["working_set"] > 0
        # NO further invocations: only the reaper thread can evict it
        deadline = time.time() + 5
        while time.time() < deadline and inst.state is not InstanceState.EVICTED:
            time.sleep(0.02)
        assert inst.state is InstanceState.EVICTED
        assert node.scheduler.stats["ttl_evictions"] >= 1
        kinds = node.memory.kind_bytes()
        assert kinds["working_set"] == 0 and kinds["residual"] == 0
        node.memory.audit()
    finally:
        node.scheduler.stop_reaper()
        node.close()


def test_lru_eviction_under_memory_budget(tmp_path):
    """A tight node budget keeps only the most recently used instances
    warm; older ones are LRU-evicted."""
    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(
        pool=None,
        keepalive=FixedTTLPolicy(3600.0),  # everyone WANTS to stay warm
        device=CPU,
    )
    try:
        for i, fname in enumerate(["lru-a", "lru-b", "lru-c"]):
            node.publish(fname, cfg, _params(20 + i), str(tmp_path), formats=("jif",))

        r = node.invoke("lru-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert r.cold
        inst_a = node.scheduler.instance("lru-a")
        assert inst_a.state is InstanceState.WARM and inst_a.memory_bytes > 0
        # budget: room for ~1.5 instances and NO slack for pool staging — the
        # ladder trims the (expendable) free list first, so only a budget this
        # tight forces the warm-LRU rung
        node.scheduler.memory_budget = int(1.5 * inst_a.memory_bytes)
        node.invoke("lru-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert node.scheduler.instance("lru-a").state is InstanceState.EVICTED
        assert node.scheduler.instance("lru-b").state is InstanceState.WARM
        node.invoke("lru-c", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert node.scheduler.instance("lru-b").state is InstanceState.EVICTED
        assert node.scheduler.instance("lru-c").state is InstanceState.WARM
        assert node.scheduler.stats["lru_evictions"] >= 2
    finally:
        node.close()


def test_warm_at_working_set_promotion(tmp_path):
    """With residual state behind the ws boundary, the owner promotes at
    working-set completion (WARMING) instead of waiting for the full image;
    the residual finalizes WARM in the background."""
    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(device=CPU)
    try:
        extra = {"opt": np.ones((1 << 20,), np.float32)}  # 4 MB residual tail
        node.publish("ws-fn", cfg, _params(31), str(tmp_path), warm_ttl_s=60,
                     formats=("jif",), extra_state=extra)
        r1 = node.invoke("ws-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg,
                         simulate_read_bw=5e8)
        assert r1.cold
        assert r1.stats["ws_ready"]
        assert r1.stats["residual_tensors"] > 0
        assert node.scheduler.stats["ws_promotions"] == 1
        inst = node.scheduler.instance("ws-fn")
        assert inst.state in (InstanceState.WARMING, InstanceState.WARM)
        assert inst.ws_ready and inst.memory_bytes > 0
        # invocations during/after WARMING route warm (no second restore)
        r2 = node.invoke("ws-fn", PROMPT, max_new_tokens=3, cfg=cfg)
        assert not r2.cold
        np.testing.assert_array_equal(r1.tokens, r2.tokens)
        # the background residual stream drains and finalizes WARM
        deadline = time.time() + 30
        while time.time() < deadline and inst.state is not InstanceState.WARM:
            time.sleep(0.05)
        assert inst.state is InstanceState.WARM
        assert inst.getter is None  # resolved device tree swapped in
        assert node.scheduler.residual_streams() == 0
        r3 = node.invoke("ws-fn", PROMPT, max_new_tokens=3, cfg=cfg)
        assert not r3.cold
        np.testing.assert_array_equal(r1.tokens, r3.tokens)
    finally:
        node.close()


def test_record_access_then_relayout(tmp_path):
    """The §5 feedback loop: a warm generation is traced, relayout rewrites
    the JIF with the observed order, and the next cold start still produces
    identical tokens."""
    from repro_torch.core.jif import JifReader

    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(device=CPU)
    try:
        node.publish("rl-fn", cfg, _params(33), str(tmp_path), warm_ttl_s=60,
                     formats=("jif",))
        r1 = node.invoke("rl-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        assert r1.cold

        order = node.record_access("rl-fn", PROMPT, max_new_tokens=2, cfg=cfg)
        assert order
        assert node.catalog.recorded_order("rl-fn") == order

        stats = node.relayout("rl-fn")
        assert stats.ws_boundary > 0
        assert stats.ws_tensors == len(order)
        assert node.catalog.stats["relayouts"] == 1
        with JifReader(node.registry.get("rl-fn").jif_path) as r:
            assert r.version == 2
            assert r.meta["access_order"][: len(order)] == order
            assert r.meta.get("relayout") is True

        node.evict()
        r2 = node.invoke("rl-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        assert r2.cold
        np.testing.assert_array_equal(r1.tokens, r2.tokens)
    finally:
        node.close()


def test_residual_evict_then_cheap_rerestore(tmp_path):
    """The EVICTED → RESTORING re-restore path: dropping only residual
    pages keeps the pinned working set, so the next restore reads strictly
    fewer bytes (exactly the residual) and still generates identically."""
    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(device=CPU)
    try:
        extra = {"opt": np.ones((1 << 20,), np.float32)}  # 4 MB residual tail
        node.publish("rr-fn", cfg, _params(51), str(tmp_path), warm_ttl_s=60,
                     formats=("jif",), extra_state=extra)
        r1 = node.invoke("rr-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        assert r1.cold
        assert node.scheduler.drain_residual()
        inst = node.scheduler.instance("rr-fn")
        cold_read = inst.restore_stats.as_dict()["bytes_read"]
        ws_bytes = inst.ws_region.nbytes
        residual_bytes = inst.residual_region.nbytes

        freed = node.scheduler.evict_residual("rr-fn")
        assert freed == residual_bytes
        assert inst.state is InstanceState.EVICTED
        assert inst.ws_pinned and inst.ws_region is not None
        assert inst.residual_region is None
        assert node.scheduler.stats["residual_evictions"] == 1
        node.memory.audit()  # pinned ws still charged, residual uncharged

        r2 = node.invoke("rr-fn", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
        assert r2.cold  # a restore, but a cheap one
        assert node.scheduler.drain_residual()
        d2 = inst.restore_stats.as_dict()
        assert d2["reused_bytes"] == ws_bytes      # whole ws served from memory
        assert d2["bytes_read"] < cold_read        # strictly fewer bytes read
        # ... and only the dropped tail (chunk-padded per residual tensor)
        assert d2["bytes_read"] <= residual_bytes + 4096 * d2["residual_tensors"]
        assert node.scheduler.stats["ws_rerestores"] == 1
        np.testing.assert_array_equal(r1.tokens, r2.tokens)
        node.memory.audit()
    finally:
        node.close()


def test_manual_evict_waits_for_warming(tmp_path):
    """Regression: evict() during the WARMING window must wait it out, or
    the next invocation silently routes warm instead of cold."""
    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(device=CPU)
    try:
        extra = {"opt": np.ones((1 << 20,), np.float32)}
        node.publish("ev-fn", cfg, _params(71), str(tmp_path), warm_ttl_s=60,
                     formats=("jif",), extra_state=extra)
        # a first run first, so the invoke returns DURING the residual stream
        # (the race window)
        node.invoke("ev-fn", PROMPT, max_new_tokens=2, mode="spice_sync", cfg=cfg)
        node.evict()
        r1 = node.invoke("ev-fn", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg,
                         simulate_read_bw=5e8)
        assert r1.cold
        node.evict()  # must wait out WARMING, then actually evict
        inst = node.scheduler.instance("ev-fn")
        assert inst.state is InstanceState.EVICTED
        r2 = node.invoke("ev-fn", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert r2.cold
        np.testing.assert_array_equal(r1.tokens, r2.tokens)
    finally:
        node.close()


def test_reclaim_ladder_order(tmp_path):
    """Pressure reclaim drops residual tails before cached base images
    before warm LRU state (the paper's cheap-state-first ladder)."""
    from repro_torch.core import BaseImage

    cfg = get_config(ARCH).reduced()
    node = ServerlessNode(device=CPU)
    try:
        extra = {"opt": np.ones((1 << 20,), np.float32)}  # 4 MB residual
        for i, fname in enumerate(["lad-a", "lad-b"]):
            node.publish(fname, cfg, _params(60 + i), str(tmp_path), warm_ttl_s=3600,
                         formats=("jif",), extra_state=extra)
        node.invoke("lad-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        node.invoke("lad-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert node.scheduler.drain_residual()
        img = BaseImage.from_state("lad-img", {"x": np.ones((1 << 18,), np.float32)})
        node.node_cache.put(img)  # 1 MB cached image
        inst_a = node.scheduler.instance("lad-a")
        inst_b = node.scheduler.instance("lad-b")
        residual = inst_a.residual_region.nbytes

        # rung 0: both residual tails cover the request; images and warm
        # instances are untouched
        freed = node.memory.reclaim(2 * residual)
        assert freed >= 2 * residual
        assert inst_a.state is InstanceState.EVICTED and inst_a.ws_pinned
        assert inst_b.state is InstanceState.EVICTED and inst_b.ws_pinned
        assert node.node_cache.get("lad-img") is not None

        # rung 1: residual exhausted — the cached image goes next; pinned
        # working sets survive
        freed = node.memory.reclaim(img.nbytes)
        assert freed >= img.nbytes
        assert node.node_cache.get("lad-img") is None
        assert inst_a.ws_pinned and inst_b.ws_pinned

        # rung 2 trims idle pool staging before any warm state is touched;
        # rung 3 then sacrifices pinned working sets LRU-first.  Request
        # enough that the pool alone cannot cover it.
        pool_free = sum(sc * len(lst) for sc, lst in node.pool._free.items())
        freed = node.memory.reclaim(pool_free + inst_a.ws_region.nbytes)
        assert freed > 0
        assert inst_a.ws_pinned is None  # oldest pin dropped first
        assert inst_b.ws_pinned          # newer pin survives the request
        node.memory.audit()
    finally:
        node.close()


def test_instance_state_machine_transitions():
    from repro_torch.core import FunctionSpec
    from repro_torch.serve.instance import FunctionInstance

    spec = FunctionSpec(name="f", arch=ARCH, jif_path="/dev/null")
    inst = FunctionInstance(spec, cfg=None)
    assert inst.state is InstanceState.COLD
    with inst.cond:
        gen = inst.begin_restore("spice")
        assert inst.state is InstanceState.RESTORING and gen == 1
        inst.publish_restore({"x": 1}, None, None)
        inst.promote_warm({"x": np.zeros(64)}, ttl_s=10.0, now=time.time())
        assert inst.state is InstanceState.WARM
        assert inst.memory_bytes == 64 * 8
        assert inst.evict("manual")
        assert inst.state is InstanceState.EVICTED
        # next restore bumps the generation
        assert inst.begin_restore("spice") == 2
        inst.publish_restore({"x": 1}, None, None)
        inst.promote_warm({"x": 1}, ttl_s=0.0, now=time.time())  # no keep-alive
        assert inst.state is InstanceState.COLD and inst.tree is None
