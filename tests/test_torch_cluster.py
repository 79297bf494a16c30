"""The port's twin of ``tests/test_cluster.py``: control-plane/data-plane
split (FunctionCatalog vs NodeScheduler), snapshot-locality-aware placement
across N nodes, sticky join routing, the scale-out knob, and registry
persistence under the split, case for case on the CPU.  The functions carry
the JAX initializer's weights; where a case compares tokens with a
reference, they are also the JAX package's tokens on those weights."""
import threading
import time

import numpy as np
import pytest
from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.core import BaseImage, FunctionRegistry
from repro_torch.interop import tree_map
from repro_torch.serve.cluster import (
    ClusterRouter,
    FunctionCatalog,
    LeastLoaded,
    LocalityFirst,
    RoundRobin,
)
from repro_torch.serve.engine import ServerlessNode
from repro_torch.serve.instance import InstanceState
from repro_torch.serve.node import FixedTTLPolicy, KeepAlivePolicy, NodeScheduler
from torch_twins import CPU, jax_params, jax_tokens, port_params

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[2, 7, 1, 8, 2, 8]], dtype=np.int32)


def _np_params(key):
    return jax_params(jget_config(ARCH).reduced(), key)


@pytest.fixture(scope="module")
def catalog_with_zoo(tmp_path_factory):
    """A catalog owning three published functions (plain JIFs), plus the
    config — nodes are built fresh per test (they are cheap; the zoo and
    the jit compile cache are not)."""
    d = tmp_path_factory.mktemp("czoo")
    cfg = get_config(ARCH).reduced()
    catalog = FunctionCatalog(device=CPU)
    for i, fname in enumerate(["cl-a", "cl-b", "cl-c"]):
        params = port_params(_np_params(40 + i))
        catalog.publish(fname, cfg, params, str(d), warm_ttl_s=3600.0,
                        formats=("jif",))
    # a first invocation through a throwaway single node
    node = NodeScheduler(registry=catalog.registry, device=CPU)
    node.invoke("cl-a", PROMPT, max_new_tokens=2, mode="spice_sync", cfg=cfg)
    node.close()
    return catalog, cfg, str(d)


def _cluster(catalog, n=3, placement=None, **kwargs):
    nodes = [
        NodeScheduler(registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0),
                      device=CPU)
        for _ in range(n)
    ]
    return ClusterRouter(catalog, nodes, placement=placement, **kwargs)


# ------------------------------------------------------------- control plane
def test_catalog_owns_registry_and_nodes_reference_it(catalog_with_zoo):
    catalog, cfg, _ = catalog_with_zoo
    router = _cluster(catalog)
    for node in router.nodes:
        assert node.registry is catalog.registry
    assert set(catalog.registry.names()) >= {"cl-a", "cl-b", "cl-c"}


def test_registry_roundtrip_under_catalog_split(catalog_with_zoo, tmp_path):
    """Registry save/load survives the split: a catalog rebuilt from disk
    serves invocations on a brand-new node with identical tokens."""
    catalog, cfg, _ = catalog_with_zoo
    ref = _cluster(catalog, n=1).invoke(
        "cl-b", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg
    )
    np.testing.assert_array_equal(
        ref.tokens, jax_tokens(jget_config(ARCH).reduced(), _np_params(41), PROMPT, 3))

    path = str(tmp_path / "registry.json")
    catalog.save(path)
    loaded = FunctionCatalog.load(path, device=CPU)
    assert loaded.registry.names() == catalog.registry.names()
    spec0, spec1 = catalog.registry.get("cl-b"), loaded.registry.get("cl-b")
    assert (spec0.jif_path, spec0.base_image, spec0.warm_ttl_s) == (
        spec1.jif_path, spec1.base_image, spec1.warm_ttl_s
    )

    node = ServerlessNode(catalog=loaded, device=CPU)
    r = node.invoke("cl-b", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
    assert r.cold and r.node == ""  # single-node path: empty node name
    np.testing.assert_array_equal(r.tokens, ref.tokens)


def test_single_node_facade_keeps_surface(catalog_with_zoo, tmp_path):
    """publish/invoke/record_access/relayout still work through the facade
    (catalog behind it), and the data plane carries no publish path."""
    catalog, cfg, _ = catalog_with_zoo
    node = ServerlessNode(device=CPU)
    params = port_params(_np_params(77))
    node.publish("fac-fn", cfg, params, str(tmp_path), warm_ttl_s=60,
                 formats=("jif",))
    assert node.catalog.stats["publishes"] == 1
    r = node.invoke("fac-fn", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r.cold
    order = node.record_access("fac-fn", PROMPT, max_new_tokens=2, cfg=cfg)
    assert order and node.catalog.recorded_order("fac-fn") == order
    stats = node.relayout("fac-fn")
    assert stats.ws_tensors == len(order)
    assert not hasattr(node.scheduler, "publish")  # pure data plane


# ------------------------------------------------------------ sticky routing
def test_locality_first_sticks_and_second_invoke_is_warm(catalog_with_zoo):
    catalog, cfg, _ = catalog_with_zoo
    router = _cluster(catalog)
    r1 = router.invoke("cl-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    r2 = router.invoke("cl-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r1.cold and not r2.cold
    assert r1.node == r2.node and r1.node.startswith("node")
    assert router.replicas("cl-a") == [r1.node]
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    router.audit()


def test_concurrent_burst_joins_on_one_node_zero_duplicate_colds(catalog_with_zoo):
    """Single population per cluster: a burst of one function's invocations
    rides ONE restore on ONE node — no duplicate concurrent cold restores
    anywhere in the fleet."""
    catalog, cfg, _ = catalog_with_zoo
    router = _cluster(catalog)
    futs = [
        router.submit("cl-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg,
                      simulate_read_bw=5e8)
        for _ in range(5)
    ]
    results = [f.result() for f in futs]
    assert len({r.node for r in results}) == 1
    real_colds = sum(1 for r in results if r.cold and not r.joined)
    joined = sum(1 for r in results if r.joined)
    assert real_colds == 1 and joined == len(results) - 1
    toks = results[0].tokens
    for r in results[1:]:
        np.testing.assert_array_equal(r.tokens, toks)
    # cluster-wide: only one node ever cold-started this function
    assert sum(n.stats["cold_starts"] for n in router.nodes) == 1
    router.audit()


def test_round_robin_spreads_while_locality_does_not(catalog_with_zoo):
    catalog, cfg, _ = catalog_with_zoo
    router = _cluster(catalog, placement=RoundRobin())
    nodes_hit = []
    for _ in range(3):
        r = router.invoke("cl-c", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        nodes_hit.append(r.node)
        assert r.cold  # every placement is a fresh node: always cold
    assert len(set(nodes_hit)) == 3
    router.audit()


def test_least_loaded_avoids_busy_node(catalog_with_zoo):
    catalog, cfg, _ = catalog_with_zoo
    router = _cluster(catalog, n=2, placement=LeastLoaded())
    # jam node0 with a slow restore, then place a different function
    f0 = router.nodes[0].submit("cl-a", PROMPT, max_new_tokens=2, mode="spice",
                                cfg=cfg, simulate_read_bw=2e7)
    deadline = time.time() + 5
    while router.nodes[0].load().queue_depth == 0 and time.time() < deadline:
        time.sleep(0.005)
    r = router.invoke("cl-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r.node == "node1"
    f0.result()
    router.audit()


# ------------------------------------------------------- locality tiers
def test_locality_first_prefers_cached_base_image(catalog_with_zoo, tmp_path):
    """Tier 3 (base-image-cached): the node already holding the function's
    base image wins placement over emptier nodes."""
    catalog, cfg, _ = catalog_with_zoo
    base_params = _np_params(90)
    from repro_torch.serve.instance import layerwise_state

    img = BaseImage.from_state("tier-base", layerwise_state(cfg, base_params))
    catalog.install_base(img)  # authoring-side: publish dedups against it
    # fine-tune ONE projection so most chunks stay BASE (dedup-able)
    ft = dict(base_params)
    ft["pattern"] = list(ft["pattern"])
    ft["pattern"][0] = dict(ft["pattern"][0])
    ft["pattern"][0]["attn"] = dict(ft["pattern"][0]["attn"])
    ft["pattern"][0]["attn"]["wq"] = ft["pattern"][0]["attn"]["wq"] * np.float32(1.01)
    catalog.publish("tier-fn", cfg, port_params(ft), str(tmp_path), base_name="tier-base",
                    warm_ttl_s=3600.0, formats=("jif",))

    router = _cluster(catalog)
    router.nodes[2].node_cache.put(img, evictable=False)  # only node2 has it
    r = router.invoke("tier-fn", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r.node == "node2"
    assert router.nodes[2].node_cache.stats["base_bytes_served"] > 0
    router.audit()


def test_locality_first_prefers_delta_parent_cached_node(catalog_with_zoo, tmp_path):
    """Tier 4 (delta-parent-cached): after one node bootstraps a delta's
    parent from disk, an unrelated fresh placement of a sibling delta goes
    to that node — its resident parent makes the restore private-only."""
    catalog, cfg, _ = catalog_with_zoo
    from repro_torch.core import snapshot
    from repro_torch.serve.instance import layerwise_state

    base_params = _np_params(91)
    parent_path = str(tmp_path / "parent.jif")
    snapshot(layerwise_state(cfg, base_params), parent_path)
    for i, fname in enumerate(["delta-x", "delta-y"]):
        ft = tree_map(lambda a: a * np.float32(1.01 + 0.01 * i), base_params)
        catalog.publish(fname, cfg, port_params(ft), str(tmp_path), parent=parent_path,
                        warm_ttl_s=3600.0, formats=("jif",))

    router = _cluster(catalog)
    r1 = router.invoke("delta-x", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    serving = router.node(r1.node)
    key = catalog.locality_key("delta-x")
    assert key is not None and serving.node_cache.contains(key)
    assert catalog.locality_key("delta-y") == key  # same parent chain

    # sibling delta: the parent-cached node must win placement
    r2 = router.invoke("delta-y", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r2.node == r1.node
    # ...and the parent was bootstrapped exactly once cluster-wide
    assert sum(1 for n in router.nodes if n.node_cache.contains(key)) == 1
    router.audit()

    # relayout must preserve the delta chain: same parent ref, still
    # delta-sized, locality key intact (regression: a chain-dropping
    # rewrite would balloon the file and erase the placement tier)
    import os

    spec = catalog.registry.get("delta-x")
    size_before = os.path.getsize(spec.jif_path)
    order = router.record_access("delta-x", prompt=PROMPT, max_new_tokens=2,
                                 cfg=cfg)
    stats = router.relayout("delta-x")
    assert stats.parent == os.path.abspath(parent_path)
    assert os.path.getsize(spec.jif_path) < 0.6 * os.path.getsize(parent_path) \
        or os.path.getsize(spec.jif_path) <= 1.2 * size_before
    assert catalog.locality_key("delta-x") is not None
    r3 = ClusterRouter(catalog, [NodeScheduler(registry=catalog.registry, device=CPU)]) \
        .invoke("delta-x", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    np.testing.assert_array_equal(r3.tokens, r1.tokens)


def test_scale_out_knob_spawns_second_replica(catalog_with_zoo):
    catalog, cfg, _ = catalog_with_zoo
    router = _cluster(catalog, scale_out_queue_depth=1)
    futs = [
        router.submit("cl-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg,
                      simulate_read_bw=5e7)
        for _ in range(6)
    ]
    for f in futs:
        f.result()
    assert len(router.replicas("cl-a")) >= 2
    assert router.stats["scale_outs"] >= 1
    router.audit()


def test_node_load_probe_surface(catalog_with_zoo):
    catalog, cfg, _ = catalog_with_zoo
    router = _cluster(catalog, n=2)
    r = router.invoke("cl-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    router.drain_residual()
    loads = {l.node: l for l in router.loads()}
    assert set(loads) == {"node0", "node1"}
    serving = loads[r.node]
    assert "cl-a" in serving.warm and serving.warm_bytes > 0
    assert serving.queue_depth == 0 and serving.pressure >= 0.0
    other = loads[{"node0", "node1"}.difference({r.node}).pop()]
    assert "cl-a" not in other.warm


# --------------------------------------------------------- keep-alive policy
def test_custom_keepalive_victims_ordering(catalog_with_zoo, tmp_path):
    """The pluggable victims() contract: eviction under pressure follows
    the policy's order, not the built-in LRU."""

    class EvictNamedFirst(KeepAlivePolicy):
        def __init__(self, first: str):
            self.first = first

        def ttl_for(self, spec):
            return 3600.0

        def victims(self, warm, need_evict):
            return sorted(
                warm, key=lambda i: (i.spec.name != self.first, i.last_used)
            )

    catalog, cfg, _ = catalog_with_zoo
    # "cl-b" is MRU — default LRU would sacrifice cl-a first; the custom
    # policy must pick cl-b regardless
    node = NodeScheduler(registry=catalog.registry,
                         keepalive=EvictNamedFirst("cl-b"), device=CPU)
    node.invoke("cl-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    node.invoke("cl-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    node.drain_residual()
    inst_b = node.instance("cl-b")
    inst_b.last_used = time.time() + 100  # force MRU: LRU would never pick it
    freed = node._reclaim_warm_lru(1, protect=frozenset())
    assert freed > 0
    assert node.instance("cl-b").state is InstanceState.EVICTED
    assert node.instance("cl-a").state is InstanceState.WARM
    node.memory.audit()
