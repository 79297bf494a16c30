"""The port's warm-state handoff and SLO autoscaler (``repro_torch.serve.
{handoff,autoscale}``) against the JAX package's: the cases of
``tests/test_handoff.py`` on the port's nodes (CPU, reduced qwen1.5-0.5b),
then both packages on the same seed-made weights: the same tokens and the
same handoff ``delta_bytes``, and a handoff JIF written by either package
restoring in the other to the same bytes."""
import contextlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import SpiceRestorer as JRestorer
from repro.core.cache import BaseImage as JBaseImage
from repro.models import lm as jlm
from repro.serve.cluster import ClusterRouter as JRouter
from repro.serve.cluster import FunctionCatalog as JCatalog
from repro.serve.handoff import handoff_warm as j_handoff_warm
from repro.serve.node import FixedTTLPolicy as JFixedTTL
from repro.serve.node import NodeScheduler as JNode
from repro_torch.configs import get_config
from repro_torch.core import SpiceRestorer
from repro_torch.core.cache import BaseImage
from repro_torch.core.overlay import DEFAULT_PAGE
from repro_torch.core.treeutil import flatten_state
from repro_torch.interop import params_from_jax, to_numpy
from repro_torch.models import lm
from repro_torch.serve.autoscale import AutoScaler, ServiceSLO, SLOMonitor
from repro_torch.serve.cluster import ClusterRouter, FunctionCatalog
from repro_torch.serve.handoff import _tree_nbytes, handoff_warm, wait_idle_warm
from repro_torch.serve.instance import InstanceState
from repro_torch.serve.invocation import QosClass
from repro_torch.serve.node import FixedTTLPolicy, InvokeResult, NodeScheduler

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)
CPU = "cpu"


@pytest.fixture(scope="module")
def catalog_with_zoo(tmp_path_factory):
    d = tmp_path_factory.mktemp("hzoo")
    cfg = get_config(ARCH).reduced()
    catalog = FunctionCatalog(device=CPU)
    for i, fname in enumerate(["hf-a", "hf-b", "hf-c"]):
        params = lm.init_params(cfg, seed=60 + i, device=CPU)
        catalog.publish(fname, cfg, params, str(d), warm_ttl_s=3600.0, formats=("jif",))
    return catalog, cfg, str(d)


def _router(catalog, n=2, **kwargs):
    nodes = [
        NodeScheduler(registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0), device=CPU)
        for _ in range(n)
    ]
    return ClusterRouter(catalog, nodes, **kwargs)


def _leaves(state):
    """(name, host array) of every leaf, in name order."""
    return sorted((n, to_numpy(a)) for n, a in flatten_state(state)[0])


def _other(router, name):
    return next(n.name for n in router.nodes if n.name != name)


# ------------------------------------------------------------ the handoff
def test_handoff_byte_identical_and_reroutes(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog)
    ref = router.invoke("hf-a", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
    assert ref.cold
    src_name, dst_name = ref.node, _other(router, ref.node)
    src, dst = router.node(src_name), router.node(dst_name)
    src_leaves = _leaves(src.warm_state("hf-a"))

    hs = handoff_warm(router, "hf-a", src_name, dst_name, handoff_dir=str(tmp_path), cfg=cfg)
    assert hs.ok, hs.reason

    dst_leaves = _leaves(dst.warm_state("hf-a"))
    assert len(dst_leaves) == len(src_leaves) > 0
    for (na, a), (nb, b) in zip(src_leaves, dst_leaves):
        assert na == nb and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    assert dst.stats["cold_starts"] == 0
    assert dst.stats["speculative_restores"] == 1
    assert src.instance("hf-a").state is InstanceState.EVICTED
    assert router.replicas("hf-a") == [dst_name]

    r = router.invoke("hf-a", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
    assert not r.cold and r.node == dst_name
    np.testing.assert_array_equal(r.tokens, ref.tokens)
    router.audit()
    router.close()


def test_handoff_delta_is_dirty_state_only(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog)
    r = router.invoke("hf-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    hs = handoff_warm(router, "hf-b", r.node, _other(router, r.node),
                      handoff_dir=str(tmp_path), cfg=cfg)
    assert hs.ok, hs.reason
    assert hs.total_bytes > 0
    assert hs.delta_bytes < 0.1 * hs.total_bytes
    router.audit()
    router.close()


def test_inflight_invocation_completes_before_handoff(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog)
    seed = router.invoke("hf-c", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
    src_name, dst_name = seed.node, _other(router, seed.node)
    src = router.node(src_name)
    src.evict("hf-c")
    fut = src.submit("hf-c", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg,
                     simulate_read_bw=5e7)  # slow restore: instance is busy
    deadline = time.time() + 10
    while time.time() < deadline:
        inst = src.instance("hf-c")
        if inst is not None and inst.state is InstanceState.RESTORING:
            break
        time.sleep(0.001)
    assert src.instance("hf-c").state is InstanceState.RESTORING
    hs = handoff_warm(router, "hf-c", src_name, dst_name, handoff_dir=str(tmp_path), cfg=cfg)
    r = fut.result(timeout=60)
    assert r.cold
    np.testing.assert_array_equal(r.tokens, seed.tokens)
    assert hs.ok, hs.reason
    assert router.node(dst_name).instance("hf-c").state is InstanceState.WARM
    router.audit()
    router.close()


def test_handoff_of_missing_instance_fails_gracefully(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog)
    hs = handoff_warm(router, "hf-a", router.nodes[0].name, router.nodes[1].name,
                      handoff_dir=str(tmp_path), cfg=cfg, timeout=0.2)
    assert not hs.ok and hs.reason
    assert not wait_idle_warm(router.nodes[0], "hf-a", timeout=0.05)
    router.close()


# ------------------------------------------------------------ the drain
def test_drain_returns_ledger_to_prerestore_residency(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog)
    baseline = {n.name: n.memory.held_bytes() for n in router.nodes}
    r = router.invoke("hf-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    src = router.node(r.node)
    assert src.memory.held_bytes() > baseline[r.node]

    scaler = AutoScaler(router, [], handoff_dir=str(tmp_path), min_nodes=1)
    drained = scaler.drain_node(r.node)
    assert drained is src and src.name not in [n.name for n in router.nodes]
    kinds = src.memory.kind_bytes()
    for kind in ("working_set", "residual", "scratch", "image_cache",
                 "device_image", "chunk_cas"):
        assert kinds.get(kind, 0) == 0, (kind, kinds)
    src.memory.reclaim(1 << 40)
    assert src.memory.held_bytes() == baseline[r.node]
    src.memory.audit()
    r2 = router.invoke("hf-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert not r2.cold and r2.node != r.node
    np.testing.assert_array_equal(r2.tokens, r.tokens)
    router.audit()
    router.close()


def test_drain_without_handoff_forces_future_cold_start(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog)
    r = router.invoke("hf-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    scaler = AutoScaler(router, [], handoff_dir=str(tmp_path), min_nodes=1, handoff=False)
    scaler.drain_node(r.node)
    assert scaler.stats["drain_evictions"] == 1
    assert scaler.stats["handoffs_ok"] == 0
    r2 = router.invoke("hf-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r2.cold
    router.audit()
    router.close()


# ----------------------------------------------------------- the monitor
def _result(qos="latency", ttft=0.01, wait=0.0, mode="spice"):
    return InvokeResult(tokens=np.zeros((1, 1), np.int32), cold=False,
                        mode=mode, ttft_s=ttft, queue_wait_s=wait, qos=qos)


def test_slo_monitor_needs_min_samples_to_violate():
    mon = SLOMonitor(window_s=60.0, min_samples=4)
    slos = [ServiceSLO(QosClass.LATENCY, ttft_p99_s=0.1)]
    for _ in range(3):
        mon.observe(_result(ttft=5.0))
    violations, slack = mon.assess(slos)
    assert not violations
    assert not slack
    mon.observe(_result(ttft=5.0))
    violations, _ = mon.assess(slos)
    assert violations and "latency:ttft" in violations[0]


def test_slo_monitor_excludes_prewarms_and_reports_slack():
    mon = SLOMonitor(window_s=60.0, min_samples=2)
    slos = [ServiceSLO(QosClass.LATENCY, ttft_p99_s=0.1, queue_wait_p95_s=0.1)]
    for _ in range(8):
        mon.observe(_result(ttft=0.01, wait=0.01))
        mon.observe(_result(ttft=99.0, mode="prewarm"))
    violations, slack = mon.assess(slos)
    assert not violations and slack
    assert mon.percentile(QosClass.LATENCY, "ttft", 0.99) == pytest.approx(0.01)
    violations, slack = mon.assess([ServiceSLO(QosClass.BATCH, ttft_p99_s=0.1)])
    assert not violations and slack


# ------------------------------------------------------- the control loop
def test_autoscaler_scales_out_on_sustained_violation(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog, n=1)
    mon = SLOMonitor(window_s=60.0, min_samples=2)
    dev = router.nodes[0].device
    scaler = AutoScaler(
        router, [ServiceSLO(QosClass.LATENCY, ttft_p99_s=0.05)],
        handoff_dir=str(tmp_path), monitor=mon, scale_out_after=2, max_nodes=2,
        node_factory=lambda name: NodeScheduler(
            registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0), name=name,
            device=dev),
    )
    for _ in range(4):
        mon.observe(_result(ttft=1.0))
    assert scaler.tick() is None
    assert scaler.tick() == "scale_out"
    assert len(router.nodes) == 2 and scaler.stats["scale_outs"] == 1
    assert scaler.tick() is None
    grown = router.nodes[-1]
    assert grown.device == dev
    r = grown.invoke("hf-c", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r.cold and grown.on_result == mon.observe
    router.audit()
    router.close()


def test_autoscaler_scales_in_on_sustained_slack(catalog_with_zoo, tmp_path):
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog, n=3)
    r = router.invoke("hf-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    scaler = AutoScaler(
        router, [ServiceSLO(QosClass.LATENCY, ttft_p99_s=0.5)],
        handoff_dir=str(tmp_path), min_nodes=2, scale_in_after=2,
    )
    assert scaler.tick() is None
    assert scaler.tick() == "scale_in"
    assert len(router.nodes) == 2 and scaler.stats["handoffs_ok"] == 0
    assert any(n.name == r.node for n in router.nodes)
    for _ in range(4):
        assert scaler.tick() != "scale_in"
    assert len(router.nodes) == 2
    assert scaler.node_seconds() > 0
    router.audit()
    router.close()


# ------------------------------------------------------ load-probe cache
def test_load_probe_cache_invalidated_by_lifecycle_edge(catalog_with_zoo):
    catalog, cfg, _ = catalog_with_zoo
    node = NodeScheduler(registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0),
                         load_ttl_s=30.0, device=CPU)
    l1 = node.load()
    assert node.load() is l1
    node.invoke("hf-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    l2 = node.load()
    assert l2 is not l1 and "hf-a" in l2.warm
    node.evict("hf-a")
    assert "hf-a" not in node.load().warm
    node.memory.audit()
    node.close()


def test_dirty_page_is_the_whole_delta(catalog_with_zoo, tmp_path):
    """A page written into the warm tree is what crosses: the delta is that
    page, the destination reads exactly it, and ends with the source's
    state and tokens (serving alone writes nothing, so a handoff of a
    served tree carries no private page)."""
    catalog, cfg, _ = catalog_with_zoo
    router = _router(catalog)
    r = router.invoke("hf-c", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
    src, dst = r.node, _other(router, r.node)
    assert wait_idle_warm(router.node(src), "hf-c")
    tok = router.node(src).instance("hf-c").tree["embed"]["tok"]
    assert tok.nbytes >= DEFAULT_PAGE
    tok.view(-1)[:16] += 0.5
    dirty = router.invoke("hf-c", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
    want = _leaves(router.node(src).warm_state("hf-c"))
    hs = handoff_warm(router, "hf-c", src, dst, handoff_dir=str(tmp_path), cfg=cfg)
    assert hs.ok, hs.reason
    assert hs.delta_bytes == hs.restore_read_bytes == DEFAULT_PAGE
    got = _leaves(router.node(dst).warm_state("hf-c"))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=n)
    r2 = router.invoke("hf-c", PROMPT, max_new_tokens=3, mode="spice", cfg=cfg)
    assert not r2.cold and r2.node == dst
    np.testing.assert_array_equal(r2.tokens, dirty.tokens)
    router.audit()
    router.close()


def test_tree_nbytes_counts_tensors_and_arrays():
    """``warm_state`` hands the handoff numpy leaves; a tree of tensors
    (the warm tree on the device) counts the same bytes."""
    tree = {"a": np.zeros((3, 4), np.float32),
            "b": [torch.zeros(5, dtype=torch.bfloat16), (torch.zeros(2, 2), np.int8(1))]}
    assert _tree_nbytes(tree) == 48 + 10 + 16 + 1


# --------------------------------------------- the two packages side by side
@contextlib.contextmanager
def _bootstraps(cls):
    """[(file name, image bytes)] of every ``cls.from_jif`` (a node building
    a base image from a parent JIF) while the block runs."""
    raw = cls.__dict__["from_jif"]
    seen = []

    def from_jif(klass, path, *args, **kwargs):
        img = raw.__func__(klass, path, *args, **kwargs)
        seen.append((os.path.basename(path), img.nbytes))
        return img

    cls.from_jif = classmethod(from_jif)
    try:
        yield seen
    finally:
        cls.from_jif = raw


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """One function published by each package from the same weights, and
    each package's handoff of it between two nodes (handoff image kept)."""
    cfg = j_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    params = jlm.init_params(cfg, jax.random.PRNGKey(61), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    out = {}
    for name, Catalog, Router, Node, TTL, handoff, Base, p, c, kw in (
        ("jax", JCatalog, JRouter, JNode, JFixedTTL, j_handoff_warm, JBaseImage, params, cfg, {}),
        ("torch", FunctionCatalog, ClusterRouter, NodeScheduler, FixedTTLPolicy, handoff_warm,
         BaseImage, params_from_jax(np_params, CPU), tcfg, {"device": CPU}),
    ):
        d = tmp_path_factory.mktemp(f"twin-{name}")
        catalog = Catalog(**kw)
        catalog.publish("fn", c, p, str(d), warm_ttl_s=3600.0, formats=("jif",))
        router = Router(catalog, [Node(registry=catalog.registry, keepalive=TTL(3600.0), **kw)
                                  for _ in range(2)])
        try:
            r = router.invoke("fn", PROMPT, max_new_tokens=3, mode="spice", cfg=c)
            src = r.node
            state = router.node(src).warm_state("fn")
            dst = next(n.name for n in router.nodes if n.name != src)
            with _bootstraps(Base) as built:
                hs = handoff(router, "fn", src, dst, handoff_dir=str(d), cfg=c, retire=False)
            r2 = router.invoke("fn", PROMPT, max_new_tokens=3, mode="spice", cfg=c)
            jifs = sorted(str(p) for p in d.glob("*.jif") if "handoff" in p.name)
            out[name] = {"tokens": (r.tokens, r2.tokens), "hs": hs, "jif": jifs[-1],
                         "state": flatten_state(state)[0], "warm": r2.cold, "built": built}
        finally:
            router.close()
    return out


def test_handoff_matches_jax(twin):
    j, t = twin["jax"], twin["torch"]
    assert j["hs"].ok and t["hs"].ok
    assert t["hs"].delta_bytes == j["hs"].delta_bytes
    assert t["hs"].total_bytes == j["hs"].total_bytes
    assert not j["warm"] and not t["warm"]  # the next request is warm on the destination
    for a, b in zip(j["tokens"], t["tokens"]):
        np.testing.assert_array_equal(b, a)


def test_handoff_rebuilds_base_like_jax(twin):
    """Where a handoff's restore spends its time: the destination holds no
    base for the handoff image's parent (the function's own published JIF),
    so it builds one from that whole file before it reads the delta.  The
    reference node does the same, once, for the same image; the restore's
    own ``bytes_read`` does not count that read in either package."""
    j, t = twin["jax"], twin["torch"]
    assert j["built"] == t["built"] == [("fn.jif", t["hs"].total_bytes)]
    assert j["hs"].restore_read_bytes == t["hs"].restore_read_bytes == 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_handoff_jif_crosses_packages(twin, writer):
    """One format: the handoff JIF each package wrote restores in the other
    package to the warm state it was taken from, byte for byte."""
    reader = SpiceRestorer(transform=None) if writer == "jax" else JRestorer()
    state, _, _, _ = reader.restore(twin[writer]["jif"])
    reader.iosched.shutdown()
    got = flatten_state(state)[0] if writer == "jax" else [
        (n, np.asarray(a)) for n, a in flatten_state(jax.tree.map(np.asarray, state))[0]]
    want = twin[writer]["state"]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        a = to_numpy(a)
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)
