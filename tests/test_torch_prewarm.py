"""The port's warmth policy engine (``repro_torch.serve.prewarm``) against
the JAX package's: the cases of ``tests/test_prewarm.py`` on the port's
nodes (CPU, reduced qwen1.5-0.5b), then the two packages' nodes on the same
seed-made weights and the same arrival times, which must give the same
cold / warm / prewarm sequence and the same tokens.  The joining case runs
on the card too (``gpu``), where the speculative restore installs through
the node's upload stream on its own thread."""
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import lm
from repro_torch.serve import engine as tengine
from repro_torch.serve.cluster import ClusterRouter, FunctionCatalog
from repro_torch.serve.instance import InstanceState
from repro_torch.serve.invocation import EVT_RESTORING, Invocation, QosClass
from repro_torch.serve.node import KeepAlivePolicy, NodeScheduler
from repro_torch.serve.prewarm import ArrivalTracker, PrewarmEngine, PrewarmPolicy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card's prewarm schedule, rehearsed here)

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[2, 7, 1, 8, 2, 8]], dtype=np.int32)
CPU = "cpu"


def _publish_zoo(d, device):
    cfg = get_config(ARCH).reduced()
    catalog = FunctionCatalog(device=device)
    for i, fname in enumerate(["pw-a", "pw-b", "pw-c"]):
        params = lm.init_params(cfg, seed=80 + i, device=device)
        catalog.publish(fname, cfg, params, str(d), warm_ttl_s=0.0, formats=("jif",))
    return catalog, cfg


@pytest.fixture(scope="module")
def catalog_with_fns(tmp_path_factory):
    return _publish_zoo(tmp_path_factory.mktemp("pwzoo"), CPU)


# ------------------------------------------------------------ ArrivalTracker
def test_tracker_needs_two_arrivals_for_a_gap():
    tr = ArrivalTracker()
    tr.record("f", now=100.0)
    assert tr.observations("f") == 0
    assert tr.gap_quantile("f", 0.5) is None
    assert tr.predict_eta("f", now=101.0) is None
    assert tr.observations("missing") == 0


def test_tracker_quantiles_and_eta_for_periodic_traffic():
    tr = ArrivalTracker()
    for t in (0.0, 0.4, 0.8, 1.2):
        tr.record("f", now=t)
    assert tr.observations("f") == 3
    # all gaps land in one bucket whose max is the exact period
    assert tr.gap_quantile("f", 0.5) == pytest.approx(0.4)
    assert tr.gap_quantile("f", 0.9) == pytest.approx(0.4)
    # predicted next arrival = last + median gap
    assert tr.predict_eta("f", now=1.3) == pytest.approx(0.3)
    assert tr.predict_eta("f", now=2.0) == pytest.approx(-0.4)  # overdue


def test_tracker_quantiles_are_monotonic_with_mixed_gaps():
    tr = ArrivalTracker()
    t = 0.0
    tr.record("f", now=t)
    for gap in (0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 3.0):
        t += gap
        tr.record("f", now=t)
    q50, q95 = tr.gap_quantile("f", 0.5), tr.gap_quantile("f", 0.95)
    assert q50 <= q95
    assert q50 == pytest.approx(0.1)
    assert q95 == pytest.approx(3.0)
    assert tr.observations("f") == 8
    assert "f" in tr.snapshot()


def test_tracker_min_observations_gate():
    tr = ArrivalTracker()
    for t in (0.0, 0.5):
        tr.record("f", now=t)
    assert tr.gap_quantile("f", 0.5, min_observations=2) is None
    assert tr.predict_eta("f", now=0.6, min_observations=2) is None
    tr.record("f", now=1.0)
    assert tr.gap_quantile("f", 0.5, min_observations=2) == pytest.approx(0.5)


# ----------------------------------------------------------- adaptive TTLs
def _spec(name, warm_ttl_s=7.0):
    return types.SimpleNamespace(name=name, warm_ttl_s=warm_ttl_s)


def test_ttl_for_head_tail_and_fallback():
    tr = ArrivalTracker()
    for t in (0.0, 0.2, 0.4, 0.6):  # head: periodic, short gaps
        tr.record("head", now=t)
    for t in (0.0, 100.0, 200.0, 300.0):  # long tail: huge gaps
        tr.record("tail", now=t)
    pol = PrewarmPolicy(tr, max_ttl_s=30.0, tail_ttl_s=0.5, ttl_margin=1.25,
                        min_observations=2)
    assert pol.ttl_for(_spec("head")) == pytest.approx(0.25)
    assert pol.ttl_for(_spec("tail")) == 0.5
    assert pol.ttl_for(_spec("unknown")) == 7.0
    pol2 = PrewarmPolicy(tr, default_ttl_s=1.5, min_observations=2)
    assert pol2.ttl_for(_spec("unknown")) == 1.5


# ------------------------------------------------------- eviction contracts
class _Inst:
    def __init__(self, name, last_used, nbytes):
        self.spec = types.SimpleNamespace(name=name)
        self.last_used = last_used
        self.restore_stats = None
        self.memory_bytes = nbytes


def test_default_victims_honors_need_evict_lru_first():
    pol = KeepAlivePolicy()
    warm = [_Inst("a", 3.0, 1), _Inst("b", 1.0, 1), _Inst("c", 2.0, 1)]
    got = pol.victims(warm, need_evict=2)
    assert [i.spec.name for i in got] == ["b", "c"]
    assert pol.victims(warm, need_evict=0) == []
    assert len(pol.victims(warm, need_evict=99)) == 3


def test_cost_aware_victims_rank_cheap_and_far_first():
    now = time.monotonic()
    tr = ArrivalTracker()
    tr.record("soon", now=now - 2.0)
    tr.record("soon", now=now - 1.0)
    tr.record("later", now=now - 45.0)
    tr.record("later", now=now - 15.0)
    pol = PrewarmPolicy(tr, min_observations=1, unknown_eta_s=60.0,
                        cost_fn=lambda i: i.memory_bytes)
    soon = _Inst("soon", 5.0, 1 << 20)
    later = _Inst("later", 1.0, 1 << 20)
    pricey = _Inst("pricey-later", 2.0, 64 << 20)
    got = pol.victims([soon, later, pricey], need_evict=2)
    assert [i.spec.name for i in got] == ["later", "pricey-later"]
    assert pol.victims([soon, later, pricey], need_evict=0) == []


# ------------------------------------------------- speculation end-to-end
def _warm_history(engine, fname, period=0.2, n=3):
    now = time.monotonic()
    for k in range(n, 0, -1):
        engine.on_arrival(fname, now=now - period * (k - 1))


def _node(catalog, engine_or_tracker, device=CPU, **kw):
    tracker = getattr(engine_or_tracker, "tracker", engine_or_tracker)
    return NodeScheduler(
        registry=catalog.registry, device=device,
        keepalive=PrewarmPolicy(tracker, default_ttl_s=30.0, min_observations=2), **kw,
    )


def test_speculative_restore_promotes_warm_without_generation(catalog_with_fns):
    catalog, cfg = catalog_with_fns
    tracker = ArrivalTracker()
    engine = PrewarmEngine(tracker, horizon_s=5.0, interval_s=None, min_observations=2)
    node = _node(catalog, tracker)
    router = ClusterRouter(catalog, [node], prewarm=engine)
    try:
        r0 = router.invoke("pw-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert r0.cold
        node.evict("pw-a")
        _warm_history(engine, "pw-a")
        assert engine.tick() == 1
        assert engine.drain(30.0)
        inst = node.instance("pw-a")
        assert inst.state is InstanceState.WARM
        assert node.stats["speculative_restores"] == 1
        assert node.stats["cold_starts"] == 1
        assert engine.stats["speculative_ok"] == 1
        r1 = router.invoke("pw-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert not r1.cold
        np.testing.assert_array_equal(r0.tokens, r1.tokens)
    finally:
        router.close()


def test_engine_suppresses_resident_and_unknown_functions(catalog_with_fns):
    catalog, cfg = catalog_with_fns
    engine = PrewarmEngine(horizon_s=5.0, interval_s=None, min_observations=2)
    node = _node(catalog, engine)
    router = ClusterRouter(catalog, [node], prewarm=engine)
    try:
        router.invoke("pw-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        _warm_history(engine, "pw-a")
        _warm_history(engine, "ghost-fn")
        assert engine.tick() == 0
        assert engine.stats["suppressed_resident"] == 1
        assert node.stats["speculative_restores"] == 0
    finally:
        router.close()


@pytest.fixture
def join_zoo(request, catalog_with_fns, tmp_path_factory):
    """The catalog and node settings of the joining case: on the CPU the
    module's catalog and the default install; on the card a catalog of its
    own and the fused install (the upload stream)."""
    if request.param == CPU:
        return catalog_with_fns, CPU, {}
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused install runs the CUDA kernels")
    return _publish_zoo(tmp_path_factory.mktemp("pwzoo-gpu"), "cuda"), "cuda", {"install": "fused"}


@pytest.mark.parametrize("join_zoo", [CPU, pytest.param("cuda", marks=pytest.mark.gpu)],
                         indirect=True)
def test_real_invocation_joins_inflight_speculative_restore(join_zoo):
    """A real arrival mid-speculation rides the SAME restore: one restore
    owner (the speculation), the real result marked joined, its timeline
    showing the RESTORING ride, and its tokens those of a plain restore:
    the joiner reads the tensors only once they have landed on the node's
    device."""
    (catalog, cfg), device, kw = join_zoo
    engine = PrewarmEngine(horizon_s=5.0, interval_s=None, min_observations=2,
                           simulate_read_bw=4e6)  # slow restore: ~1 s window
    node = _node(catalog, engine, device=device, **kw)
    router = ClusterRouter(catalog, [node], prewarm=engine)
    try:
        r0 = router.invoke("pw-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        node.evict("pw-b")
        _warm_history(engine, "pw-b")
        assert engine.tick() == 1
        inst = node.instance("pw-b")
        deadline = time.monotonic() + 10.0
        while (inst.state is not InstanceState.RESTORING
               and time.monotonic() < deadline):
            time.sleep(0.002)
        assert inst.state is InstanceState.RESTORING
        h = router.submit_invocation(Invocation(
            function="pw-b", prompt=PROMPT, max_new_tokens=2, mode="spice",
            cfg=cfg, qos=QosClass.LATENCY,
        ))
        r = h.result(60.0)
        assert r.joined and r.cold
        assert h.event_ts(EVT_RESTORING) is not None
        np.testing.assert_array_equal(r.tokens, r0.tokens)
        assert engine.drain(30.0)
        assert node.stats["speculative_restores"] == 1
        assert node.stats["cold_starts"] == 1
    finally:
        router.close()


def test_redundant_speculation_against_warm_instance_is_a_noop(catalog_with_fns):
    catalog, cfg = catalog_with_fns
    node = _node(catalog, ArrivalTracker())
    router = ClusterRouter(catalog, [node])
    try:
        router.invoke("pw-a", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        h = router.submit_invocation(Invocation(
            function="pw-a", prompt=None, max_new_tokens=0, mode="spice",
            qos=QosClass.BATCH, prewarm=True,
        ))
        r = h.result(30.0)
        assert r.mode == "prewarm" and not r.cold
        assert node.stats["prewarm_redundant"] == 1
        assert node.stats["speculative_restores"] == 0
    finally:
        router.close()


# ------------------------------------------------------- reaper + reclaim
def test_reaper_honors_adaptive_ttls(catalog_with_fns):
    catalog, cfg = catalog_with_fns
    tracker = ArrivalTracker()
    node = NodeScheduler(
        registry=catalog.registry, device=CPU,
        keepalive=PrewarmPolicy(tracker, min_observations=1, max_ttl_s=30.0),
    )
    router = ClusterRouter(catalog, [node])
    try:
        now = time.monotonic()
        for t in (now - 0.3, now - 0.15, now):
            tracker.record("pw-b", now=t)
        for t in (now - 20.0, now - 10.0, now):
            tracker.record("pw-c", now=t)
        router.invoke("pw-b", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        router.invoke("pw-c", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        assert node.instance("pw-b").state is InstanceState.WARM
        time.sleep(0.4)  # past pw-b's adaptive TTL, well inside pw-c's
        assert node.reap_expired() == 1
        assert node.instance("pw-b").state is InstanceState.EVICTED
        assert node.instance("pw-c").state is InstanceState.WARM
    finally:
        router.close()


def test_mispredicted_speculation_yields_to_reclaim_ladder(catalog_with_fns):
    catalog, cfg = catalog_with_fns
    engine = PrewarmEngine(horizon_s=5.0, interval_s=None, min_observations=2)
    node = NodeScheduler(
        registry=catalog.registry, device=CPU,
        keepalive=PrewarmPolicy(engine.tracker, default_ttl_s=300.0, min_observations=2),
    )
    router = ClusterRouter(catalog, [node], prewarm=engine)
    try:
        router.invoke("pw-c", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        node.evict("pw-c")
        _warm_history(engine, "pw-c")
        assert engine.tick() == 1
        assert engine.drain(30.0)
        inst = node.instance("pw-c")
        assert inst.state is InstanceState.WARM
        freed = node.memory.reclaim(node.memory.held_bytes() + 1)
        assert freed > 0
        assert inst.state is InstanceState.EVICTED
        assert node.stats["lru_evictions"] >= 1
        node.memory.audit()
    finally:
        router.close()


# --------------------------------------------- the two packages side by side
def test_prewarm_schedule_matches_jax_node(tmp_path):
    """The schedule ``chip_smoke.py`` drives on the card, on the CPU with
    the reduced config: both packages' ``ServerlessNode``\\ s, built as the
    serving CLI builds them, give the expected mode sequence, the same
    evictions by the keep-alive policy, the same node counts and the same
    tokens on the same weights."""
    cfg = j_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    params = jlm.init_params(cfg, jax.random.PRNGKey(7), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    runs = {}
    for name, mod, p, c, kw in (
        ("jax", jengine, params, cfg, {}),
        ("torch", tengine, params_from_jax(np_params, CPU), tcfg, {"device": CPU}),
    ):
        policy, eng = chip_smoke.prewarm_parts(mod.ArrivalTracker, mod.PrewarmPolicy,
                                               mod.PrewarmEngine)
        node = mod.ServerlessNode(keepalive=policy, prewarm=eng, **kw)
        try:
            node.publish("fn", c, p, str(tmp_path / name), formats=("jif",))
            events, reaped = chip_smoke.prewarm_schedule(node, eng, "fn", PROMPT, 4, c)
            st = node.scheduler.stats
            runs[name] = ([k for k, _ in events],
                          [np.asarray(r.tokens) for k, r in events if k != "prewarm"],
                          (st["cold_starts"], st["speculative_restores"], st["prewarm_redundant"],
                           st["ttl_evictions"]), reaped)
        finally:
            node.close()
    (jk, jt, js, jr), (tk, tt, ts, tr) = runs["jax"], runs["torch"]
    assert jk == tk == chip_smoke.PREWARM_MODES
    assert js == ts == (3, 3, 0, len(chip_smoke.PREWARM_REAPED))
    assert jr == tr == chip_smoke.PREWARM_REAPED  # the policy, not the caller, evicts
    assert len(jt) == len(tt) == chip_smoke.PREWARM_ARRIVALS
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b, a)
