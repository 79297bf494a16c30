"""The port's deployment pipeline (``repro_torch.serve.deploy``) against the
JAX package's: six of the seven cases of ``tests/test_deploy.py`` on the
port's nodes (CPU, reduced qwen1.5-0.5b), then both packages on the same
seed-made weights: the same version bytes, the same canary assignment and
the same tokens for the version each request was routed to.

``test_checkpoint_callback_publishes_versions`` drives the checkpoint
manager and lives with the port's fault-tolerance tests
(``tests/test_torch_ft.py``).
"""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.serve.cluster import ClusterRouter as JRouter
from repro.serve.cluster import FunctionCatalog as JCatalog
from repro.serve.deploy import RolloutController as JRollout
from repro.serve.node import FixedTTLPolicy as JFixedTTL
from repro.serve.node import NodeScheduler as JNode
from repro_torch.configs import get_config
from repro_torch.core import ChunkStore, SpiceRestorer
from repro_torch.core.treeutil import flatten_state
from repro_torch.interop import params_from_jax, tree_map
from torch_twins import to_numpy
from repro_torch.models import lm
from repro_torch.serve.cluster import ClusterRouter, FunctionCatalog
from repro_torch.serve.deploy import (
    ColocatedTrainer,
    RolloutController,
    TokenHealthGate,
)
from repro_torch.serve.instance import layerwise_state
from repro_torch.serve.invocation import AdmissionController, Invocation, Overloaded, QosClass
from repro_torch.serve.node import FixedTTLPolicy, NodeScheduler

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)
CPU = "cpu"


def _finetune(cfg, params, scale: float):
    """The reference tests' partial fine-tune: the top ~40% of the stacked
    layers and final_norm scaled, the rest identical to the parent.  Works
    on torch tensors and on numpy arrays."""
    params = dict(params)
    params["pattern"] = list(params["pattern"])
    params["final_norm"] = params["final_norm"] + scale

    def bump(a):
        if a.ndim >= 1 and a.shape[0] == cfg.pattern_reps:
            cut = int(cfg.pattern_reps * 0.6)
            a = a.copy() if isinstance(a, np.ndarray) else a.clone()
            a[cut:] = a[cut:] * (1.0 + scale)
        return a

    for pi in range(len(cfg.pattern)):
        params["pattern"][pi] = tree_map(bump, params["pattern"][pi])
    return params


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    cfg = get_config(ARCH).reduced()
    store = ChunkStore(str(d / "cas"))
    catalog = FunctionCatalog(chunk_store=store, device=CPU)
    zoo = {}
    for i, fname in enumerate(["dp-a", "dp-b", "dp-c", "dp-d", "dp-e"]):
        params = lm.init_params(cfg, seed=80 + i, device=CPU)
        catalog.publish(fname, cfg, params, str(d), warm_ttl_s=3600.0, formats=("jif",))
        zoo[fname] = params
    return catalog, cfg, str(d), zoo, store


def _router(catalog, n=2):
    nodes = [
        NodeScheduler(registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0), device=CPU)
        for _ in range(n)
    ]
    return ClusterRouter(catalog, nodes)


def _assert_same_state(want, got):
    """Leaf by leaf, matched by name, bit for bit."""
    w, g = dict(flatten_state(want)[0]), dict(flatten_state(got)[0])
    assert sorted(w) == sorted(g) and w
    for name in w:
        np.testing.assert_array_equal(to_numpy(g[name]), to_numpy(w[name]), err_msg=name)


# -------------------------------------------------- CAS chunk sharing
def test_versioned_publish_shares_base_chunks(deployed, tmp_path):
    catalog, cfg, d, zoo, store = deployed
    deploy = RolloutController(catalog, seed=7, dirpath=str(tmp_path))
    deploy.track("dp-a")

    before = store.audit()
    rec = deploy.publish_version("dp-a", cfg, _finetune(cfg, zoo["dp-a"], 0.01), step=1)
    after = store.audit()

    assert 0 < rec.private_bytes < 0.6 * rec.total_bytes
    v1 = deploy.current("dp-a")
    assert rec.private_bytes < 0.6 * v1.total_bytes
    assert 0 < after["chunks"] - before["chunks"]
    assert catalog.registry.get(rec.name).jif_path == rec.jif_path
    r = SpiceRestorer(transform=None)
    state, _, _, _ = r.restore(rec.jif_path)
    r.iosched.shutdown()
    _assert_same_state(layerwise_state(cfg, _finetune(cfg, zoo["dp-a"], 0.01)), state)


# -------------------------------------------- deterministic canary split
def test_canary_fraction_deterministic_under_seed(deployed, tmp_path):
    catalog, cfg, d, zoo, store = deployed
    deploy = RolloutController(catalog, seed=123, dirpath=str(tmp_path))
    deploy.track("dp-b")
    rec = deploy.publish_version("dp-b", cfg, _finetune(cfg, zoo["dp-b"], 0.02))

    deploy.begin_canary("dp-b", rec.version, fraction=0.3)
    seq1 = [deploy.resolve("dp-b") for _ in range(400)]
    deploy.begin_canary("dp-b", rec.version, fraction=0.3)
    seq2 = [deploy.resolve("dp-b") for _ in range(400)]
    assert seq1 == seq2

    frac = sum(s == rec.name for s in seq1) / len(seq1)
    assert 0.2 < frac < 0.4
    assert {s for s in seq1} == {"dp-b", rec.name}

    other = RolloutController(catalog, seed=124, dirpath=str(tmp_path))
    other.track("dp-b")
    other.lineage("dp-b").records[rec.version] = rec
    other.begin_canary("dp-b", rec.version, fraction=0.3)
    assert [other.resolve("dp-b") for _ in range(400)] != seq1

    assert deploy.resolve(rec.name) == rec.name
    assert deploy.resolve("unknown-fn") == "unknown-fn"
    deploy.rollback("dp-b")


# ------------------------------------- promote / rollback byte-identity
def test_promote_rollback_byte_identity(deployed, tmp_path):
    catalog, cfg, d, zoo, store = deployed
    deploy = RolloutController(catalog, seed=5, dirpath=str(tmp_path))
    deploy.track("dp-c")
    tuned = _finetune(cfg, zoo["dp-c"], 0.03)
    rec = deploy.publish_version("dp-c", cfg, tuned, step=2)
    deploy.begin_canary("dp-c", rec.version, fraction=0.5)

    publishes_before = catalog.stats["publishes"]
    deploy.promote("dp-c")
    assert deploy.current("dp-c").version == rec.version
    assert deploy.canary("dp-c") is None
    assert deploy.resolve("dp-c") == rec.name
    r = SpiceRestorer(transform=None)
    state, _, _, _ = r.restore(deploy.current("dp-c").jif_path)
    _assert_same_state(layerwise_state(cfg, tuned), state)

    back = deploy.rollback("dp-c")
    assert back.version == 1 and deploy.resolve("dp-c") == "dp-c"
    assert catalog.stats["publishes"] == publishes_before
    state, _, _, _ = r.restore(back.jif_path)
    r.iosched.shutdown()
    _assert_same_state(layerwise_state(cfg, zoo["dp-c"]), state)
    store.audit()


# --------------------------------------------------- retired-version GC
def test_retired_version_gc_leaves_cas_clean(deployed, tmp_path):
    catalog, cfg, d, zoo, store = deployed
    deploy = RolloutController(catalog, seed=9, dirpath=str(tmp_path))
    deploy.track("dp-d")
    before = store.audit()
    rec = deploy.publish_version("dp-d", cfg, _finetune(cfg, zoo["dp-d"], 0.04))
    deploy.begin_canary("dp-d", rec.version, fraction=0.25)
    deploy.rollback("dp-d")

    assert rec.name in catalog.registry
    retired = deploy.gc_retired("dp-d")
    assert retired == [rec.name]
    assert rec.name not in catalog.registry
    assert not os.path.exists(rec.jif_path)
    after = store.audit()
    assert after["chunks"] == before["chunks"]
    assert after["refs"] == before["refs"]

    with pytest.raises(ValueError):
        deploy.retire("dp-d", 1)


# ---------------------------------------- quality gate end-to-end rollout
def test_canary_gate_promotes_over_router(deployed, tmp_path):
    catalog, cfg, d, zoo, store = deployed
    router = _router(catalog)
    deploy = RolloutController(catalog, seed=11, dirpath=str(tmp_path)).attach(router)
    deploy.track("dp-e")
    rec = deploy.publish_version("dp-e", cfg, _finetune(cfg, zoo["dp-e"], 0.05))
    deploy.begin_canary("dp-e", rec.version, fraction=0.5)

    results = [
        router.invoke("dp-e", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
        for _ in range(8)
    ]
    assert {r.function for r in results} == {"dp-e", rec.name}

    ok = deploy.evaluate_canary(
        "dp-e", PROMPT, gate=TokenHealthGate(vocab_size=cfg.vocab_size),
        n_probes=2, max_new_tokens=2, cfg=cfg,
    )
    assert ok and deploy.current("dp-e").version == rec.version

    rec3 = deploy.publish_version("dp-e", cfg, _finetune(cfg, zoo["dp-e"], 0.06))
    deploy.begin_canary("dp-e", rec3.version, fraction=0.5)

    class AlwaysBad:
        def evaluate(self, results):
            return False

    ok = deploy.evaluate_canary("dp-e", PROMPT, gate=AlwaysBad(), n_probes=1,
                                max_new_tokens=2, cfg=cfg)
    assert not ok
    assert deploy.current("dp-e").version == rec.version
    assert deploy.canary("dp-e") is None
    router.audit()
    router.close()


# ------------------------------------------- serve/train colocation QoS
def test_colocated_batch_training_never_starves_latency(deployed):
    catalog, cfg, d, zoo, store = deployed
    node = NodeScheduler(
        registry=catalog.registry, keepalive=FixedTTLPolicy(3600.0), max_workers=2,
        admission=AdmissionController(max_batch_inflight=1), device=CPU,
    )
    r = node.invoke("dp-c", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
    assert r.cold

    blocker = node.submit_invocation(Invocation(
        function="train:ft", qos=QosClass.BATCH, payload=lambda: time.sleep(0.3),
    ))
    with pytest.raises(Overloaded):
        node.submit_invocation(Invocation(
            function="train:ft", qos=QosClass.BATCH, payload=lambda: time.sleep(0.3),
        ))

    trainer = ColocatedTrainer(node, job_name="ft")
    stop = threading.Event()

    def grind():
        while not stop.is_set():
            trainer.step(time.sleep, 0.05)

    t = threading.Thread(target=grind, daemon=True)
    t.start()
    try:
        for _ in range(5):
            lr = node.submit_invocation(Invocation(
                function="dp-c", prompt=PROMPT, max_new_tokens=2,
                mode="spice", cfg=cfg, qos=QosClass.LATENCY,
            )).result(10.0)
            assert not lr.cold
            assert lr.queue_wait_s < 0.25
    finally:
        stop.set()
        t.join(5.0)
    blocker.result(10.0)
    assert node.stats["payload_runs"] >= 2
    assert trainer.stats["steps"] >= 1
    node.memory.audit()
    node.close()


# --------------------------------------------- the two packages side by side
def test_rollout_matches_jax(tmp_path):
    """The same lineage in both packages: v1 from the same seed-made
    weights, v2 the same fine-tune.  v2 costs the same private bytes, a
    0.5 canary sends the same requests to v2, each request's tokens are the
    same, and the split is the one ``chip_smoke.canary_split`` computes
    from the controller's definition."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = j_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    params = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(85), jnp.float32))
    tuned = _finetune(cfg, params, 0.05)
    runs = {}
    for name, Catalog, Router, Node, TTL, Rollout, v1, v2, c, kw in (
        ("jax", JCatalog, JRouter, JNode, JFixedTTL, JRollout, params, tuned, cfg, {}),
        ("torch", FunctionCatalog, ClusterRouter, NodeScheduler, FixedTTLPolicy,
         RolloutController, params_from_jax(params, CPU), params_from_jax(tuned, CPU), tcfg,
         {"device": CPU}),
    ):
        d = tmp_path / name
        catalog = Catalog(**kw)
        catalog.publish("fn", c, v1, str(d), warm_ttl_s=3600.0, formats=("jif",))
        router = Router(catalog, [Node(registry=catalog.registry, keepalive=TTL(3600.0), **kw)])
        try:
            deploy = Rollout(catalog, seed=3, dirpath=str(d)).attach(router)
            deploy.track("fn")
            rec = deploy.publish_version("fn", c, v2)
            deploy.begin_canary("fn", rec.version, fraction=0.5)
            results = [router.invoke("fn", PROMPT, max_new_tokens=3, mode="spice", cfg=c)
                       for _ in range(8)]
            runs[name] = (rec.private_bytes, rec.total_bytes,
                          [r.function == rec.name for r in results],
                          [np.asarray(r.tokens) for r in results])
        finally:
            router.close()
    (jp, jt, js, jtok), (tp, tt, ts, ttok) = runs["jax"], runs["torch"]
    assert (tp, tt) == (jp, jt) and 0 < tp < tt
    assert ts == js == chip_smoke.canary_split(np, 3, 2, "fn", 0.5, 8)
    assert any(ts) and not all(ts)
    for a, b in zip(jtok, ttok):
        np.testing.assert_array_equal(b, a)
