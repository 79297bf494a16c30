"""Fault tolerance of the port (``repro_torch.ft`` and ``train.loop``) on
the CPU: the counterparts of ``tests/test_ft.py`` and of
``tests/test_deploy.py::test_checkpoint_callback_publishes_versions``, then
both packages together: a checkpoint written by either package resumes in
the other, and the ``examples/train_ft.py`` flow (train, crash, resume,
publish, fine-tune into canaries, gate, rollback) gives the same versions,
routing and decisions in both, from the same weights.

Tolerance on parameters: rtol/atol 2e-5, as ``test_restart_equivalence``.
"""
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import ChunkStore as JChunkStore
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.ft.manager import CheckpointManager as JCheckpointManager
from repro.ft.publish import DeltaPublishCallback as JDeltaPublishCallback
from repro.serve.cluster import ClusterRouter as JRouter
from repro.serve.cluster import FunctionCatalog as JCatalog
from repro.serve.deploy import RolloutController as JRollout
from repro.serve.deploy import TokenHealthGate as JTokenHealthGate
from repro.serve.node import FixedTTLPolicy as JFixedTTL
from repro.serve.node import NodeScheduler as JNode
from repro.train import loop as jloop
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.core import ChunkStore
from repro_torch.core.treeutil import flatten_state
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.ft.health import HealthMonitor, rebalance_shards
from repro_torch.ft.manager import CheckpointManager
from repro_torch.ft.publish import DeltaPublishCallback
from repro_torch.interop import train_state_from_jax, tree_map
from torch_twins import to_numpy
from repro_torch.models import lm
from repro_torch.serve.cluster import ClusterRouter, FunctionCatalog
from repro_torch.serve.deploy import RolloutController, TokenHealthGate
from repro_torch.serve.node import FixedTTLPolicy, NodeScheduler
from repro_torch.train import loop
from repro_torch.train.loop import LoopConfig, SimulatedFailure, train_loop
from repro_torch.train.steps import TrainStepConfig

CPU = "cpu"
ARCH = "qwen1.5-0.5b"
TOL = dict(rtol=2e-5, atol=2e-5)
# f32 compute for the checks across packages: bf16 rounding differs
# between XLA and PyTorch, and Adam's first steps follow the gradients' signs
STEP = dict(remat="dots", num_microbatches=2)
X_STEP = dict(STEP, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH).reduced()
    tcfg = TrainStepConfig(**STEP)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    return cfg, tcfg, data


def _named(tree):
    return {n: to_numpy(a) for n, a in flatten_state(tree)[0]}


def _assert_close(got, want, **tol):
    g, w = _named(got), _named(want)
    assert sorted(g) == sorted(w) and g
    for name in w:
        np.testing.assert_allclose(np.asarray(g[name], np.float32),
                                   np.asarray(w[name], np.float32), err_msg=name, **(tol or TOL))


# ---------------------------------------------------- tests/test_ft.py
def test_restart_equivalence(tmp_path, setup):
    """train 12 steps straight == train 12 steps with a crash at 7 + resume."""
    cfg, tcfg, data = setup
    ref = train_loop(cfg, tcfg, LoopConfig(steps=12, ckpt_every=4), data, device=CPU)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    with pytest.raises(SimulatedFailure):
        train_loop(cfg, tcfg, LoopConfig(steps=12, ckpt_every=4, fail_at_step=7), data, mgr,
                   device=CPU)
    out = train_loop(cfg, tcfg, LoopConfig(steps=12, ckpt_every=4), data, mgr, device=CPU)
    assert len(out["losses"]) == 12 - 4  # resumed after the step-3 checkpoint
    _assert_close(out["params"], ref["params"])
    _assert_close(out["opt"], ref["opt"])


def test_incremental_checkpoints_dedup(tmp_path):
    """Delta checkpoints store only changed chunks (partial-update case:
    fine-tuning a head / frozen layers / sparse optimizer states)."""
    r = np.random.RandomState(0)
    state = {
        "frozen": r.randn(256, 1024).astype(np.float32),
        "head": r.randn(64, 64).astype(np.float32),
        "zeros": np.zeros((64, 1024), np.float32),
    }
    mgr = CheckpointManager(str(tmp_path / "ckpt"), anchor_every=10, async_save=False)
    mgr.save(0, state, blocking=True)
    state2 = dict(state, head=torch.from_numpy(state["head"] + 1.0))  # a tensor leaf too
    mgr.save(1, state2, blocking=True)

    anchor, delta = mgr.history
    assert anchor["anchor"] and not delta["anchor"]
    head_bytes = state["head"].nbytes
    assert delta["bytes_written"] <= head_bytes + 2 * 65536  # page rounding
    assert delta["bytes_written"] < 0.2 * delta["total_bytes"]

    restored, step = mgr.restore(step=1)
    assert step == 1
    np.testing.assert_array_equal(restored["head"], state["head"] + 1.0)
    np.testing.assert_array_equal(restored["frozen"], state["frozen"])
    np.testing.assert_array_equal(restored["zeros"], state["zeros"])


def test_gc_preserves_chain(tmp_path, setup):
    cfg, tcfg, data = setup
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2, anchor_every=3, async_save=False)
    train_loop(cfg, tcfg, LoopConfig(steps=30, ckpt_every=3), data, mgr, device=CPU)
    # survivors must start at an anchor
    assert mgr.history[0]["anchor"]
    state, step = mgr.restore()  # the latest must be restorable post-GC
    assert step == mgr.history[-1]["step"]
    for p in Path(str(tmp_path / "ckpt")).glob("ckpt_*.jif"):
        assert any(h["path"].endswith(p.name) for h in mgr.history)
    man = json.loads((tmp_path / "ckpt" / "MANIFEST.json").read_text())
    assert [h["step"] for h in man] == [h["step"] for h in mgr.history]


def test_async_save(tmp_path, setup):
    cfg, tcfg, data = setup
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    train_loop(cfg, tcfg, LoopConfig(steps=8, ckpt_every=2), data, mgr, device=CPU)
    state, step = mgr.restore()
    assert step == 7
    assert int(np.asarray(state["opt"]["count"])) == 8


def test_async_save_failure_surfaces(tmp_path):
    """A save that fails on the background thread is not silent: the error
    re-raises on the training thread at the next save()/wait(), once."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    state = {"w": torch.ones(8, 8)}

    def failing(step, state_np):
        raise RuntimeError("disk full")

    mgr._save_sync = failing
    mgr.save(0, state)  # spawns the doomed background save
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(1, state)  # the next save surfaces the pending failure
    mgr.wait()  # consumed exactly once: wait() is clean again

    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(2, state)
        mgr.wait()  # ... and wait() alone surfaces it too


def test_checkpoint_callback_failure_fails_the_save(tmp_path):
    """A publish callback raising on the save thread fails the save like a
    write error, but the checkpoint (written before the callbacks fire)
    stays restorable."""

    class BadCb:
        def on_checkpoint(self, manager, step, state, entry):
            raise ValueError("gate exploded")

    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True, callbacks=[BadCb()])
    mgr.save(0, {"w": torch.arange(16, dtype=torch.float32)})
    with pytest.raises(ValueError, match="gate exploded"):
        mgr.wait()
    restored, step = mgr.restore()
    assert step == 0
    np.testing.assert_array_equal(restored["w"], np.arange(16, dtype=np.float32))


def test_health_monitor():
    t = [0.0]
    mon = HealthMonitor(["h0", "h1", "h2"], heartbeat_timeout_s=5, clock=lambda: t[0])
    for _ in range(8):
        mon.heartbeat("h0", 1.0)
        mon.heartbeat("h1", 1.1)
        mon.heartbeat("h2", 3.0)  # straggler
    assert mon.stragglers() == {"h2"}
    t[0] = 10.0
    mon.heartbeat("h0", 1.0)
    assert mon.dead_hosts() == {"h1", "h2"}
    assert mon.live_hosts() == ["h0"]


def test_rebalance_shards():
    out = rebalance_shards(["a", "b", "c"], {"c"}, 10)
    assert sorted(sum(out.values(), [])) == list(range(10))
    assert len(out["c"]) < len(out["a"])


def test_resume_restores_bf16_leaves_as_host_tensors(tmp_path, setup):
    """A restored bf16 leaf is a CPU torch view (the port restores without
    ml_dtypes); the loop copies it onto the device and trains on."""
    cfg, tcfg, data = setup
    params = lm.init_params(cfg, seed=2, dtype=torch.bfloat16, device=CPU)
    from repro_torch.train.optim import adamw_init

    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(0, {"params": params, "opt": adamw_init(params)})
    restored, _ = mgr.restore()
    assert isinstance(restored["params"]["embed"]["tok"], torch.Tensor)
    assert isinstance(restored["params"]["final_norm"], np.ndarray)  # f32 stays numpy
    out = train_loop(cfg, tcfg, LoopConfig(steps=3, ckpt_every=10), data, mgr, device=CPU)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    tok = out["params"]["embed"]["tok"]
    assert tok.dtype == torch.bfloat16 and not torch.equal(tok, params["embed"]["tok"])
    assert torch.equal(restored["params"]["embed"]["tok"], params["embed"]["tok"])  # not written


# ------------------------------- tests/test_deploy.py's checkpoint callback
def _finetune(cfg, params, scale: float):
    """The reference tests' partial fine-tune: the top ~40% of the stacked
    layers and final_norm scaled."""
    params = dict(params, final_norm=params["final_norm"] + scale)

    def bump(a):
        if a.ndim >= 1 and a.shape[0] == cfg.pattern_reps:
            a = a.clone()
            a[int(cfg.pattern_reps * 0.6):] *= 1.0 + scale
        return a

    params["pattern"] = tuple(tree_map(bump, p) for p in params["pattern"])
    return params


def test_checkpoint_callback_publishes_versions(tmp_path):
    cfg = get_config(ARCH).reduced()
    store = ChunkStore(str(tmp_path / "cas"))
    catalog = FunctionCatalog(chunk_store=store, device=CPU)
    base = lm.init_params(cfg, seed=85, device=CPU)
    catalog.publish("dp-f", cfg, base, str(tmp_path), warm_ttl_s=3600.0, formats=("jif",))
    deploy = RolloutController(catalog, seed=3, dirpath=str(tmp_path / "pub"))
    cb = DeltaPublishCallback(
        deploy, "dp-f", cfg, every=2, canary_fraction=0.5,
        extract=lambda s: s["params"],
    )
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False, callbacks=[cb])
    for step in range(4):  # 4 saves, every=2 -> 2 published versions
        state = {"params": _finetune(cfg, base, 0.001 * (step + 1)),
                 "opt": {"count": torch.tensor(step, dtype=torch.int32)}}
        mgr.save(step, state, blocking=True)
    assert [r.step for r in cb.published] == [0, 2]
    assert len(deploy.versions("dp-f")) == 3  # v1 + the two publishes
    # latest publish is the canary (auto_canary), superseding the first
    assert deploy.canary("dp-f").version == cb.published[-1].version
    assert cb.published[0].status == "rejected"
    deploy.rollback("dp-f")
    assert deploy.gc_retired("dp-f") != []
    store.audit()


# ------------------------------------------------ across the two packages
def _j_setup():
    cfg = j_get_config(ARCH).reduced()
    data = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    return cfg, jsteps.TrainStepConfig(**X_STEP), data


@pytest.fixture
def jax_init(monkeypatch):
    """The port's loop starts from the JAX initializer's weights for the
    same seed (carried across with ``train_state_from_jax``), so both
    packages train the same model."""

    def init(cfg, seed=0, dtype=torch.float32, device=None):
        jp, jo = jsteps.init_train_state(j_get_config(ARCH).reduced(), jax.random.PRNGKey(seed))
        return train_state_from_jax(jax.tree.map(np.asarray, jp),
                                    jax.tree.map(np.asarray, jo), device)

    monkeypatch.setattr(loop, "init_train_state", init)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, setup):
    cfg, _, data = setup
    jcfg, jtcfg, jdata = _j_setup()
    ref = jloop.train_loop(jcfg, jtcfg, jloop.LoopConfig(steps=6, ckpt_every=3), jdata)
    d = str(tmp_path / "ckpt")
    with pytest.raises(jloop.SimulatedFailure):
        jloop.train_loop(jcfg, jtcfg, jloop.LoopConfig(steps=6, ckpt_every=3, fail_at_step=4),
                         jdata, JCheckpointManager(d, async_save=False))
    mgr = CheckpointManager(d, async_save=False)
    assert mgr.latest_step() == 2
    out = train_loop(cfg, TrainStepConfig(**X_STEP), LoopConfig(steps=6, ckpt_every=3), data,
                     mgr, device=CPU)
    assert len(out["losses"]) == 3
    _assert_close(out["params"], jax.tree.map(np.asarray, ref["params"]))
    assert int(out["opt"]["count"]) == int(ref["opt"]["count"]) == 6


def test_port_checkpoint_resumes_in_jax(tmp_path, setup):
    cfg, _, data = setup
    jcfg, jtcfg, jdata = _j_setup()
    tcfg = TrainStepConfig(**X_STEP)
    ref = train_loop(cfg, tcfg, LoopConfig(steps=6, ckpt_every=3), data, device=CPU)
    d = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedFailure):
        train_loop(cfg, tcfg, LoopConfig(steps=6, ckpt_every=3, fail_at_step=4), data,
                   CheckpointManager(d, async_save=False), device=CPU)
    mgr = JCheckpointManager(d, async_save=False)
    assert mgr.latest_step() == 2
    out = jloop.train_loop(jcfg, jtcfg, jloop.LoopConfig(steps=6, ckpt_every=3), jdata, mgr)
    assert len(out["losses"]) == 3
    _assert_close(jax.tree.map(np.asarray, out["params"]), ref["params"])
    assert int(out["opt"]["count"]) == int(ref["opt"]["count"]) == 6


PROMPT = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)


def _train_ft_flow(pk, cfg, tcfg, data, d):
    """``examples/train_ft.py`` at a reduced size, over one package's
    classes (``pk``): train with a crash and a resume, publish, fine-tune
    with every checkpoint published as a canary, serve, gate, roll back.
    Returns what the flow decided and served."""
    mgr = pk.Manager(f"{d}/ckpt", keep=3, anchor_every=2)
    try:
        pk.train_loop(cfg, tcfg, pk.LoopConfig(steps=6, ckpt_every=2, fail_at_step=3), data, mgr)
    except pk.SimulatedFailure:
        pass
    mgr.wait()
    resumed_from = mgr.latest_step()
    out = pk.train_loop(cfg, tcfg, pk.LoopConfig(steps=6, ckpt_every=2), data, mgr)

    store = pk.ChunkStore(f"{d}/cas")
    catalog = pk.Catalog(store)
    catalog.publish("assistant", cfg, out["params"], d, warm_ttl_s=3600.0, formats=("jif",))
    router = pk.Router(catalog, [pk.Node(catalog)])
    try:
        deploy = pk.Rollout(catalog, seed=0, dirpath=d).attach(router)
        base_params = dict(out["params"])

        def merge(state):
            merged = dict(base_params)
            merged["final_norm"] = state["params"]["final_norm"]
            return merged

        cb = pk.Publish(deploy, "assistant", cfg, every=1, canary_fraction=0.5, extract=merge)
        ft_mgr = pk.Manager(f"{d}/ft", async_save=True, callbacks=[cb])
        pk.train_loop(cfg, tcfg, pk.LoopConfig(steps=2, ckpt_every=1, seed=1), data, ft_mgr)
        canary = deploy.canary("assistant")
        served = [router.invoke("assistant", PROMPT, max_new_tokens=2, mode="spice", cfg=cfg)
                  for _ in range(6)]
        ok = deploy.evaluate_canary("assistant", PROMPT, gate=pk.Gate(cfg.vocab_size),
                                    n_probes=2, max_new_tokens=2, cfg=cfg)
        stable = deploy.current("assistant").version
        back = deploy.rollback("assistant")
        retired = deploy.gc_retired("assistant")
        store.audit()
    finally:
        router.close()
    return {
        "resumed_from": resumed_from,
        "published": [(r.name, r.step, r.version, r.private_bytes, r.total_bytes)
                      for r in cb.published],
        "statuses": [r.status for r in cb.published],
        "canary": canary.name,
        "served": [r.function for r in served],
        "tokens": [np.asarray(r.tokens).tolist() for r in served],
        "gate": ok,
        "stable": stable,
        "rolled_back_to": back.version,
        "retired": retired,
        "params": out["params"],
    }


def test_train_ft_flow_matches_jax(tmp_path, setup, jax_init):
    cfg, _, data = setup
    jcfg, jtcfg, jdata = _j_setup()
    jax_pk = dict(
        Manager=JCheckpointManager, train_loop=jloop.train_loop, LoopConfig=jloop.LoopConfig,
        SimulatedFailure=jloop.SimulatedFailure, ChunkStore=JChunkStore,
        Catalog=lambda store: JCatalog(chunk_store=store),
        Router=JRouter, Node=lambda cat: JNode(registry=cat.registry,
                                               keepalive=JFixedTTL(3600.0)),
        Rollout=JRollout, Publish=JDeltaPublishCallback, Gate=JTokenHealthGate,
    )
    port_pk = dict(
        Manager=CheckpointManager,
        train_loop=lambda *a, **kw: train_loop(*a, device=CPU, **kw),
        LoopConfig=LoopConfig, SimulatedFailure=SimulatedFailure, ChunkStore=ChunkStore,
        Catalog=lambda store: FunctionCatalog(chunk_store=store, device=CPU),
        Router=ClusterRouter, Node=lambda cat: NodeScheduler(
            registry=cat.registry, keepalive=FixedTTLPolicy(3600.0), device=CPU),
        Rollout=RolloutController, Publish=DeltaPublishCallback, Gate=TokenHealthGate,
    )
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _train_ft_flow(SimpleNamespace(**jax_pk), jcfg, jtcfg, jdata, str(tmp_path / "jax"))
    got = _train_ft_flow(SimpleNamespace(**port_pk), cfg, TrainStepConfig(**X_STEP), data,
                         str(tmp_path / "port"))
    _assert_close(got.pop("params"), jax.tree.map(np.asarray, want.pop("params")))
    assert got == want
    assert want["resumed_from"] == 1 and [p[1] for p in want["published"]] == [0, 1]
    # v3 superseded v2 as the canary; the split served it beside the stable v1
    assert want["canary"] == "assistant@v3"
    assert set(want["served"]) == {"assistant", "assistant@v3"}
