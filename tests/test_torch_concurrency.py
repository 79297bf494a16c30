"""Concurrent invocations on the port's fused node against the JAX
package's: the regimes of the reference benchmark ``benchmarks/
concurrency.py`` (``_multi_tenant``: four fine-tunes of one base
cold-started at once, under ``spice`` and ``faasnap_star``; ``_burst``: one
cold function's invocations riding one restore), a cancel mid-restore on
the multi-tenant node, and the cancel-and-deadlines regime that
``chip_smoke.py`` drives on the card.  Both packages' ``ServerlessNode``\\ s
(``install="fused"``, reduced qwen1.5-0.5b, the JAX initializer's weights)
run the same regimes through the same functions of ``chip_smoke.py``;
outcomes and tokens must agree.  No step waits on a sleep: slowed reads
(``simulate_read_bw``) keep a restore in flight, and each wait polls the
handle's timeline under a deadline.  The burst and the cancel regime also
run on the card (``gpu``) against the port's CPU tokens."""
import contextlib
import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import BaseImage as JBaseImage
from repro.serve import engine as jengine
from repro.serve.instance import layerwise_state as jlayerwise
from repro_torch.configs import get_config
from repro_torch.core import BaseImage
from repro_torch.core.treeutil import flatten_state
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import generate, layerwise_state
from torch_twins import CPU, jax_params, need_device, port_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card's concurrent regimes, rehearsed here)

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[4, 8, 15, 16, 23, 42]], dtype=np.int32)
MAX_NEW = 3
FNS = ("ft-0", "ft-1", "ft-2", "ft-3")
BASE = "conc-base"
BURST_S = 0.2  # the burst slows its restore's reads to last about this long
ROOT = Path(__file__).resolve().parents[1]

_SANITIZED_BURST = r"""
import dataclasses, json, sys, tempfile
import numpy as np, torch
import chip_smoke
from repro_torch.configs import get_config
from repro_torch.core import BaseImage
from repro_torch.interop import tree_leaves
from repro_torch.models import lm
from repro_torch.serve.engine import ServerlessNode, generate, layerwise_state

cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), n_layers=2, pattern_reps=2)
params = lm.init_params(cfg, seed=chip_smoke.SEED, device="cuda")
ft = chip_smoke.fine_tune(params, cfg, page=2)
prompt = np.random.default_rng(chip_smoke.SEED).integers(
    0, cfg.vocab_size, (chip_smoke.BATCH, chip_smoke.PROMPT_LEN)).astype(np.int32)
want = generate(cfg, None, layerwise_state(cfg, ft), prompt, chip_smoke.MAX_NEW, device="cpu")[0]
nbytes = sum(t.nbytes for t in tree_leaves(params))
node = ServerlessNode(device="cuda", install="fused", memory_budget_bytes=8 * nbytes)
try:
    node.node_cache.put(BaseImage.from_state("base", layerwise_state(cfg, params)),
                        evictable=False)
    node.publish("fn-ft-2", cfg, ft, tempfile.mkdtemp(), base_name="base", formats=("jif",),
                 warm_ttl_s=600.0)
    rs = chip_smoke.burst(node, "fn-ft-2", prompt, chip_smoke.MAX_NEW, cfg, chip_smoke.BURST)
    torch.cuda.synchronize()
finally:
    node.close()
print(json.dumps({"joined": sum(r.joined for r in rs),
                  "tokens": [bool(np.array_equal(r.tokens, want)) for r in rs]}))
"""


def fine_tuned(np_params, page: int):
    """``chip_smoke.fine_tune``'s scheme at the reduced width, on the JAX
    package's numpy weights: the ``page``-th quarter of each layer's ``wo``
    rows + 0.01 and ``0.01 * (page + 1)`` on the final norm."""
    layer = dict(np_params["pattern"][0])
    wo = np.array(layer["attn"]["wo"])
    rows = wo.shape[1] // len(FNS)
    wo[:, page * rows:(page + 1) * rows, :] += np.float32(0.01)
    layer["attn"] = dict(layer["attn"], wo=wo)
    return dict(np_params, pattern=(layer, *np_params["pattern"][1:]),
                final_norm=np_params["final_norm"] + np.float32(0.01 * (page + 1)))


@pytest.fixture(scope="module")
def weights():
    """The base (the JAX initializer's reduced qwen1.5-0.5b) and its four
    fine-tunes, as numpy arrays."""
    base = jax_params(jget_config(ARCH).reduced(), 61)
    return base, {f: fine_tuned(base, i) for i, f in enumerate(FNS)}


@contextlib.contextmanager
def fused_node(side: str, weights, d, device=CPU):
    """``(engine module, node, cfg)``: a fused ``ServerlessNode`` of the JAX
    package (``side`` "jax") or the port ("torch", on ``device``) holding
    the base image, with the four fine-tunes published against it in the
    JIF and the monolith."""
    base, tunes = weights
    if side == "jax":
        mod, cfg, node = jengine, jget_config(ARCH).reduced(), jengine.ServerlessNode(install="fused")
        node.node_cache.put(JBaseImage.from_state(BASE, jlayerwise(cfg, base)), evictable=False)
        tunes = dict(tunes)
    else:
        mod, cfg = tengine, get_config(ARCH).reduced()
        node = tengine.ServerlessNode(install="fused", device=device)
        node.node_cache.put(BaseImage.from_state(BASE, layerwise_state(cfg, port_params(base))),
                            evictable=False)
        tunes = {f: port_params(p, device) for f, p in tunes.items()}
    try:
        for f, p in tunes.items():
            node.publish(f, cfg, p, str(d / side), base_name=BASE, formats=("jif", "monolith"),
                         warm_ttl_s=600.0)
        yield mod, node, cfg
    finally:
        node.close()


def cold_bytes_read(node, fname, cfg) -> int:
    """One sequential cold start of ``fname``: the bytes its restore read."""
    node.evict()
    r = node.invoke(fname, PROMPT, MAX_NEW, mode="spice", cfg=cfg)
    assert r.cold
    return r.stats["bytes_read"]


def ended(o):
    """An outcome's tokens as a list, or the typed error's name."""
    return o if isinstance(o, str) else np.asarray(o.tokens).tolist()


# --------------------------------------------------------- multi-tenant
@pytest.mark.parametrize("mode", ["spice", "faasnap_star"])
def test_multi_tenant_fine_tunes_match_jax_node(weights, tmp_path, mode):
    """Four fine-tunes of one base cold-started at once (two rounds): each
    function's tokens equal the JAX node's in the same regime; under spice
    the device image cache builds each base tensor once, in the first
    round, and the second round shares it; the ledger audits clean."""
    tokens = {}
    for side in ("jax", "torch"):
        with fused_node(side, weights, tmp_path) as (mod, node, cfg):
            images = node.scheduler.device_images
            for rnd in (1, 2):
                res, wall, bw, _ = chip_smoke.multi_tenant(node, FNS, PROMPT, MAX_NEW, mode, cfg)
                assert set(res) == set(FNS) and wall > 0 and bw > 0
                for f, r in res.items():
                    assert r.cold and not r.joined, f
                    tokens.setdefault(side, {}).setdefault(f, []).append(np.asarray(r.tokens))
                st = images.snapshot_stats()
                if mode == "spice":
                    # each entry built once: no duplicate build ever won, none evicted
                    assert st["evictions"] == 0
                    assert st["misses"] == images.resident_entries() > 0
                    assert st["built_bytes"] == images.resident_bytes()
                    if rnd == 2:
                        assert st["misses"] == first  # the second round builds nothing
                    first = st["misses"]
                else:  # faasnap* installs each leaf with a copy: no device base
                    assert st["misses"] == st["hits"] == 0
                node.memory.audit()
            node.evict()
            node.memory.audit()
    for f in FNS:
        for j, t in zip(tokens["jax"][f], tokens["torch"][f]):
            np.testing.assert_array_equal(t, j, err_msg=f)
    assert len({tuple(np.ravel(tokens["jax"][f][0])) for f in FNS}) > 1  # four functions


def test_evicted_trees_leave_nothing_alive(weights, tmp_path):
    """After a multi-tenant round every restored tensor dies with its
    instance's eviction once the uploads have landed.  An uploader thread
    that held its last job until the next one would keep, through that
    job's handle (its demand hook reaches the stream, whose completion hook
    holds every handle), the whole tree of the last restore alive: on the
    card an image of device memory the ledger has released (ROADMAP §3)."""
    with fused_node("torch", weights, tmp_path) as (mod, node, cfg):
        res, *_ = chip_smoke.multi_tenant(node, FNS, PROMPT, MAX_NEW, "spice", cfg)
        refs = [weakref.ref(a) for f in FNS
                for _, a in flatten_state(node.scheduler.instance(f).tree)[0]]
        assert len(refs) == len(FNS) * len(flatten_state(layerwise_state(
            cfg, port_params(weights[0])))[0])
        node.evict()
        assert node.scheduler.upload_stream.flush(chip_smoke.WAIT_S)
        gc.collect()
        assert sum(r() is not None for r in refs) == 0


def test_evicted_trees_die_without_the_cyclic_collector(weights, tmp_path):
    """The same round with Python's cyclic collector off: every restored
    tensor dies at its eviction by reference counting alone.  A restore's
    stream kept its completion hook (which holds every handle, each of whose
    demand hooks holds the stream), and ``flatten_state``'s walk referred to
    itself through its closure; either cycle kept a whole evicted tree on
    the card until a collection ran."""
    gc.collect()
    gc.disable()
    try:
        with fused_node("torch", weights, tmp_path) as (mod, node, cfg):
            chip_smoke.multi_tenant(node, FNS, PROMPT, MAX_NEW, "spice", cfg)
            refs = [weakref.ref(a) for f in FNS
                    for _, a in flatten_state(node.scheduler.instance(f).tree)[0]]
            assert refs
            node.evict()
            assert node.scheduler.upload_stream.flush(chip_smoke.WAIT_S)
            assert sum(r() is not None for r in refs) == 0
    finally:
        gc.enable()


# ---------------------------------------------------------------- burst
def test_burst_rides_one_restore_like_jax_node(weights, tmp_path):
    """``chip_smoke.BURST`` invocations of one cold fine-tune submitted at
    once: one restore (its reads those of a sequential cold start), the
    rest ride it, one cold start counted, every token the JAX node's."""
    runs = {}
    for side in ("jax", "torch"):
        with fused_node(side, weights, tmp_path) as (mod, node, cfg):
            seq = cold_bytes_read(node, "ft-2", cfg)
            cold0 = node.scheduler.stats["cold_starts"]
            rs = chip_smoke.burst(node, "ft-2", PROMPT, MAX_NEW, cfg, chip_smoke.BURST,
                                  simulate_read_bw=seq / BURST_S)
            owners = [r for r in rs if r.cold and not r.joined]
            assert len(owners) == 1 and sum(r.joined for r in rs) == chip_smoke.BURST - 1
            assert node.scheduler.stats["cold_starts"] == cold0 + 1
            assert owners[0].stats["bytes_read"] == seq
            node.memory.audit()
            runs[side] = [np.asarray(r.tokens) for r in rs]
    for j, t in zip(runs["jax"], runs["torch"]):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, runs["jax"][0])


# --------------------------------------------------------------- cancel
def test_cancel_mid_restore_on_multi_tenant_node(weights, tmp_path):
    """The four fine-tunes cold-started at once, ``ft-3``'s reads slowed:
    once its timeline shows RESTORING and its first upload has landed it
    is cancelled.  It ends ``InvocationCancelled``, the other three give
    the JAX node's tokens, no upload stays pending, the ledger audits clean
    and, evicted, holds no working set; ``ft-3`` then restores cleanly."""
    runs = {}
    for side in ("jax", "torch"):
        with fused_node(side, weights, tmp_path) as (mod, node, cfg):
            sched = node.scheduler
            slow = cold_bytes_read(node, "ft-3", cfg) / chip_smoke.RESTORE_S
            node.evict()
            stale = sched.instance("ft-3").restore_stats
            handles = {f: node.submit(f, PROMPT, MAX_NEW, mode="spice", cfg=cfg,
                                      simulate_read_bw=slow if f == "ft-3" else None)
                       for f in FNS}

            def landed():
                st = sched.instance("ft-3").restore_stats
                return st is not stale and st.patched_on_device_bytes + st.uploaded_bytes > 0

            chip_smoke.wait_until(
                lambda: handles["ft-3"].event_ts(chip_smoke.EVT_RESTORING) is not None
                and landed(), "ft-3 restoring with an upload landed")
            assert handles["ft-3"].event_ts(chip_smoke.EVT_WS_READY) is None
            assert handles["ft-3"].cancel()
            runs[side] = {f: ended(chip_smoke.outcome(mod, h)) for f, h in handles.items()}
            assert sched.upload_stream.flush(chip_smoke.WAIT_S)
            node.memory.audit()
            node.evict()
            kinds = node.memory.kind_bytes()
            assert kinds["working_set"] == kinds["residual"] == 0, kinds
            node.memory.audit()
            r = node.invoke("ft-3", PROMPT, MAX_NEW, mode="spice", cfg=cfg)
            assert r.cold
            runs[side]["ft-3 again"] = ended(r)
            node.memory.audit()
    assert runs["jax"]["ft-3"] == runs["torch"]["ft-3"] == "InvocationCancelled"
    assert runs["torch"] == runs["jax"]


def test_cancel_and_deadlines_regime_matches_jax_node(weights, tmp_path):
    """``chip_smoke.cancel_deadline`` (the card's regime C) on both nodes:
    ``ft-3`` cancelled after its first upload, a queued ``ft-1`` past its
    deadline ``DeadlineExceeded`` (both packages check a deadline at submit
    and at claim), a slowed ``ft-1`` whose deadline passes mid-restore
    delivered with its riders, and a warm ``ft-0`` served meanwhile; the
    same outcomes and tokens in both packages, the ledger back to where it
    was."""
    runs = {}
    for side in ("jax", "torch"):
        with fused_node(side, weights, tmp_path) as (mod, node, cfg):
            slow = cold_bytes_read(node, "ft-3", cfg) / chip_smoke.RESTORE_S
            node.evict()
            assert node.invoke("ft-0", PROMPT, MAX_NEW, mode="spice", cfg=cfg).cold
            kinds0 = node.memory.kind_bytes()
            out = chip_smoke.cancel_deadline(mod, node, cfg, PROMPT, MAX_NEW, "ft-0", "ft-3",
                                             "ft-1", slow)
            assert out["accepted"] and out["own_restoring"] and out["warm_first"]
            assert not out["warm"].cold and all(r.joined for r in out["riders"])
            assert node.scheduler.upload_stream.flush(chip_smoke.WAIT_S)
            node.evict("ft-1")
            kinds = node.memory.kind_bytes()
            assert (kinds["working_set"], kinds["residual"]) == (kinds0["working_set"],
                                                                 kinds0["residual"])
            node.memory.audit()
            runs[side] = {k: [ended(o) for o in v] if k == "riders" else ended(v)
                          for k, v in out.items() if k not in ("accepted", "own_restoring",
                                                               "warm_first")}
    assert runs["jax"]["doomed"] == "InvocationCancelled"
    assert runs["jax"]["late"] == "DeadlineExceeded"
    assert runs["torch"] == runs["jax"]


# ------------------------------------------------------------- the card
@pytest.mark.gpu
def test_burst_and_cancel_on_the_card(weights, tmp_path):
    """Regimes B and C of ``chip_smoke.py``'s concurrent phase on the card at
    the reduced config: the upload stream's own CUDA stream lands K1's
    tensors while invoke workers read them on the default stream; every
    token equals the port's CPU path on the same weights."""
    need_device("cuda")
    import torch

    cfg = get_config(ARCH).reduced()
    want = {f: generate(cfg, None, layerwise_state(cfg, port_params(p)), PROMPT, MAX_NEW,
                        device=CPU)[0].tolist() for f, p in weights[1].items()}
    with fused_node("torch", weights, tmp_path, device="cuda") as (mod, node, cfg):
        seq = cold_bytes_read(node, "ft-2", cfg)
        rs = chip_smoke.burst(node, "ft-2", PROMPT, MAX_NEW, cfg, chip_smoke.BURST,
                              simulate_read_bw=seq / BURST_S)
        assert sum(r.joined for r in rs) == chip_smoke.BURST - 1
        assert [ended(r) for r in rs] == [want["ft-2"]] * chip_smoke.BURST
        node.evict()
        assert node.invoke("ft-0", PROMPT, MAX_NEW, mode="spice", cfg=cfg).cold
        out = chip_smoke.cancel_deadline(mod, node, cfg, PROMPT, MAX_NEW, "ft-0", "ft-3", "ft-1",
                                         seq / chip_smoke.RESTORE_S)
        assert out["accepted"] and out["doomed"] == "InvocationCancelled"
        assert out["late"] == "DeadlineExceeded"
        assert ended(out["warm"]) == want["ft-0"] and ended(out["own"]) == want["ft-1"]
        assert [ended(r) for r in out["riders"]] == [want["ft-1"]] * (chip_smoke.WORKERS - 2)
        assert node.scheduler.upload_stream.flush(chip_smoke.WAIT_S)
        assert node.scheduler.upload_stream.snapshot_stats()["failures"] == 0
        torch.cuda.synchronize()
        r = node.invoke("ft-3", PROMPT, MAX_NEW, mode="spice", cfg=cfg)
        assert r.cold and ended(r) == want["ft-3"]
        node.evict()
        node.memory.audit()


@pytest.mark.gpu
def test_burst_under_the_cuda_sanitizer():
    """The burst once more at qwen1.5-0.5b's full width (2 of 24 layers),
    in a process with PyTorch's CUDA sanitizer on: it sees the uploader's
    copies on its own stream and the riders' reads on the default stream
    (not the kernels launched through ctypes), and raises in the thread
    that races.  Every invocation must end with the CPU's tokens."""
    need_device("cuda")
    env = dict(os.environ, TORCH_CUDA_SANITIZER="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _SANITIZED_BURST], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"joined": chip_smoke.BURST - 1, "tokens": [True] * chip_smoke.BURST}, res
