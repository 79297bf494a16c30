"""The port's span recorder (``repro_torch.obs``) on a fused node at the
reduced qwen1.5-0.5b: off, a cold start records nothing; on, one request
reads as one tree across the node worker, the prefetch reader and the
uploader; the upload jobs' spans and ``RestoreStats`` come from the same
stamps; FIRST_TOKEN on the timeline; joiners name the owner's restore;
the exporter; duplicate base builds counted.  The ``gpu`` case maps the
spans onto the profiler's clock and finds K1's launches inside their
upload jobs."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import BaseImage
from repro_torch.models import lm
from repro_torch.serve.engine import ServerlessNode, layerwise_state
from repro_torch.serve.invocation import (
    EVT_ADMITTED,
    EVT_DONE,
    EVT_FIRST_TOKEN,
    EVT_RUNNING,
)

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[4, 8, 15, 16, 23, 42, 7, 9]], dtype=np.int32)
MAX_NEW = 4
FNS = ("ft-0", "ft-1", "ft-2", "ft-3")
BASE = "obs-base"
WAIT_S = 60.0
CPU = "cpu"


def need_device(device: str) -> str:
    """``device``, or a skip when it is the card and there is none."""
    if device != CPU and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return device


def fine_tune(params, k: int):
    """The ``k``-th quarter of layer 0's ``wo`` rows + 0.01, the final norm
    + 0.01 (k + 1): a delta of a few pages over the base."""
    out = dict(params)
    layer = dict(params["pattern"][0])
    attn = dict(layer["attn"])
    wo = attn["wo"].clone()
    rows = wo.shape[1] // len(FNS)
    wo[:, k * rows:(k + 1) * rows] += 0.01
    attn["wo"] = wo
    layer["attn"] = attn
    out["pattern"] = (layer, *params["pattern"][1:])
    out["final_norm"] = params["final_norm"] + 0.01 * (k + 1)
    return out


def make_node(tmp_path, device=CPU, ttl=0.0):
    """A fused node holding the base image, the four fine-tunes published
    against it; ``ttl`` their keep-alive."""
    cfg = get_config(ARCH).reduced()
    params = lm.init_params(cfg, seed=3, device=device)
    node = ServerlessNode(device=device, install="fused")
    node.node_cache.put(BaseImage.from_state(BASE, layerwise_state(cfg, params)),
                        evictable=False)
    for k, f in enumerate(FNS):
        node.publish(f, cfg, fine_tune(params, k), str(tmp_path), base_name=BASE,
                     formats=("jif",), warm_ttl_s=ttl)
    return node, cfg


@pytest.fixture
def recorder():
    """The recorder on for the test, emptied before and after."""
    obs.disable()
    obs.drain()
    obs.enable()
    try:
        yield obs
    finally:
        obs.disable()
        obs.drain()


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    n, cfg = make_node(tmp_path_factory.mktemp("obs"), ttl=600.0)
    n.invoke("ft-0", PROMPT, MAX_NEW, cfg=cfg)  # the first restore builds the device base
    try:
        yield n, cfg
    finally:
        n.close()


def cold(node, cfg, fname="ft-1", **kw):
    node.evict()
    r = node.invoke(fname, PROMPT, MAX_NEW, mode="spice", cfg=cfg, **kw)
    assert r.cold and not r.joined
    settle(node, fname)
    return r


def settle(node, fname):
    """Wait until ``fname``'s restore and its uploads are all done (a
    result is delivered once the working set is resident)."""
    assert node.scheduler.instance(fname).restore_stats.wait_complete(WAIT_S)
    assert node.scheduler.upload_stream.flush(WAIT_S)
    assert node.scheduler.drain_residual(WAIT_S)


def by_req(spans):
    out = {}
    for s in spans:
        out.setdefault(s.req, []).append(s)
    return out


def test_recorder_off_records_nothing(node):
    n, cfg = node
    obs.disable()
    obs.drain()
    cold(n, cfg)
    n.invoke("ft-1", PROMPT, MAX_NEW, cfg=cfg)  # and a warm one
    assert obs.drain() == []
    assert obs.span("restore") is obs.span("invoke")  # one shared null block


def test_one_request_across_worker_reader_and_uploader(node, recorder):
    n, cfg = node
    r = cold(n, cfg)
    spans = obs.drain()
    ids = {s.id for s in spans}
    assert all(s.parent in ids for s in spans if s.parent), "every parent exists"
    (root,) = [s for s in spans if s.name == "invoke"]
    assert root.parent == 0 and root.req > 0
    mine = by_req(spans)[root.req]
    names = {s.name for s in mine}
    assert {"invoke", "invoke.queue", "restore", "restore.metadata", "restore.read",
            "install.job", "install.copy", "install.patch", "install.sync", "gen.prefill",
            "gen.decode_step", "invoke.complete_wait", EVT_ADMITTED, EVT_RUNNING,
            EVT_FIRST_TOKEN, EVT_DONE} <= names, names
    assert len(mine) == len(spans)  # nothing recorded outside the request
    threads = {s.thread for s in mine}
    assert any(t.startswith("invoke") for t in threads)
    assert any(t.endswith("-reader") for t in threads)
    assert any(t.endswith("-uploader") for t in threads)
    (rs,) = [s for s in mine if s.name == "restore"]
    assert rs.parent == root.id
    assert {s.parent for s in mine if s.name in ("restore.read", "install.job",
                                                  "restore.metadata")} == {rs.id}
    assert sum(s.attrs["bytes"] for s in mine if s.name == "restore.read") == r.stats["bytes_read"]
    steps = [s for s in mine if s.name == "gen.decode_step"]
    assert [s.attrs["step"] for s in steps] == list(range(1, MAX_NEW))
    assert all(root.start <= s.start <= s.end for s in mine)


def test_upload_job_spans_are_the_restore_stats(node, recorder):
    n, cfg = node
    cold(n, cfg, "ft-2")
    r = n.scheduler.instance("ft-2").restore_stats  # with the jobs after the result
    spans = obs.drain()
    (rs,) = [s for s in spans if s.name == "restore"]
    jobs = [s for s in spans if s.name == "install.job" and s.parent == rs.id]
    upload = sync = 0.0
    for j in jobs:  # summed in the order the uploader ran them, as the stats were
        upload += (j.end - j.start) / 1e9
        (sy,) = [s for s in spans if s.name == "install.sync" and s.parent == j.id]
        sync += (sy.end - sy.start) / 1e9
    assert jobs
    assert upload == r.upload_s
    assert sync == r.sync_wait_s <= upload
    assert sum(j.attrs["fused"] for j in jobs) > 0
    assert sum(j.attrs["bytes"] for j in jobs) == r.uploaded_bytes


@pytest.mark.parametrize("kind", ["cold", "warm"])
def test_first_token_between_running_and_done(node, kind):
    """With the recorder off too: the timeline stamps FIRST_TOKEN at the
    instant generation's TTFT ends."""
    n, cfg = node
    if kind == "cold":
        n.evict()
    else:
        n.invoke("ft-3", PROMPT, MAX_NEW, cfg=cfg)
    h = n.submit("ft-3", PROMPT, MAX_NEW, cfg=cfg)
    r = h.result(WAIT_S)
    assert r.cold == (kind == "cold")
    ts = dict(h.events())
    assert ts[EVT_RUNNING] <= ts[EVT_FIRST_TOKEN] <= ts[EVT_DONE]
    assert abs((ts[EVT_FIRST_TOKEN] - ts[EVT_ADMITTED]) - (r.queue_s + r.ttft_s)) < 1e-3


@pytest.mark.parametrize("on", [True, False])
def test_span_ends_at_a_stop_it_is_given(on):
    """A ``span`` block given a ``stop`` ends there, not at its exit, and
    parents what is recorded inside it; with the recorder off a stop is
    taken and the block records nothing."""
    obs.disable()
    obs.drain()
    if on:
        obs.enable()
    try:
        t0 = obs.now()
        block = obs.span("outer", start=t0)
        with block:
            inner = obs.add("inner", obs.now(), obs.now())
            block.stop = t1 = obs.now()
            time.sleep(0.002)
    finally:
        obs.disable()
    spans = obs.drain()
    outers = [s for s in spans if s.name == "outer"]
    if not on:
        assert outers == []
        return
    (outer,) = outers
    (child,) = [s for s in spans if s.id == inner]
    assert (outer.start, outer.end) == (t0, t1) and child.parent == outer.id


def test_layer_waits_and_joiners_name_the_owner_restore(node, recorder):
    """A slowed restore of one function and two more invocations riding it:
    the owner's prefill blocks on layers (``gen.layer_wait`` a layer, inside
    ``gen.prefill``), and each joiner's spans name the owner's ``restore``."""
    n, cfg = node
    seq = cold(n, cfg, "ft-0").stats["bytes_read"]
    obs.drain()
    n.evict()
    hs = [n.submit("ft-0", PROMPT, MAX_NEW, cfg=cfg, simulate_read_bw=seq / 0.3)
          for _ in range(3)]
    rs = [h.result(WAIT_S) for h in hs]
    assert sum(r.joined for r in rs) == 2
    settle(n, "ft-0")
    spans = obs.drain()
    (restore,) = [s for s in spans if s.name == "restore"]
    owner = by_req(spans)[restore.req]
    (pre,) = [s for s in owner if s.name == "gen.prefill"]
    waits = [s for s in owner if s.name == "gen.layer_wait"]
    assert waits and all(s.parent == pre.id and pre.start <= s.start <= s.end <= pre.end
                         for s in waits)
    assert all(-1 <= s.attrs["layer"] <= cfg.n_layers for s in waits)
    joiners = [s for s in spans if s.name == "gen.prefill" and s.req != restore.req]
    assert len(joiners) == 2
    assert all(s.attrs["cause"] == restore.id for s in joiners)


def test_chrome_trace_holds_every_span(node, recorder, tmp_path):
    n, cfg = node
    cold(n, cfg)
    spans = obs.drain()
    path = tmp_path / "trace.json"
    assert obs.write_chrome_trace(str(path), spans) == len(spans)
    events = json.loads(path.read_text())["traceEvents"]
    got = [e for e in events if e["ph"] in ("X", "i")]
    assert sorted((e["name"], e["args"]["id"]) for e in got) == sorted(
        (s.name, s.id) for s in spans)
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {s.thread for s in spans}
    assert all(e["dur"] >= 0 for e in got if e["ph"] == "X")


def test_step_logits_hook_is_per_thread(node):
    n, cfg = node
    seen = []
    obs.on_step_logits(lambda x: seen.append(x.clone()))
    try:
        r = n.invoke("ft-1", PROMPT, MAX_NEW, cfg=cfg)  # served on a worker thread
        assert n.scheduler.drain_residual(WAIT_S)
        assert seen == []
        from repro_torch.serve.instance import generate

        inst = n.scheduler.instance("ft-1")
        with inst.pinned_warm_tree() as tree:
            toks, _ = generate(cfg, None, tree, PROMPT, MAX_NEW, device=CPU)
    finally:
        obs.on_step_logits(None)
    assert obs.HOOKS == 0 and len(seen) == MAX_NEW
    assert [x.shape for x in seen] == [(1, cfg.vocab_size)] * MAX_NEW
    np.testing.assert_array_equal(toks, r.tokens)
    np.testing.assert_array_equal(np.stack([x.argmax(-1).numpy() for x in seen], 1), toks)


def test_moe_spans_and_pair_counters_on_a_small_generation(recorder):
    """A reduced Granite-style hybrid (3 layers, attention in the middle,
    each with a dropless MoE of 2 experts held of a router over 6, top 3,
    and a shared expert) generates on this thread: one ``gen.moe`` a layer
    a step, inside that step's ``gen.prefill`` or ``gen.decode_step``, each
    with one ``moe.experts`` child; its ``pairs_held`` summed is what the
    always-on counters add, and the rest of the routed pairs are counted
    as held elsewhere."""
    from repro_torch.configs import LayerSpec, ModelConfig
    from repro_torch.kernels.moe_experts import ops as k5
    from repro_torch.serve.instance import generate

    kinds = ("mamba", "attn", "mamba")
    cfg = ModelConfig(
        name="obs-granite", family="hybrid", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab_size=256, pattern=tuple(LayerSpec(kind=k, moe=True) for k in kinds),
        n_experts=2, top_k=3, capacity_factor=None, router_experts=6, expert_offset=2,
        shared_ff=48, rope=False, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        norm_before_gate=False, tie_embeddings=True, embed_scale=12.0, residual_scale=0.22,
        logits_scaling=16.0)
    state = layerwise_state(cfg, lm.init_params(cfg, seed=4, device=CPU))
    routed, held, launches = k5.PAIRS.routed, k5.PAIRS.held(), k5.LAUNCHES.count
    toks, _ = generate(cfg, None, state, PROMPT, MAX_NEW, device=CPU)
    spans = obs.drain()
    assert toks.shape == (1, MAX_NEW)
    steps = {s.id: s for s in spans if s.name in ("gen.prefill", "gen.decode_step")}
    moes = [s for s in spans if s.name == "gen.moe"]
    assert len(steps) == MAX_NEW and len(moes) == MAX_NEW * len(kinds)
    for sid in steps:
        mine = [s for s in moes if s.parent == sid]
        assert [s.attrs["layer"] for s in mine] == list(range(len(kinds)))
    experts = [s for s in spans if s.name == "moe.experts"]
    assert sorted(s.parent for s in experts) == sorted(s.id for s in moes)
    for s in moes:
        assert 0 <= s.attrs["max_expert_load"] <= s.attrs["pairs_held"]
        assert s.start <= min(e.start for e in experts if e.parent == s.id)
    tokens = PROMPT.size + PROMPT.shape[0] * (MAX_NEW - 1)
    assert k5.PAIRS.routed - routed == tokens * cfg.top_k * len(kinds)
    assert k5.PAIRS.held() - held == sum(s.attrs["pairs_held"] for s in moes) > 0
    assert k5.PAIRS.elsewhere() >= k5.PAIRS.routed - routed - (k5.PAIRS.held() - held)
    assert k5.LAUNCHES.count == launches  # the plain path on the CPU


def test_recording_from_many_threads_loses_nothing():
    """More threads than cores record spans, set and clear step-logits
    hooks, while the main thread drains, with a short switch interval: every
    span is drained once, ids are unique, no hook count is lost."""
    import os
    import sys

    n_threads, per = 4 * (os.cpu_count() or 2), 2000
    obs.disable()
    obs.drain()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got = []
    try:
        obs.enable()
        go = threading.Barrier(n_threads + 1, timeout=WAIT_S)

        def work(k):
            go.wait()
            for i in range(per):
                with obs.span("outer", k=k):
                    obs.add("inner", i, i + 1, i=i)
                obs.on_step_logits(print if i % 2 == 0 else None)

        ths = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for th in ths:
            th.start()
        go.wait()
        while any(th.is_alive() for th in ths):
            got += obs.drain()
        for th in ths:
            th.join(WAIT_S)
            assert not th.is_alive()
        got += obs.drain()
    finally:
        obs.disable()
        sys.setswitchinterval(interval)
    assert len(got) == 2 * n_threads * per
    assert len({s.id for s in got}) == len(got)
    outer = {s.id: s for s in got if s.name == "outer"}
    assert all(outer[s.parent].thread == s.thread for s in got if s.name == "inner")
    assert obs.HOOKS == 0


def test_racing_base_builds_count_as_duplicates(tmp_path):
    """The four fine-tunes cold-started at once, the first two device base
    builds held until both are under way: the loser of the race counts as
    a hit (as in the JAX package) and as a duplicate build."""
    node, cfg = make_node(tmp_path)
    images = node.scheduler.device_images
    real = images.install
    meet = threading.Barrier(2, timeout=10.0)

    def install(arr):
        try:
            meet.wait()
        except threading.BrokenBarrierError:
            pass
        return real(arr)

    images.install = install
    try:
        hs = [node.submit(f, PROMPT, MAX_NEW, cfg=cfg) for f in FNS]
        assert all(h.result(WAIT_S).cold for h in hs)
        assert node.scheduler.upload_stream.flush(WAIT_S)
        st = images.snapshot_stats()
    finally:
        node.close()
    assert st["duplicate_builds"] >= 1
    assert st["hits"] >= st["duplicate_builds"]
    assert st["misses"] == images.resident_entries()


@pytest.mark.gpu
def test_k1_launches_lie_inside_their_upload_jobs(tmp_path):
    """On the card: cold starts under the profiler (device activity alone)
    with the recorder on; each K1 launch, mapped onto the spans' clock
    through ``obs.clock_pair``, lies inside an ``install.job`` span (50 us
    either side) for at least 99% of the launches."""
    device = need_device("cuda")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n, cfg = make_node(tmp_path, device=device)
    try:
        cold(n, cfg)  # builds the kernels and the device base
        obs.drain()
        obs.enable()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a = obs.clock_pair()
            for f in FNS:
                cold(n, cfg, f)
            torch.cuda.synchronize()
            b = obs.clock_pair()
        obs.disable()
        spans = obs.drain()
    finally:
        obs.disable()
        n.close()
    offset = ((a[1] - a[0]) + (b[1] - b[0])) // 2  # wall clock - span clock, ns
    jobs = sorted((s.start, s.end) for s in spans if s.name == "install.job")
    launches = [(e.start_ns() - offset, e.end_ns() - offset)
                for e in prof.profiler.kineto_results.events()
                if e.device_type() != DeviceType.CPU and "overlay_patch_kernel" in e.name()]
    tol = 50_000
    inside = sum(any(s - tol <= k0 and k1 <= e + tol for s, e in jobs) for k0, k1 in launches)
    assert len(launches) >= len(FNS) and jobs
    assert inside >= 0.99 * len(launches), (inside, len(launches))
