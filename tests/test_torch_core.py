"""The port's twin of ``tests/test_core.py``, case for case, against
``repro_torch.core``: JIF round-trips, overlay dedup invariants, pipelined
restore correctness, baselines, pool/cache behaviour.  Each round-trip,
dedup and delta case also runs over a tree of torch tensors (a bf16 leaf,
transposed views that are not contiguous, a 0-d int64, all-zero leaves):
the port's JIF of it must equal the JAX package's ``snapshot`` of the same
values as numpy / ``ml_dtypes`` arrays apart from ``created_at``, and every
restored leaf must hold those values."""
import threading

import numpy as np
import pytest
import torch

from repro.core import BaseImage as JBaseImage
from repro.core import snapshot as jsnapshot
from repro_torch.core import (
    BaseImage,
    BufferPool,
    NodeImageCache,
    SpiceRestorer,
    snapshot,
)
from repro_torch.core import baselines, overlay
from repro_torch.core.treeutil import flatten_state, unflatten_state
from torch_twins import assert_trees_equal as assert_state_equal
from torch_twins import jif_bytes_but_created_at, leaf_key, torch_twin, twin

PAGE = 4096  # small pages keep tests fast
KINDS = ["numpy", "torch"]


def rng_state(seed=0, scale=1):
    r = np.random.RandomState(seed)
    return {
        "embed": {"tok": r.randn(64 * scale, 32).astype(np.float32)},
        "layers": [
            {
                "w": r.randn(32, 64).astype(np.float32),
                "b": np.zeros((2048,), np.float32),  # zero chunks
            }
            for _ in range(3)
        ],
        "step": np.int64(7),
    }


def assert_jif_like_jax(kind, path, values, tmp_path, base=None, **kw):
    """Over torch leaves, the port's JIF at ``path`` equals the JAX
    package's ``snapshot`` of ``values`` (``base``: the base state, made a
    JAX base image) apart from ``created_at``."""
    if kind == "numpy":
        return
    jpath = str(tmp_path / "jax.jif")
    jbase = None if base is None else JBaseImage.from_state("base-v1", base, PAGE)
    jsnapshot(values, jpath, base=jbase, page_size=PAGE, **kw)
    assert jif_bytes_but_created_at(path) == jif_bytes_but_created_at(jpath)


# ------------------------------------------------------------------ treeutil
@pytest.mark.parametrize("kind", KINDS)
def test_tree_roundtrip(kind):
    state, values = twin(kind, rng_state())
    leaves, desc = flatten_state(state)
    rebuilt = unflatten_state(desc, dict(leaves))
    assert_state_equal(values, rebuilt)


# ------------------------------------------------------------------- overlay
# (deterministic variants; the hypothesis-powered versions live in
# test_torch_properties.py)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("page", [256, 1024, PAGE])
def test_interval_table_covers_everything(seed, page):
    r = np.random.RandomState(seed)
    data = r.bytes(r.randint(1, PAGE * 7))
    buf = np.frombuffer(data, np.uint8)
    kinds = overlay.classify(memoryview(buf), page)
    table = overlay.IntervalTable(overlay.intervals_from_kinds(kinds))
    assert table.n_pages == overlay.n_chunks(len(data), page)
    for pg in range(table.n_pages):
        kind, _ = table.lookup(pg)
        assert kind == kinds[pg]


@pytest.mark.parametrize("seed", range(8))
def test_zero_detection(seed):
    r = np.random.RandomState(seed)
    n = r.randint(1, 6)
    buf = np.zeros(n * PAGE, np.uint8)
    dirty = set()
    for _ in range(r.randint(0, n)):
        i = r.randint(0, n)
        buf[i * PAGE + r.randint(PAGE)] = 1 + r.randint(255)
        dirty.add(i)
    zm = overlay.zero_mask(memoryview(buf), PAGE)
    assert set(np.flatnonzero(~zm)) == dirty


def test_base_dedup_classification():
    base_arr = np.arange(PAGE * 4, dtype=np.uint8)
    priv = base_arr.copy()
    priv[PAGE : PAGE + 1] += 1  # dirty page 1
    dg = overlay.chunk_digests(memoryview(base_arr), PAGE)
    kinds = overlay.classify(memoryview(priv), PAGE, dg)
    assert kinds[0] == overlay.KIND_BASE
    assert kinds[1] == overlay.KIND_PRIVATE
    assert list(kinds[2:]) == [overlay.KIND_BASE, overlay.KIND_BASE]


# ---------------------------------------------------------------- jif/spice
@pytest.mark.parametrize("kind", KINDS)
def test_jif_roundtrip_no_base(tmp_path, kind):
    state, values = twin(kind, rng_state())
    path = str(tmp_path / "f.jif")
    stats = snapshot(state, path, page_size=PAGE)
    assert stats.zero_bytes >= 3 * 2048 * 4 - PAGE  # the zero biases
    restorer = SpiceRestorer()
    got, meta, handles, rstats = restorer.restore(path)
    assert_state_equal(values, got)
    assert rstats.major_faults == 0
    assert rstats.restore_ops == 1
    assert_jif_like_jax(kind, path, values, tmp_path)


def zero_size_state():
    """``rng_state`` with two leaves of 0 bytes."""
    return dict(rng_state(), empty=np.zeros((0,), np.float32),
                empty_2d=np.zeros((0, 4), np.float32))


def zero_size_twin(kind):
    """``twin`` of ``zero_size_state``; over torch leaves ``empty_2d`` is
    bf16 and ``empty`` has stride 0, as ``torch.from_numpy`` gives it."""
    if kind == "numpy":
        return twin(kind, zero_size_state())
    return torch_twin(zero_size_state(), bf16=("embed/tok", "empty_2d"))


@pytest.mark.parametrize("kind", KINDS)
def test_jif_roundtrip_zero_size_leaf(tmp_path, kind):
    state, values = zero_size_twin(kind)
    path = str(tmp_path / "f.jif")
    snapshot(state, path, page_size=PAGE)
    got, _, _, _ = SpiceRestorer().restore(path)
    assert_state_equal(values, got)
    assert_jif_like_jax(kind, path, values, tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_jif_roundtrip_with_base(tmp_path, kind):
    base_np = rng_state(0)
    state_np = rng_state(0)
    # perturb one tensor slightly: most chunks should dedup to BASE
    state_np["layers"][1]["w"] = state_np["layers"][1]["w"].copy()
    state_np["layers"][1]["w"][0, 0] += 1.0
    base_state, base_values = twin(kind, base_np)
    state, values = twin(kind, state_np)

    cache = NodeImageCache()
    cache.put(BaseImage.from_state("base-v1", base_state, PAGE))

    path = str(tmp_path / "f.jif")
    stats = snapshot(state, path, base=cache.get("base-v1"), page_size=PAGE)
    assert stats.base_bytes > 0
    assert stats.private_bytes < stats.total_bytes - stats.zero_bytes

    restorer = SpiceRestorer(node_cache=cache)
    got, _, _, rstats = restorer.restore(path)
    assert_state_equal(values, got)
    assert rstats.base_bytes == stats.base_bytes
    # dedup means we read less than the full image from "disk"
    assert rstats.bytes_read <= stats.private_bytes + PAGE * stats.n_tensors
    assert_jif_like_jax(kind, path, values, tmp_path, base=base_values)


@pytest.mark.parametrize("kind", KINDS)
def test_restore_missing_base_fails(tmp_path, kind):
    base_state, _ = twin(kind, rng_state(0))
    cache = NodeImageCache()
    cache.put(BaseImage.from_state("base-v1", base_state, PAGE))
    path = str(tmp_path / "f.jif")
    snapshot(twin(kind, rng_state(0))[0], path, base=cache.get("base-v1"), page_size=PAGE)
    with pytest.raises(FileNotFoundError):
        SpiceRestorer(node_cache=NodeImageCache()).restore(path)


@pytest.mark.parametrize("kind", KINDS)
def test_access_order_layout(tmp_path, kind):
    state, values = twin(kind, rng_state())
    names = [n for n, _ in flatten_state(state)[0]]
    order = list(reversed(names))
    path = str(tmp_path / "f.jif")
    snapshot(state, path, access_order=order, page_size=PAGE)
    got, meta, _, _ = SpiceRestorer().restore(path)
    assert meta["access_order"] == order
    assert_state_equal(values, got)
    assert_jif_like_jax(kind, path, values, tmp_path, access_order=order)


@pytest.mark.parametrize("kind", KINDS)
def test_streaming_restore_overlap(tmp_path, kind):
    """wait=False returns handles immediately; tensors become ready in
    access order and waiting per-tensor yields correct bytes."""
    state, values = twin(kind, rng_state(3, scale=8))
    path = str(tmp_path / "f.jif")
    snapshot(state, path, page_size=PAGE)
    ready_order = []
    restorer = SpiceRestorer()
    tree, meta, handles, _ = restorer.restore(
        path, on_ready=lambda n, a: ready_order.append(n), wait=False
    )
    leaves, _ = flatten_state(values)
    for name, arr in leaves:
        got = handles[name].wait(10)
        assert leaf_key(got) == leaf_key(arr), name
    assert ready_order == meta["access_order"]
    assert_jif_like_jax(kind, path, values, tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_trim_fn(tmp_path, kind):
    embed, embed_values = twin(kind, rng_state()["embed"])
    m = np.ones((4096,), np.float32)
    state = {"params": embed, "opt": {"m": torch.from_numpy(m) if kind == "torch" else m}}
    path = str(tmp_path / "f.jif")
    trim = lambda s: {"params": s["params"]}  # noqa: E731
    snapshot(state, path, page_size=PAGE, trim_fn=trim)
    got, _, _, _ = SpiceRestorer().restore(path)
    assert "opt" not in got
    assert_state_equal({"params": embed_values}, got)
    assert_jif_like_jax(kind, path, {"params": embed_values, "opt": {"m": m}}, tmp_path,
                        trim_fn=trim)


# ------------------------------------------------------------------ baselines
@pytest.mark.parametrize("kind", KINDS)
def test_criu_star_roundtrip(tmp_path, kind):
    state, values = twin(kind, rng_state())
    d = str(tmp_path / "criu")
    baselines.criu_star_snapshot(state, d)
    got, stats = baselines.criu_star_restore(d)
    assert_state_equal(values, got)
    n = len(flatten_state(state)[0])
    assert stats.restore_ops >= 3 * n  # per-resource replay


@pytest.mark.parametrize("kind", KINDS)
def test_reap_star_roundtrip(tmp_path, kind):
    state, values = twin(kind, rng_state())
    extra = {"opt": np.ones((4096,), np.float32)}
    path = str(tmp_path / "mono.img")
    baselines.monolith_snapshot(state, path, extra_state=extra)
    got, stats = baselines.reap_star_restore(path)
    assert_state_equal(values, got)
    total = sum(np.asarray(a).nbytes for _, a in flatten_state(values)[0])
    assert stats.bytes_read > total  # fetched the unused extra state too


@pytest.mark.parametrize("kind", KINDS)
def test_faasnap_star_faults(tmp_path, kind):
    state, values = twin(kind, rng_state())
    path = str(tmp_path / "mono.img")
    baselines.monolith_snapshot(state, path)
    r = baselines.FaasnapAsyncRestorer(path, lag_s=0.05)
    # demand an out-of-order tensor immediately: must fault, still correct
    arr = r.ensure("layers/2/w")
    assert leaf_key(arr) == leaf_key(values["layers"][2]["w"])
    assert r.stats.major_faults > 0
    assert_state_equal(values, r.state())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["criu_star", "reap_star", "faasnap_star"])
def test_baselines_zero_size_leaf(tmp_path, kind, mode):
    """Leaves of 0 bytes (f32, and bf16 over torch leaves) come back from
    every baseline; FaaSnap* faults them in before its reader gets there."""
    state, values = zero_size_twin(kind)
    if mode == "criu_star":
        baselines.criu_star_snapshot(state, str(tmp_path / "criu"))
        got, _ = baselines.criu_star_restore(str(tmp_path / "criu"))
    else:
        path = str(tmp_path / "mono.img")
        baselines.monolith_snapshot(state, path)
        if mode == "reap_star":
            got, _ = baselines.reap_star_restore(path)
        else:
            r = baselines.FaasnapAsyncRestorer(path, lag_s=0.05)
            for name in ("empty_2d", "empty"):
                assert leaf_key(r.ensure(name)) == leaf_key(values[name])
            got = r.state()
    assert_state_equal(values, got)


# ----------------------------------------------------------------- pool/cache
def test_pool_zero_reuse():
    pool = BufferPool(capacity_bytes=1 << 20)
    b = pool.acquire(5000)
    assert b.nbytes >= 5000 and not b.any()
    b[:] = 7
    pool.release(b)
    b2 = pool.acquire(5000)
    assert not b2.any()  # re-zeroed
    assert pool.stats["hits"] == 1


def test_pool_concurrent_acquire_release():
    """Stress the pool from many threads: stats must balance and every
    acquired buffer must come back zeroed (thread-safety pass)."""
    pool = BufferPool(capacity_bytes=8 << 20)
    errors = []

    def worker(seed):
        r = np.random.RandomState(seed)
        for _ in range(200):
            nb = int(r.randint(1, 64 << 10))
            buf = pool.acquire(nb)
            if buf.any():
                errors.append("dirty buffer from acquire")
                return
            buf[: min(64, buf.nbytes)] = 1
            pool.note_zero_chunks(nb)
            pool.release(buf, dirty=True)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    stats = pool.snapshot_stats()
    assert stats["hits"] + stats["misses"] == 8 * 200
    assert stats["zero_bytes_avoided"] > 0
    assert pool.held_bytes <= pool.capacity


@pytest.mark.parametrize("kind", KINDS)
def test_restore_stats_snapshot_consistent(tmp_path, kind):
    """wait=False stats must expose completion; totals are only final (and
    the JifReader only closed) once the stream has drained."""
    state, values = twin(kind, rng_state(1, scale=8))
    path = str(tmp_path / "f.jif")
    snapshot(state, path, page_size=PAGE)
    restorer = SpiceRestorer(simulate_read_bw=5e8)
    _, _, handles, stats = restorer.restore(path, wait=False)
    d = stats.as_dict()
    assert "complete" in d  # snapshot carries its own consistency marker
    assert stats.wait_complete(timeout=30)
    done = stats.as_dict()
    assert done["complete"]
    total = sum(np.asarray(a).nbytes for _, a in flatten_state(values)[0])
    # all private bytes were read and accounted once the stream completed
    assert done["bytes_read"] + done["zero_bytes"] >= total - PAGE * len(handles)
    for h in handles.values():
        assert h.ready


def test_failed_restore_releases_waiters(tmp_path):
    """A failure on the prefetch path (here: device install) must fail the
    stream, release every TensorHandle waiter with the error, and still
    mark stats complete (reader closed) instead of hanging."""
    state = rng_state()
    path = str(tmp_path / "f.jif")
    snapshot(state, path, page_size=PAGE)

    def bad_install(arr):
        raise RuntimeError("device install failed")

    restorer = SpiceRestorer(transform=bad_install)
    _, _, handles, stats = restorer.restore(path, wait=False)
    with pytest.raises(RuntimeError):
        next(iter(handles.values())).wait(5)
    assert stats.wait_complete(5)


def test_node_cache_lru():
    cache = NodeImageCache(capacity_bytes=1)  # force eviction
    cache.put(BaseImage.from_state("a", {"x": np.ones(4096, np.float32)}))
    cache.put(BaseImage.from_state("b", {"x": np.ones(4096, np.float32)}))
    assert cache.get("a") is None
    assert cache.get("b") is not None
