"""The port's twin of ``tests/test_lifecycle.py``, case for case, against
``repro_torch.core``.  Each round-trip, dedup and delta case also runs over
a tree of torch tensors (a bf16 leaf, transposed views that are not
contiguous, a 0-d int64, all-zero leaves): the port's JIF of it must equal
the JAX package's ``snapshot`` of the same values as numpy / ``ml_dtypes``
arrays (against the same parent file) apart from ``created_at``, and every
restored leaf must hold those values.  Snapshot lifecycle subsystem: JIF v2 format compatibility (golden v1
bytes), delta chains, two-phase working-set restore, concurrent itable
loads, and the serving-side WARM-at-working-set promotion + record →
relayout feedback loop."""
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import BaseImage as JBaseImage
from repro.core import SnapshotPipeline as JSnapshotPipeline
from repro.core import snapshot as jsnapshot
from repro_torch.core import (
    BaseImage,
    NodeImageCache,
    SnapshotPipeline,
    SpiceRestorer,
    snapshot,
)
from repro_torch.core.jif import JifReader
from repro_torch.core.lifecycle import parent_cache_key
from repro_torch.core.treeutil import flatten_state, leaf_bytes
from torch_twins import assert_trees_equal as assert_state_equal
from torch_twins import jif_bytes_but_created_at, leaf_key, twin

PAGE = 4096
KINDS = ["numpy", "torch"]
GOLDEN = Path(__file__).parent / "golden" / "jif_v1_small.jif"


def golden_state():
    """Deterministic state matching the checked-in v1 golden image (written
    by the pre-pipeline writer)."""
    r = np.random.RandomState(42)
    return {
        "embed": {"tok": r.randn(64, 32).astype(np.float32)},
        "layers": [
            {"w": r.randn(32, 48).astype(np.float32),
             "b": np.zeros((2048,), np.float32)}
            for _ in range(3)
        ],
        "step": np.int64(11),
    }


def rng_state(seed=0, scale=1):
    r = np.random.RandomState(seed)
    return {
        "embed": {"tok": r.randn(64 * scale, 32).astype(np.float32)},
        "layers": [
            {"w": r.randn(32, 64).astype(np.float32),
             "b": np.zeros((2048,), np.float32)}
            for _ in range(3)
        ],
        "step": np.int64(7),
    }


def assert_jif_like_jax(kind, path, values, **kw):
    """Over torch leaves, the port's JIF at ``path`` equals the JAX
    package's ``snapshot`` of ``values`` with the same arguments (a
    ``parent`` is the same file) apart from ``created_at``."""
    if kind == "numpy":
        return
    jpath = path + ".jax"
    jsnapshot(values, jpath, page_size=PAGE, **kw)
    assert jif_bytes_but_created_at(path) == jif_bytes_but_created_at(jpath)


# ------------------------------------------------------- format compatibility
def test_golden_v1_restores_byte_identically():
    """A v1 JIF written by the pre-pipeline writer still restores, byte for
    byte, through the v2 reader."""
    got, meta, _, _ = SpiceRestorer().restore(str(GOLDEN))
    assert_state_equal(golden_state(), got)
    assert meta["golden"] == "v1"


def test_golden_v1_header_defaults():
    with JifReader(str(GOLDEN)) as r:
        assert r.version == 1
        assert not r.has_digests
        assert r.digests("embed/tok") is None
        # no boundary recorded: the whole data segment is the working set
        assert r.ws_boundary == r.n_data_chunks
        assert r.parent is None


@pytest.mark.parametrize("kind", KINDS)
def test_v2_header_carries_boundary_and_digests(tmp_path, kind):
    state, values = twin(kind, rng_state())
    names = [n for n, _ in flatten_state(state)[0]]
    path = str(tmp_path / "f.jif")
    stats = snapshot(state, path, access_order=names, working_set=names[:2],
                     page_size=PAGE)
    assert_jif_like_jax(kind, path, values, access_order=names, working_set=names[:2])
    with JifReader(path) as r:
        assert r.version == 2
        assert r.has_digests
        assert 0 < r.ws_boundary < r.n_data_chunks
        assert r.ws_boundary == stats.ws_boundary
        assert r.meta["working_set"] == names[:2]
        # stored digests match a fresh hash of the source bytes
        from repro_torch.core import overlay

        raw = leaf_bytes(state["embed"]["tok"])
        np.testing.assert_array_equal(
            r.digests("embed/tok"),
            overlay.chunk_digests(memoryview(raw), PAGE),
        )


def test_concurrent_itable_loads_one_reader(tmp_path):
    """Regression: itable loads used seek+read on the shared fd; many
    scheduler threads hitting one reader must still see correct tables."""
    state = {f"t{i:02d}": np.full((97 + 13 * i,), i, np.float32) for i in range(40)}
    path = str(tmp_path / "many.jif")
    snapshot(state, path, page_size=256)

    expect = {}
    with JifReader(path) as ref:
        for t in ref.tensors:
            expect[t.name] = ref.itable(t.name).table.copy()

    shared = JifReader(path)
    errors = []

    def worker(seed):
        r = np.random.RandomState(seed)
        names = list(expect)
        r.shuffle(names)
        for name in names:
            got = shared.itable(name).table
            if not np.array_equal(got, expect[name]):
                errors.append(name)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    shared.close()
    assert not errors


# ----------------------------------------------------------------- delta chain
@pytest.mark.parametrize("kind", KINDS)
def test_delta_chain_roundtrip(tmp_path, kind):
    """parent → child → grandchild, restored through the chain from a COLD
    cache (parents bootstrapped from disk)."""
    parent, parent_values = twin(kind, rng_state(5))
    parent_path = str(tmp_path / "parent.jif")
    full = snapshot(parent, parent_path, page_size=PAGE)
    assert_jif_like_jax(kind, parent_path, parent_values)

    child_np = rng_state(5)
    child_np["layers"][0]["w"] = child_np["layers"][0]["w"] + 1.0
    child, child_values = twin(kind, child_np)
    child_path = str(tmp_path / "child.jif")
    cs = snapshot(child, child_path, parent=parent_path, page_size=PAGE)
    assert cs.private_bytes < 0.4 * full.private_bytes  # only dirty pages
    assert cs.base_bytes > 0
    assert cs.parent == os.path.abspath(parent_path)
    assert_jif_like_jax(kind, child_path, child_values, parent=parent_path)

    grand_np = dict(child_np)
    grand_np["embed"] = {"tok": child_np["embed"]["tok"] * 1.5}
    grand, grand_values = twin(kind, grand_np)
    grand_path = str(tmp_path / "grand.jif")
    snapshot(grand, grand_path, parent=child_path, page_size=PAGE)
    assert_jif_like_jax(kind, grand_path, grand_values, parent=child_path)

    cache = NodeImageCache()
    got, _, _, rstats = SpiceRestorer(node_cache=cache).restore(grand_path)
    assert_state_equal(grand_values, got)
    # both ancestors were bootstrapped into the node cache from disk
    assert cache.get(parent_cache_key(parent_path)) is not None
    assert cache.get(parent_cache_key(child_path)) is not None


@pytest.mark.parametrize("kind", KINDS)
def test_delta_against_v1_parent(tmp_path, kind):
    """A v1 parent (no stored digests) is materialized once and still
    serves as a delta base."""
    child_np = golden_state()
    child_np["layers"][2]["w"] = child_np["layers"][2]["w"] + 2.0
    child, values = twin(kind, child_np)
    child_path = str(tmp_path / "child.jif")
    stats = snapshot(child, child_path, parent=str(GOLDEN), page_size=PAGE)
    assert stats.base_bytes > 0
    got, _, _, _ = SpiceRestorer(node_cache=NodeImageCache()).restore(child_path)
    assert_state_equal(values, got)
    assert_jif_like_jax(kind, child_path, values, parent=str(GOLDEN))


@pytest.mark.parametrize("kind", KINDS)
def test_rewritten_parent_fails_loudly(tmp_path, kind):
    """A parent rewritten in place after the delta was written must fail the
    restore (key mismatch), never serve stale/new parent bytes silently."""
    parent_path = str(tmp_path / "p.jif")
    snapshot(twin(kind, rng_state(5))[0], parent_path, page_size=PAGE)
    child = rng_state(5)
    child["layers"][0]["w"] = child["layers"][0]["w"] + 1.0
    child_path = str(tmp_path / "c.jif")
    snapshot(twin(kind, child)[0], child_path, parent=parent_path, page_size=PAGE)

    time.sleep(0.01)  # distinct mtime_ns for the rewrite
    snapshot(twin(kind, rng_state(6))[0], parent_path, page_size=PAGE)  # in-place rewrite
    with pytest.raises(FileNotFoundError, match="changed on disk"):
        SpiceRestorer(node_cache=NodeImageCache()).restore(child_path)


@pytest.mark.parametrize("kind", KINDS)
def test_base_image_from_jif_matches_from_state(tmp_path, kind):
    state, values = twin(kind, rng_state(9))
    path = str(tmp_path / "f.jif")
    snapshot(state, path, page_size=PAGE)
    img = BaseImage.from_jif(path, name="img")
    ref = BaseImage.from_state("img", state, PAGE)
    jref = JBaseImage.from_state("img", values, PAGE)
    for name, _ in flatten_state(state)[0]:
        np.testing.assert_array_equal(img.digests(name), ref.digests(name))
        np.testing.assert_array_equal(
            img.chunk_bytes(name, 0, 4), ref.chunk_bytes(name, 0, 4)
        )
        np.testing.assert_array_equal(ref.digests(name), jref.digests(name))
        np.testing.assert_array_equal(
            ref.chunk_bytes(name, 0, 4), jref.chunk_bytes(name, 0, 4)
        )


# ------------------------------------------------------- two-phase completion
@pytest.mark.parametrize("kind", KINDS)
def test_working_set_event_fires_before_residual(tmp_path, kind):
    state, values = twin(kind, rng_state(3, scale=8))
    names = [n for n, _ in flatten_state(state)[0]]
    ws = names[:3]
    path = str(tmp_path / "f.jif")
    snapshot(state, path, access_order=names, working_set=ws, page_size=PAGE)
    assert_jif_like_jax(kind, path, values, access_order=names, working_set=ws)

    at_ws = {}
    restorer = SpiceRestorer(simulate_read_bw=5e7)
    _, meta, handles, stats = restorer.restore(
        path, wait=False,
        on_working_set=lambda: at_ws.update(complete=stats.complete),
    )
    assert stats.wait_working_set(20)
    assert stats.ws_tensors == 3 and stats.residual_tensors == len(names) - 3
    # at the ws event every ws tensor is resident...
    for n in ws:
        assert handles[n].ready
    # ...and the residual was still streaming when the event fired
    assert at_ws == {"complete": False}
    assert stats.wait_complete(30)
    assert 0 < stats.working_set_s < stats.total_s
    for n in names:
        assert leaf_key(handles[n].wait(10)) == leaf_key(dict(flatten_state(values)[0])[n]), n


@pytest.mark.parametrize("kind", KINDS)
def test_residual_demand_boost_still_works(tmp_path, kind):
    """Waiting on a residual tensor after ws completion demand-boosts it
    ahead of the background stream."""
    state, values = twin(kind, rng_state(4, scale=8))
    names = [n for n, _ in flatten_state(state)[0]]
    path = str(tmp_path / "f.jif")
    snapshot(state, path, access_order=names, working_set=names[:2], page_size=PAGE)
    restorer = SpiceRestorer(simulate_read_bw=3e7)
    _, _, handles, stats = restorer.restore(path, wait=False)
    assert stats.wait_working_set(20)
    tail = names[-1]
    got = handles[tail].wait(20)
    assert leaf_key(got) == leaf_key(dict(flatten_state(values)[0])[tail])
    assert stats.wait_complete(30)


# ------------------------------------------------------------ pipeline stages
@pytest.mark.parametrize("kind", KINDS)
def test_pipeline_stages_compose(tmp_path, kind):
    pipe = SnapshotPipeline(page_size=PAGE)
    state, values = twin(kind, rng_state(1))
    c, stats = pipe.classify(state)
    order, ws, boundary = pipe.relocate(c, access_order=None)
    assert boundary > 0 and set(order) == set(c.names) and ws == order
    path = str(tmp_path / "staged.jif")
    meta = {"tree": c.treedesc, "access_order": order, "working_set": ws}
    pipe.write(path, c, order, meta, None, boundary)
    got, _, _, _ = SpiceRestorer().restore(path)
    assert_state_equal(values, got)
    if kind == "torch":  # the JAX package's stages over the same values
        jpipe = JSnapshotPipeline(page_size=PAGE)
        jc, _ = jpipe.classify(values)
        assert jpipe.relocate(jc, access_order=None) == (order, ws, boundary)
        jpipe.write(path + ".jax", jc, order, dict(meta), None, boundary)
        with open(path, "rb") as f, open(path + ".jax", "rb") as g:
            assert f.read() == g.read()  # the stages stamp no created_at


@pytest.mark.parametrize("kind", KINDS)
def test_trim_stage_still_applies(tmp_path, kind):
    params, values = twin(kind, rng_state(2)["embed"])
    m = np.ones((4096,), np.float32)
    state = {"params": params, "opt": {"m": torch.from_numpy(m) if kind == "torch" else m}}
    path = str(tmp_path / "f.jif")
    trim = lambda s: {"params": s["params"]}  # noqa: E731
    snapshot(state, path, page_size=PAGE, trim_fn=trim)
    got, _, _, _ = SpiceRestorer().restore(path)
    assert "opt" not in got
    assert_state_equal({"params": values}, got)
    assert_jif_like_jax(kind, path, {"params": values, "opt": {"m": m}}, trim_fn=trim)


# ------------------------------------------------------------------ cache O(n)
def test_node_cache_total_bytes_accounting():
    cache = NodeImageCache(capacity_bytes=1 << 30)
    a = BaseImage.from_state("a", {"x": np.ones(4096, np.float32)})
    b = BaseImage.from_state("b", {"x": np.ones(8192, np.float32)})
    cache.put(a)
    assert cache.total_bytes == a.nbytes
    cache.put(b)
    assert cache.total_bytes == a.nbytes + b.nbytes
    # replacing an image must not double-count
    cache.put(BaseImage.from_state("a", {"x": np.ones(2048, np.float32)}))
    assert cache.total_bytes == 2048 * 4 + b.nbytes
    misses = cache.stats["misses"]
    assert cache.get(None) is None
    assert cache.stats["misses"] == misses  # "no base" is not a miss
    # eviction keeps the running total consistent
    cache.capacity = b.nbytes
    cache.put(BaseImage.from_state("c", {"x": np.ones(1024, np.float32)}))
    assert cache.total_bytes == sum(
        img.nbytes for img in cache._images.values()
    )
