"""The port's twin of ``tests/test_chunkstore.py``, case for case, against
``repro_torch.core`` (identical copies of the reference's modules but for
their imports; the port's catalog and node take ``device="cpu"``).
Content-addressed chunk store: CAS refcounting, the node chunk cache and
its ``chunk_cas`` ledger rung, digest plumbing edge cases (v1 backfill
sidecars, non-page-multiple tails, concurrent digest reads), dedup-aware
restore planning, and the catalog/router peer-fetch wiring."""
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import (
    ChunkStore,
    NodeChunkCache,
    NodeImageCache,
    NodeMemoryManager,
    SpiceRestorer,
    digest_key,
    snapshot,
)
from repro_torch.core.digest import chunk_digest, chunk_digests, zero_chunk_digest
from repro_torch.core.jif import JifReader, digest_sidecar_path
from repro_torch.core.memory import KIND_CHUNK_CAS
from repro_torch.core.treeutil import flatten_state

PAGE = 4096
GOLDEN = Path(__file__).parent / "golden" / "jif_v1_small.jif"


def rng_state(seed=0, tail=False):
    r = np.random.RandomState(seed)
    st = {
        "embed": {"tok": r.randn(64, 32).astype(np.float32)},
        "layers": [
            {"w": r.randn(32, 64).astype(np.float32),
             "b": np.zeros((2048,), np.float32)}
            for _ in range(3)
        ],
        "step": np.int64(7),
    }
    if tail:
        # 1000 float32 = 4000 bytes: a single non-page-multiple chunk
        st["odd"] = r.randn(1000).astype(np.float32)
    return st


def assert_state_equal(a, b):
    la, _ = flatten_state(a)
    lb, _ = flatten_state(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=n)


# ----------------------------------------------------------- shared identity
def test_digest_single_definition_shared_everywhere():
    """jif, overlay, and the chunk store must agree on chunk identity."""
    from repro_torch.core import digest, jif, overlay

    assert overlay._DIGEST_BYTES is digest.DIGEST_BYTES
    assert jif._DIGEST_BYTES is digest.DIGEST_BYTES
    assert overlay.chunk_digests is digest.chunk_digests
    buf = np.arange(10000, dtype=np.uint8)
    dg = chunk_digests(memoryview(buf), PAGE)
    assert dg.shape == (3, 16)
    # tail chunk hashed over UNPADDED bytes
    assert bytes(dg[2]) == chunk_digest(buf[2 * PAGE :].tobytes())
    assert zero_chunk_digest(100) == chunk_digest(bytes(100))


# ------------------------------------------------------------------ disk CAS
def test_chunkstore_put_dedup_refcount_unlink(tmp_path):
    store = ChunkStore(str(tmp_path / "cas"))
    data = os.urandom(PAGE)
    dk = chunk_digest(data)
    assert store.put(dk, data) is True
    assert store.put(dk, data) is False  # dedup: refcount bump, no write
    assert store.refcount(dk) == 2
    assert store.stats["bytes_deduped"] == PAGE
    assert store.get(dk) == data
    assert store.decref(dk) is False
    assert store.decref(dk) is True  # last ref: file unlinked
    assert not store.contains(dk)
    assert store.get(dk) is None
    with pytest.raises(KeyError):
        store.decref(dk)
    store.audit()


def test_chunkstore_ingest_jif_dedups_occurrences(tmp_path):
    """Two identical sibling images ingest to ONE physical copy; the second
    manifest is pure dedup."""
    state = rng_state(1)
    pa, pb = str(tmp_path / "a.jif"), str(tmp_path / "b.jif")
    snapshot(state, pa, page_size=PAGE)
    snapshot(state, pb, page_size=PAGE)
    store = ChunkStore(str(tmp_path / "cas"))
    ma, ua, da = store.ingest_jif(pa)
    mb, ub, db = store.ingest_jif(pb)
    assert ma == mb  # identical content -> identical manifests
    assert ua > 0 and ub == 0 and db == ua + da
    store.audit()
    store.release_many(ma)
    store.release_many(mb)
    assert store.audit()["chunks"] == 0


# ------------------------------------------------- digest plumbing edge cases
def test_v1_golden_has_no_digests_without_sidecar(tmp_path):
    p = str(tmp_path / "g.jif")
    shutil.copy(GOLDEN, p)
    with JifReader(p) as r:
        assert not r.has_digests
        assert r.digests("embed/tok") is None


def test_v1_backfill_persists_sidecar_and_matches_content(tmp_path):
    p = str(tmp_path / "g.jif")
    shutil.copy(GOLDEN, p)
    with JifReader(p) as r:
        assert r.ensure_digests()
        assert r.has_digests
        dg = r.digests("embed/tok")
    assert os.path.exists(digest_sidecar_path(p))
    # a FRESH reader loads the sidecar (backfill paid once per image)
    with JifReader(p) as r2:
        assert r2.has_digests
        np.testing.assert_array_equal(r2.digests("embed/tok"), dg)
        # backfilled digests equal digests of the restored bytes
        state, _, _, _ = SpiceRestorer().restore(p)
        raw = np.ascontiguousarray(state["embed"]["tok"]).view(np.uint8).reshape(-1)
        np.testing.assert_array_equal(
            dg, chunk_digests(memoryview(raw), r2.page_size)
        )


def test_stale_sidecar_invalidated_on_identity_change(tmp_path):
    p = str(tmp_path / "g.jif")
    shutil.copy(GOLDEN, p)
    with JifReader(p) as r:
        r.ensure_digests()
    os.utime(p, ns=(1, 1))  # simulate an in-place rewrite (mtime changes)
    with JifReader(p) as r:
        assert not r.has_digests  # stale sidecar must NOT serve


def test_backfill_zero_and_tail_chunks(tmp_path):
    """ZERO runs and a non-page-multiple tail backfill to the same digests
    the writer would have stored."""
    state = rng_state(2, tail=True)
    p = str(tmp_path / "t.jif")
    snapshot(state, p, page_size=PAGE)
    with JifReader(p) as r:
        stored = {t.name: r.digests(t.name) for t in r.tensors}
        assert stored["layers/1/b"] is not None  # all-zero tensor
    # hand-build a digestless (v1-style) image with the same content and
    # verify the backfill reproduces exactly what the v2 writer stored —
    # ZERO runs and the unpadded tail included
    from repro_torch.core import jif as jif_mod
    from repro_torch.core import overlay

    leaves, _ = flatten_state(state)
    # hand-build a digestless (v1-style) image with the same tail layout
    tensors, itables, chunks = [], {}, []
    cursor = 0
    for name, arr in leaves:
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        kinds = overlay.classify(memoryview(raw), PAGE)
        table = overlay.intervals_from_kinds(kinds)
        for row in table:
            if row[2] == overlay.KIND_PRIVATE:
                row[3] = cursor
                cursor += int(row[1])
        itables[name] = table
        t = jif_mod.TensorEntry(
            name=name, dtype=str(arr.dtype),
            shape=tuple(np.asarray(arr).shape), nbytes=raw.nbytes,
        )
        tensors.append(t)
        for start, n, _src in overlay.IntervalTable(table).private_runs():
            chunk = raw[start * PAGE : (start + n) * PAGE]
            pad = (-len(chunk)) % PAGE
            chunks.append(chunk.tobytes() + b"\0" * pad)
    v1 = str(tmp_path / "v1.jif")
    jif_mod.write_jif(
        v1, {"tree": None}, tensors, itables, chunks, PAGE, digests=None
    )
    with JifReader(v1) as r:
        assert not r.has_digests
        r.ensure_digests()
        for name, arr in leaves:
            raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
            np.testing.assert_array_equal(
                r.digests(name), chunk_digests(memoryview(raw), PAGE),
                err_msg=name,
            )


def test_concurrent_digest_reads(tmp_path):
    """JifReader.digests is pread-based: many threads reading digest rows
    concurrently must all see identical data."""
    state = rng_state(3)
    p = str(tmp_path / "c.jif")
    snapshot(state, p, page_size=PAGE)
    with JifReader(p) as r:
        names = [t.name for t in r.tensors]
        expect = {n: r.digests(n).copy() for n in names}
        errors = []

        def hammer():
            try:
                for _ in range(20):
                    for n in names:
                        np.testing.assert_array_equal(r.digests(n), expect[n])
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors


# ------------------------------------------------- node cache + ledger rung
def test_chunk_cache_charges_ledger_and_demotes_under_pressure(tmp_path):
    store = ChunkStore(str(tmp_path / "cas"))
    mem = NodeMemoryManager(64 * PAGE)
    cache = NodeChunkCache(store, node="n0")
    cache.attach(mem)
    payloads = {chunk_digest(bytes([i]) * PAGE): bytes([i]) * PAGE for i in range(8)}
    for dk, data in payloads.items():
        cache.ingest(dk, data)
    assert mem.kind_bytes()[KIND_CHUNK_CAS] == 8 * PAGE
    assert mem.high_water()[KIND_CHUNK_CAS] == 8 * PAGE
    mem.audit()
    # pressure: demote to the disk tier; chunks stay one CAS read away
    freed = mem.reclaim(3 * PAGE)
    assert freed >= 3 * PAGE
    assert mem.kind_bytes()[KIND_CHUNK_CAS] <= 5 * PAGE
    for dk, data in payloads.items():
        assert cache.probe(dk) in ("ram", "cas")
        got = cache.get(dk) or cache.get_cas(dk)
        assert got == data
    mem.audit()
    cache.release_all()
    assert mem.kind_bytes()[KIND_CHUNK_CAS] == 0
    assert store.audit()["chunks"] == 0
    mem.audit()


def test_chunk_cache_ram_reject_keeps_disk_tier(tmp_path):
    """A ledger that cannot admit RAM bytes must not lose the chunk — it
    stays served from the disk tier."""
    store = ChunkStore(str(tmp_path / "cas"))
    mem = NodeMemoryManager(2 * PAGE)
    cache = NodeChunkCache(store, node="n0")
    cache.attach(mem)
    datas = [bytes([i]) * PAGE for i in range(6)]
    for d in datas:
        cache.ingest(chunk_digest(d), d)
    assert cache.snapshot_stats()["ram_rejects"] > 0
    for d in datas:
        assert cache.get_cas(chunk_digest(d)) == d
    mem.audit()


# ------------------------------------------------------ dedup-aware restore
def _dedup_restorer(tmp_path, cache):
    return SpiceRestorer(
        node_cache=NodeImageCache(), chunks=cache, pipelined=False
    )


def test_dedup_restore_is_byte_identical_and_skips_shared_reads(tmp_path):
    base = rng_state(5, tail=True)
    parent = str(tmp_path / "p.jif")
    snapshot(base, parent, page_size=PAGE)
    # two sibling fine-tunes with the SAME modification: their private
    # chunks are content-identical, so the second restore should pull ~0
    ca, cb = dict(base), dict(base)
    bump = base["layers"][0]["w"] + 1.5
    ca = {**base, "layers": [dict(l) for l in base["layers"]]}
    cb = {**base, "layers": [dict(l) for l in base["layers"]]}
    ca["layers"][0]["w"] = bump
    cb["layers"][0]["w"] = bump.copy()
    pa, pb = str(tmp_path / "a.jif"), str(tmp_path / "b.jif")
    snapshot(ca, pa, parent=parent, page_size=PAGE)
    snapshot(cb, pb, parent=parent, page_size=PAGE)

    plain_a, _, _, _ = SpiceRestorer(node_cache=NodeImageCache()).restore(pa)
    plain_b, _, _, _ = SpiceRestorer(node_cache=NodeImageCache()).restore(pb)

    store = ChunkStore(str(tmp_path / "cas"))
    cache = NodeChunkCache(store, node="n0")
    shared_images = NodeImageCache()
    r1 = SpiceRestorer(node_cache=shared_images, chunks=cache, pipelined=False)
    got_a, _, _, st_a = r1.restore(pa)
    r2 = SpiceRestorer(node_cache=shared_images, chunks=cache, pipelined=False)
    got_b, _, _, st_b = r2.restore(pb)

    # dedup must never change restored bytes
    assert_state_equal(plain_a, got_a)
    assert_state_equal(plain_b, got_b)
    # second sibling: every private chunk already in the node cache
    assert st_b.bytes_read == 0
    assert st_b.chunk_resident_bytes + st_b.chunk_cas_bytes > 0
    assert st_b.chunk_plan_miss == 0
    assert st_b.chunk_plan_resident + st_b.chunk_plan_cas > 0
    assert st_a.bytes_read > 0  # first occurrence genuinely pulled
    store.audit()


def test_dedup_restore_of_v1_image_via_backfill(tmp_path):
    """A pre-v2 image participates in dedup through the backfill sidecar."""
    p1, p2 = str(tmp_path / "g1.jif"), str(tmp_path / "g2.jif")
    shutil.copy(GOLDEN, p1)
    shutil.copy(GOLDEN, p2)
    plain, _, _, _ = SpiceRestorer().restore(p1)
    store = ChunkStore(str(tmp_path / "cas"))
    cache = NodeChunkCache(store, node="n0")
    _, _, _, st1 = SpiceRestorer(chunks=cache, pipelined=False).restore(p1)
    got, _, _, st2 = SpiceRestorer(chunks=cache, pipelined=False).restore(p2)
    assert_state_equal(plain, got)
    assert st1.bytes_read > 0
    assert st2.bytes_read == 0  # content-identical copy: all cache hits
    assert os.path.exists(digest_sidecar_path(p1))


# ----------------------------------------------------------- peer fetch path
def test_router_wires_peer_fetch_between_node_caches(tmp_path):
    from repro_torch.serve.cluster import ClusterRouter, FunctionCatalog
    from repro_torch.serve.node import NodeScheduler

    store = ChunkStore(str(tmp_path / "cas"))
    catalog = FunctionCatalog(chunk_store=store, device="cpu")
    nodes = [
        NodeScheduler(registry=catalog.registry, name=f"node{i}",
                      chunks=NodeChunkCache(store, node=f"node{i}"), device="cpu")
        for i in range(2)
    ]
    router = ClusterRouter(catalog, nodes, interconnect_bw=1e9)
    data = os.urandom(PAGE)
    dk = chunk_digest(data)
    nodes[0].chunks.ingest(dk, data)  # announces into the catalog index
    assert catalog.chunk_holders(dk) == ("node0",)
    assert not nodes[1].chunks.holds(dk)
    got = nodes[1].chunks.fetch_peer(dk)
    assert got == data
    assert router.stats["peer_fetches"] == 1
    assert router.stats["peer_fetch_bytes"] == PAGE
    # the fetch installed the chunk locally: second lookup is a local hit
    assert nodes[1].chunks.probe(dk) == "ram"
    assert set(catalog.chunk_holders(dk)) == {"node0", "node1"}
    router.audit()
    router.close()
    assert store.refcount(dk) == 0
    store.audit()


def test_publish_ingests_and_republish_releases_old_manifest(tmp_path):
    from repro_torch.serve.cluster import FunctionCatalog

    store = ChunkStore(str(tmp_path / "cas"))
    catalog = FunctionCatalog(chunk_store=store, device="cpu")
    state = rng_state(8)
    p = str(tmp_path / "f.jif")
    snapshot(state, p, page_size=PAGE)
    catalog._ingest_chunks("f", p)
    n1 = store.audit()["chunks"]
    assert n1 > 0
    # republishing identical content must not grow the store or leak refs
    refs_before = store.audit()["refs"]
    catalog._ingest_chunks("f", p)
    assert store.audit()["chunks"] == n1
    assert store.audit()["refs"] == refs_before


# --------------------------------------------------- refcount property test
@pytest.mark.parametrize("seed", [7, 1234])
def test_refcount_property_random_interleavings(tmp_path, seed):
    """Random publish/evict/restore-style interleavings never orphan or
    double-free a CAS chunk; audit stays clean throughout."""
    rng = np.random.RandomState(seed)
    store = ChunkStore(str(tmp_path / "cas"))
    mem = NodeMemoryManager(32 * PAGE)
    caches = [NodeChunkCache(store, node=f"n{i}") for i in range(2)]
    for c in caches:
        c.attach(mem)

    # a small universe of images sharing chunks (sibling fine-tunes)
    images = []
    base = rng_state(20)
    for i in range(3):
        st = {**base, "layers": [dict(l) for l in base["layers"]]}
        st["layers"][i % 3]["w"] = st["layers"][i % 3]["w"] + float(i % 2)
        p = str(tmp_path / f"img{i}.jif")
        snapshot(st, p, page_size=PAGE)
        images.append(p)

    manifests = {}  # path -> live manifest ("published")
    pool = [chunk_digest(bytes([i]) * PAGE) for i in range(10)]

    for step in range(120):
        op = rng.randint(5)
        if op == 0:  # publish (or republish) an image
            p = images[rng.randint(len(images))]
            old = manifests.pop(p, None)
            manifests[p] = store.ingest_jif(p)[0]
            if old:
                store.release_many(old)
        elif op == 1 and manifests:  # unpublish
            p = list(manifests)[rng.randint(len(manifests))]
            store.release_many(manifests.pop(p))
        elif op == 2:  # a restore ingests chunks into a node cache
            c = caches[rng.randint(2)]
            i = rng.randint(len(pool))
            c.ingest(pool[i], bytes([i]) * PAGE)
        elif op == 3:  # node-local eviction of one chunk
            c = caches[rng.randint(2)]
            i = rng.randint(len(pool))
            if c.holds(pool[i]):
                c.drop(pool[i])
        else:  # memory pressure demotes RAM chunks
            mem.reclaim(rng.randint(1, 8) * PAGE)
        if step % 10 == 0:
            store.audit()
            mem.audit()

    store.audit()
    for p in list(manifests):
        store.release_many(manifests.pop(p))
    for c in caches:
        c.release_all()
    assert store.audit() == {"chunks": 0, "refs": 0}
    assert mem.kind_bytes()[KIND_CHUNK_CAS] == 0
    mem.audit()
