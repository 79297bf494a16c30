"""The port's twin of ``tests/test_upload.py``: UploadStream,
DeviceImageCache, the fused restore's equality with the eager path,
install-policy selection on the node, and the device-resident re-restore
economics, case for case on the CPU (where the overlay patch runs its
plain version).  The device image cache and the fused restore also run on
the card (``gpu``): there the patch is the CUDA kernel and the fused
tensors are CUDA tensors."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.core import (
    BaseImage,
    NodeImageCache,
    NodeMemoryManager,
    SpiceRestorer,
    snapshot,
)
from repro_torch.core.restore import TensorHandle
from repro_torch.core.treeutil import flatten_state
from repro_torch.core.upload import SLOT_BYTES, DeviceImageCache, DevicePath, UploadStream
from repro_torch.interop import to_torch
from repro_torch.serve.engine import ServerlessNode, layerwise_state
from repro_torch.serve.instance import InstanceState
from torch_twins import CPU, DEVICES, jax_params, jax_tokens, need_device, port_params, to_numpy

ARCH = "qwen1.5-0.5b"
PROMPT = np.array([[3, 1, 4, 1, 5, 9]], dtype=np.int32)


# ------------------------------------------------------------ UploadStream
def test_upload_stream_full_upload_and_flush():
    up = UploadStream(depth=2, name="t-up", device=CPU)
    try:
        handles = []
        keep = []  # buffers must outlive the async jobs
        for i in range(5):
            h = TensorHandle(f"t{i}", (256,), "float32")
            buf = np.zeros(2048, np.uint8)
            buf[:1024] = np.frombuffer(
                np.full(256, float(i), np.float32).tobytes(), np.uint8
            )
            up.upload_full(h, buf, shape=(256,), dtype="float32", nbytes=1024)
            handles.append(h)
            keep.append(buf)
        assert up.flush(timeout=30)
        for i, h in enumerate(handles):
            arr = h.wait(timeout=5)
            assert isinstance(arr, torch.Tensor)
            assert np.all(to_numpy(arr) == float(i))
        st = up.snapshot_stats()
        assert st["uploads"] == 5
        assert st["uploaded_bytes"] == 5 * 1024
        assert st["failures"] == 0
    finally:
        up.close()
    up.close()  # idempotent


def test_upload_stream_release_called_after_upload_lands():
    """Staging buffers return to their release hook only once the device
    copy finished — the pool re-zeroes them, so an early release would
    corrupt the transfer."""
    released = []
    done = threading.Event()

    def release(buf):
        released.append(buf)
        done.set()

    up = UploadStream(depth=1, device=CPU)
    try:
        h = TensorHandle("t", (16,), "float32")
        buf = np.frombuffer(
            np.arange(16, dtype=np.float32).tobytes(), np.uint8
        ).copy()
        up.upload_full(h, buf, shape=(16,), dtype="float32", nbytes=64,
                       release=release)
        arr = h.wait(timeout=10)
        np.testing.assert_array_equal(
            to_numpy(arr), np.arange(16, dtype=np.float32)
        )
        assert done.wait(10)
        assert released and released[0] is buf
    finally:
        up.close()


def test_upload_stream_failure_fails_handle():
    def broken_install(arr):
        raise RuntimeError("device OOM")

    up = UploadStream(install=broken_install, device=CPU)
    try:
        h = TensorHandle("t", (4,), "float32")
        up.upload_full(h, np.zeros(16, np.uint8), shape=(4,),
                       dtype="float32", nbytes=16)
        with pytest.raises(RuntimeError, match="restore of t failed"):
            h.wait(timeout=10)
        assert up.flush(timeout=10)
        assert up.snapshot_stats()["failures"] == 1
    finally:
        up.close()
    with pytest.raises(RuntimeError, match="closed"):
        up.upload_full(TensorHandle("x", (1,), "float32"),
                       np.zeros(4, np.uint8), shape=(1,),
                       dtype="float32", nbytes=4)


# -------------------------------------------------------- DeviceImageCache
def _base_image(name="b", n_pages=4, page_bytes=512, seed=0):
    page_elems = page_bytes // 4
    raw = np.random.RandomState(seed).randn(
        n_pages * page_elems
    ).astype(np.float32)
    return BaseImage.from_state(name, {"w": raw}, page_size=page_bytes), raw


@pytest.mark.parametrize("device", DEVICES)
def test_device_image_cache_ledger_charge_and_reclaim_rung(device):
    need_device(device)
    base, raw = _base_image()
    mem = NodeMemoryManager(64 << 20)
    cache = DeviceImageCache(device=device)
    cache.attach(mem)
    pages = cache.get_pages(base, "w", 4, 128, np.float32)
    assert pages is not None
    assert isinstance(pages, torch.Tensor) and pages.device.type == device
    np.testing.assert_array_equal(
        to_numpy(pages).reshape(-1), raw
    )
    assert mem.kind_bytes()["device_image"] == cache.resident_bytes() > 0
    mem.audit()
    # second lookup hits without rebuilding
    again = cache.get_pages(base, "w", 4, 128, np.float32)
    assert again is pages
    st = cache.snapshot_stats()
    assert st["hits"] == 1 and st["misses"] == 1
    # the reclaim rung drains the cache and uncharges the ledger
    freed = cache.reclaim(1 << 30)
    assert freed == st["built_bytes"]
    assert cache.resident_entries() == 0
    assert mem.kind_bytes()["device_image"] == 0
    mem.audit()


def test_device_image_cache_mismatch_returns_none():
    base, _ = _base_image(page_bytes=512)
    cache = DeviceImageCache(device=CPU)
    # page geometry disagrees with the base's page size -> host fallback
    assert cache.get_pages(base, "w", 4, 64, np.float32) is None
    # tensor absent from the base -> host fallback
    assert cache.get_pages(base, "nope", 4, 128, np.float32) is None


def test_device_image_cache_pressure_falls_back():
    base, _ = _base_image()
    mem = NodeMemoryManager(1024)  # far too small for the 8 KB of pages
    cache = DeviceImageCache(device=CPU)
    cache.attach(mem)
    assert cache.get_pages(base, "w", 4, 128, np.float32) is None
    assert mem.kind_bytes()["device_image"] == 0
    mem.audit()


# ------------------------------------------------- fused restore equality
@pytest.mark.parametrize("device", DEVICES)
def test_fused_delta_restore_matches_eager(tmp_path, device):
    need_device(device)
    ps = 512
    rng = np.random.RandomState(5)
    base_st = {
        "w0": rng.randn(4 * (ps // 4)).astype(np.float32),
        "w1": rng.randn(3 * (ps // 4) + 7).astype(np.float32),  # tail page
    }
    ft = {k: v.copy() for k, v in base_st.items()}
    ft["w0"][: ps // 4] += 1.0  # one dirty page each
    ft["w1"][: ps // 4] += 1.0
    parent = str(tmp_path / "p.jif")
    delta = str(tmp_path / "d.jif")
    snapshot(base_st, parent, page_size=ps)
    snapshot(ft, delta, parent=parent, page_size=ps)

    cache = NodeImageCache()
    r_ref = SpiceRestorer(
        node_cache=cache, transform=lambda a: to_torch(a, device, copy=True)
    )
    ref_state, _, _, ref_stats = r_ref.restore(delta)
    r_ref.iosched.shutdown()

    up = UploadStream(device=device)
    dpath = DevicePath(upload=up, images=DeviceImageCache(device=device))
    r = SpiceRestorer(node_cache=cache, device_path=dpath)
    state, _, handles, st = r.restore(delta, wait=True)
    r.iosched.shutdown()
    up.close()

    l_ref, _ = flatten_state(ref_state)
    l_fused, _ = flatten_state(state)
    for (n1, a), (n2, b) in zip(l_ref, l_fused):
        assert n1 == n2
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b), err_msg=n1)
    # the fused tensors are real device tensors, not host staging views
    for h in handles.values():
        assert isinstance(h._arr, torch.Tensor) and h._arr.device.type == device
    # only the private pages crossed to device; the patch covered the rest
    assert st.uploaded_bytes == 2 * ps
    assert st.uploaded_bytes < ref_stats.bytes_read + ref_stats.base_bytes
    assert st.patched_on_device_bytes == sum(a.nbytes for a in ft.values())
    assert st.bytes_read == 2 * ps  # reads also shrank to the private runs


# --------------------------------------------------- node install policies
@pytest.fixture(scope="module")
def policy_zoo(tmp_path_factory):
    d = tmp_path_factory.mktemp("policy-zoo")
    cfg = get_config(ARCH).reduced()
    np_params = jax_params(jget_config(ARCH).reduced(), 2)
    return d, cfg, port_params(np_params), np_params


def _publish(node, d, cfg, params, extra=None):
    base_key = "pol-base"
    node.node_cache.put(
        BaseImage.from_state(base_key, layerwise_state(cfg, params)),
        evictable=False,
    )
    tuned = dict(params)
    tuned["final_norm"] = tuned["final_norm"] + 0.01
    node.publish("pol-fn", cfg, tuned, str(d), base_name=base_key,
                 formats=("jif",), warm_ttl_s=60, extra_state=extra)


@pytest.mark.parametrize("install", ["host", "eager", "fused"])
def test_install_policy_end_to_end(policy_zoo, install, tmp_path):
    d, cfg, params, np_params = policy_zoo
    node = ServerlessNode(install=install, device=CPU)
    try:
        _publish(node, tmp_path, cfg, params)
        r = node.invoke("pol-fn", PROMPT, max_new_tokens=3, mode="spice",
                        cfg=cfg)
        assert r.cold
        assert node.scheduler.drain_residual()
        node.memory.audit()
        # every policy generates the same tokens
        node.evict()
        r2 = node.invoke("pol-fn", PROMPT, max_new_tokens=3,
                         mode="spice_sync", cfg=cfg)
        np.testing.assert_array_equal(r.tokens, r2.tokens)
        # ... and they are the JAX package's on the same fine-tune
        tuned = dict(np_params, final_norm=np_params["final_norm"] + np.float32(0.01))
        np.testing.assert_array_equal(
            r.tokens, jax_tokens(jget_config(ARCH).reduced(), tuned, PROMPT, 3))
    finally:
        node.close()


def test_install_policy_callable_and_invalid(policy_zoo):
    calls = []

    def spy(a):
        calls.append(a.nbytes)
        return to_torch(a, CPU, copy=True)

    node = ServerlessNode(install=spy, device=CPU)
    try:
        transform, dpath = node.scheduler._install_policy()
        assert transform is spy and dpath is None
    finally:
        node.close()
    node = ServerlessNode(install="host", device=CPU)
    try:
        transform, dpath = node.scheduler._install_policy()
        assert transform is None and dpath is None
        assert node.scheduler.upload_stream is None
    finally:
        node.close()
    node = ServerlessNode(install="fused", device=CPU)
    try:
        transform, dpath = node.scheduler._install_policy()
        assert transform is None
        assert dpath.upload is node.scheduler.upload_stream
        assert dpath.images is node.scheduler.device_images
        node.scheduler.install = "bogus"
        with pytest.raises(ValueError, match="bogus"):
            node.scheduler._install_policy()
    finally:
        node.close()


# ------------------------------------ device-resident re-restore economics
def test_residual_evict_rerestore_keeps_device_base(policy_zoo, tmp_path):
    """Regression: a residual-evicted instance re-restored under the fused
    policy must read exactly the dropped residual bytes, serve its working
    set from the pinned memory (zero re-uploads for it), and reuse the
    device-resident base without rebuilding a single entry."""
    _d, cfg, params, _ = policy_zoo
    node = ServerlessNode(install="fused", device=CPU)
    try:
        extra = {"opt": np.ones((1 << 20,), np.float32)}  # 4 MB residual
        _publish(node, tmp_path, cfg, params, extra=extra)
        r1 = node.invoke("pol-fn", PROMPT, max_new_tokens=3, mode="spice",
                         cfg=cfg)
        assert r1.cold
        assert node.scheduler.drain_residual()
        inst = node.scheduler.instance("pol-fn")
        residual_bytes = inst.residual_region.nbytes
        images = node.scheduler.device_images
        mid = images.snapshot_stats()
        assert images.resident_bytes() > 0  # base pages live on the device

        freed = node.scheduler.evict_residual("pol-fn")
        assert freed == residual_bytes
        assert inst.state is InstanceState.EVICTED
        node.memory.audit()
        up_before = node.scheduler.upload_stream.snapshot_stats()

        r2 = node.invoke("pol-fn", PROMPT, max_new_tokens=3, mode="spice",
                         cfg=cfg)
        assert r2.cold
        assert node.scheduler.drain_residual()
        d2 = inst.restore_stats.as_dict()
        # reads: exactly the dropped residual (chunk-padded per tensor)
        assert d2["reused_bytes"] > 0
        assert d2["bytes_read"] <= residual_bytes + 4096 * d2["residual_tensors"]
        # uploads: only the residual tensors crossed again — bounded by the
        # bytes re-read plus zero-page patches, nowhere near the image size
        up_after = node.scheduler.upload_stream.snapshot_stats()
        uploaded = up_after["uploaded_bytes"] - up_before["uploaded_bytes"]
        assert uploaded <= residual_bytes + 4096 * d2["residual_tensors"]
        # the device base was NOT rebuilt: no new cache builds (misses)
        after = images.snapshot_stats()
        assert after["misses"] == mid["misses"]
        np.testing.assert_array_equal(r1.tokens, r2.tokens)
        node.memory.audit()
    finally:
        node.close()


# ----------------------------------- direct reads through the staging slots
PS = 512  # page bytes of the direct-read cases
PAGE_F32 = PS // 4


def _randn(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _fused_mixed():
    """One leaf over a base: BASE pages, ZERO page 5, PRIVATE pages 2 and 7."""
    base = {"w": _randn(1, 8 * PAGE_F32)}
    w = base["w"].copy()
    w[2 * PAGE_F32 : 3 * PAGE_F32] += 1.0
    w[5 * PAGE_F32 : 6 * PAGE_F32] = 0.0
    w[7 * PAGE_F32 :] += 1.0
    return base, {"w": w}


def _partial_pages():
    """A tail page in both modes: an all-private leaf and a fused one."""
    base = {"v": _randn(3, 3 * PAGE_F32 + 5)}
    v = base["v"].copy()
    v[3 * PAGE_F32 :] += 1.0  # only the partial last page is private
    return base, {"u": _randn(2, 5 * PAGE_F32 + 37), "v": v}


SLOT_PAGES = SLOT_BYTES // PS

# name -> (base state or None, state, upload slots, restorer
#          io_chunk_bytes, fault)
DIRECT_CASES = {
    # all-PRIVATE, a slot and 3 pages: two ops
    "whole_larger_than_a_slot": (None, {"w": _randn(0, (SLOT_PAGES + 3) * PAGE_F32)},
                                 4, 8 << 20, None),
    "fused_base_zero_private": (*_fused_mixed(), 4, 8 << 20, None),
    "partial_last_page": (*_partial_pages(), 4, 8 << 20, None),
    # ops of 3 pages over 10 and 8 pages: 3, 3, 3, 1 and 3, 3, 2
    "chunk_not_dividing": (None, {"a": _randn(4, 10 * PAGE_F32), "b": _randn(5, 8 * PAGE_F32)},
                           4, 3 * PS, None),
    # 20 ops of one page through one slot: each waits for the last copy
    "more_ops_than_slots": (None, {"w": _randn(6, 20 * PAGE_F32)}, 1, PS, None),
    "failed_read": (None, {"w": _randn(7, 10 * PAGE_F32)}, 2, PS, "read"),
    "cancelled": (None, {"w": _randn(8, 10 * PAGE_F32)}, 2, PS, "cancel"),
}


def _leaf_bytes(x) -> bytes:
    return np.ascontiguousarray(to_numpy(x)).tobytes()


@pytest.mark.parametrize("case", list(DIRECT_CASES))
def test_direct_read_restore(case, tmp_path, monkeypatch):
    """A device-path restore reads its private pages straight into the
    upload stream's slots and copies them from there: the tree is bit for
    bit the eager install's and the JAX package's restore of the same JIF,
    every byte that crossed came through a slot, and every slot comes back
    — after a failed read and after a cancel too."""
    from repro.core import SpiceRestorer as JRestorer
    from repro_torch.core import restore as restore_mod

    base_st, st, depth, chunk, fault = DIRECT_CASES[case]
    parent = None
    if base_st is not None:
        parent = str(tmp_path / "p.jif")
        snapshot(base_st, parent, page_size=PS)
    path = str(tmp_path / "d.jif")
    snapshot(st, path, parent=parent, page_size=PS)

    cache = NodeImageCache()
    r_ref = SpiceRestorer(node_cache=cache, transform=lambda a: to_torch(a, CPU, copy=True))
    ref_state, _, _, _ = r_ref.restore(path)
    r_ref.iosched.shutdown()
    jr = JRestorer()
    j_state, _, _, _ = jr.restore(path)
    jr.iosched.shutdown()
    for k in st:
        assert _leaf_bytes(ref_state[k]) == _leaf_bytes(j_state[k]) == st[k].tobytes(), k

    up = UploadStream(depth=depth, device=CPU)
    dpath = DevicePath(upload=up, images=DeviceImageCache(device=CPU))
    r = SpiceRestorer(node_cache=cache, device_path=dpath, io_chunk_bytes=chunk)
    try:
        if fault == "read":
            real, calls = restore_mod._pread_into, []

            def failing(fd, dst, off):
                calls.append(off)
                if len(calls) == 3:
                    raise OSError("injected read fault")
                return real(fd, dst, off)

            monkeypatch.setattr(restore_mod, "_pread_into", failing)
            with pytest.raises(RuntimeError, match="restore of w failed"):
                r.restore(path, wait=True)
            assert len(calls) == 3
        elif fault == "cancel":
            r.simulate_read_bw = 20 * PS  # one page's op lasts ~50 ms
            _, _, handles, stats = r.restore(path, wait=False)
            deadline = time.monotonic() + 30
            while stats.io_ops < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            r.stream.abort(RuntimeError("cancelled mid-restore"))
            assert r.stream.wait(30) and stats.wait_complete(30)
            assert 2 <= stats.io_ops < 5
            with pytest.raises(RuntimeError, match="restore of w failed"):
                handles["w"].wait(5)
        else:
            state, _, handles, stats = r.restore(path, wait=True)
        assert up.flush(30)
        assert up._slots.idle() == depth  # every slot came back
        if fault is not None:
            return
    finally:
        r.iosched.shutdown()
        up.close()

    for k in st:
        assert isinstance(state[k], torch.Tensor)
        assert _leaf_bytes(state[k]) == _leaf_bytes(ref_state[k]), k
    sent, pages, ops = _expected(path, min(max(chunk // PS, 1), SLOT_PAGES))
    assert stats.uploaded_bytes == stats.pinned_bytes == sent
    assert up.snapshot_stats()["pinned_bytes"] == sent
    assert stats.bytes_read == pages * PS and stats.io_ops == ops


def _expected(path, op_pages):
    """What a device-path restore of ``path`` sends (an all-private leaf
    its bytes, a fused one its private pages whole), the private pages it
    reads, and its read ops of at most ``op_pages`` pages."""
    from repro_torch.core.jif import JifReader

    sent = pages = ops = 0
    with JifReader(path) as r:
        for t in r.tensors:
            it = r.itable(t.name)
            runs = [count for _s, count, _src in it.private_runs()]
            n_priv = sum(runs)
            sent += t.nbytes if n_priv == it.n_pages else n_priv * PS
            pages += n_priv
            ops += sum(-(-n // op_pages) for n in runs)
    return sent, pages, ops


def test_host_staged_zero_pages_read_zero_after_direct_restore(tmp_path):
    """Device-path restores take no pool buffer, and a host-staged leaf
    with ZERO pages that takes a recycled one afterwards still reads zeros
    there, as the JAX package's restore of the same JIF does."""
    from repro.core import SpiceRestorer as JRestorer
    from repro_torch.core import BufferPool

    pool = BufferPool()
    dirty = str(tmp_path / "dirty.jif")
    snapshot({"w": _randn(9, 8 * PAGE_F32)}, dirty, page_size=PS)
    z = _randn(10, 8 * PAGE_F32)
    z[PAGE_F32 : 6 * PAGE_F32] = 0.0  # ZERO pages 1-5
    zpath = str(tmp_path / "zero.jif")
    snapshot({"w": z}, zpath, page_size=PS)

    # a host-staged restore fills a pool buffer with private bytes and
    # hands it back; an all-private device-path restore takes none
    r = SpiceRestorer(pool=pool, transform=lambda a: to_torch(a, CPU, copy=True))
    r_state, _, _, _ = r.restore(dirty)
    r.iosched.shutdown()
    before = pool.snapshot_stats()
    up = UploadStream(device=CPU)
    try:
        r = SpiceRestorer(pool=pool, device_path=DevicePath(upload=up))
        state, _, _, st = r.restore(dirty)
        r.iosched.shutdown()
    finally:
        up.close()
    assert st.pinned_bytes == st.uploaded_bytes == 8 * PS
    assert pool.snapshot_stats() == before
    assert _leaf_bytes(state["w"]) == _leaf_bytes(r_state["w"])

    # the ZERO pages of a host-staged leaf in the recycled buffer
    r = SpiceRestorer(pool=pool)
    host, _, _, zst = r.restore(zpath)
    r.iosched.shutdown()
    assert pool.snapshot_stats()["hits"] == before["hits"] + 1
    assert zst.zero_bytes == 5 * PS
    jr = JRestorer()
    jz, _, _, _ = jr.restore(zpath)
    jr.iosched.shutdown()
    assert _leaf_bytes(host["w"]) == _leaf_bytes(jz["w"]) == z.tobytes()
