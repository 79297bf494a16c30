"""The restore's page-locked staging slots on the card: an all-private
restore (the shape of the mamba2 fine-tune's upper layers: leaves larger
than a slot) crosses host memory once, from the upload stream's slots,
with no pageable copy, the bytes of the eager install, and no page-locked
allocation after the first cold start.  The CPU cases of the same path are
``tests/test_torch_upload.py::test_direct_read_restore``."""
import numpy as np
import pytest
import torch

from repro_torch.core import NodeMemoryManager, SpiceRestorer, snapshot
from repro_torch.core.upload import DeviceImageCache, DevicePath, UploadStream


def _host_allocs() -> int:
    """Page-locked blocks the caching host allocator has created so far."""
    st = torch.cuda.host_memory_stats()
    return int(st.get("num_host_alloc", st.get("allocations.allocated", 0)))


@pytest.mark.gpu
def test_all_private_cold_start_copies_from_pinned_slots(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the slots are page-locked only there")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(30)
    # 24 MiB and 18 MiB leaves span several 8 MiB slots; one tail page
    state = {
        "in_proj": rng.standard_normal(6 << 20, dtype=np.float32),
        "out_proj": rng.standard_normal((3 << 20) + (3 << 19), dtype=np.float32),
        "norm": rng.standard_normal(1536 + 7, dtype=np.float32),
    }
    path = str(tmp_path / "all-private.jif")
    snapshot(state, path)

    eager = SpiceRestorer(transform=lambda a: torch.from_numpy(np.array(a)).cuda())
    want, _, _, _ = eager.restore(path)
    eager.iosched.shutdown()

    mem = NodeMemoryManager(4 << 30)
    up = UploadStream(device="cuda")
    up.attach(mem)
    dpath = DevicePath(upload=up, images=DeviceImageCache(device="cuda"))
    try:
        assert up._slots.host.is_pinned()
        assert mem.kind_bytes()["pool"] == up.depth * up.slot_bytes

        def cold_start():
            r = SpiceRestorer(device_path=dpath)
            got, _, _, st = r.restore(path, wait=True)
            r.iosched.shutdown()
            torch.cuda.synchronize()
            return got, st

        got, st = cold_start()  # the first builds nothing the later need
        allocs = _host_allocs()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got2, st2 = cold_start()
        got3, st3 = cold_start()
        assert _host_allocs() == allocs
    finally:
        up.close()
    assert mem.kind_bytes()["pool"] == 0

    nbytes = sum(a.nbytes for a in state.values())
    for s in (st, st2, st3):
        assert s.pinned_bytes == s.uploaded_bytes == nbytes
    for tree in (got, got2, got3):
        for k, a in want.items():
            assert tree[k].device.type == "cuda"
            assert torch.equal(tree[k], a), k
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() != DeviceType.CPU]
    copies = [n for n in names if "HtoD" in n]
    assert copies and all("Pinned" in n for n in copies), sorted(set(copies))
    assert not any("Pageable" in n for n in names)
