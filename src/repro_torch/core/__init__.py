"""The paper's primary contribution: snapshot/restore co-designed with the
runtime — JIF container, overlay dedup, zero pool, node base-image cache,
the Spice restore engine, and the baselines it is evaluated against."""
from repro_torch.core.cache import BaseImage, NodeImageCache
from repro_torch.core.chunkstore import ChunkStore, NodeChunkCache
from repro_torch.core.digest import DIGEST_BYTES, chunk_digests, digest_key
from repro_torch.core.overlay import (
    DEFAULT_PAGE,
    KIND_BASE,
    KIND_PRIVATE,
    KIND_ZERO,
    IntervalTable,
)
from repro_torch.core.iosched import IOStream, PrefetchIOScheduler
from repro_torch.core.lifecycle import SnapshotPipeline, delta_snapshot
from repro_torch.core.memory import (
    KIND_CHUNK_CAS,
    KIND_DEVICE_IMAGE,
    KIND_IMAGE_CACHE,
    KIND_POOL,
    KIND_RESIDUAL,
    KIND_SCRATCH,
    KIND_WORKING_SET,
    MEMORY_KINDS,
    MemoryPressureError,
    MemoryRegion,
    NodeMemoryManager,
)
from repro_torch.core.pool import BufferPool
from repro_torch.core.restore import RestoreStats, SpiceRestorer, TensorHandle
from repro_torch.core.snapshot import SnapshotStats, snapshot
from repro_torch.core.registry import FunctionRegistry, FunctionSpec
from repro_torch.core.upload import DeviceImageCache, DevicePath, UploadStream

__all__ = [
    "SnapshotPipeline",
    "delta_snapshot",
    "BaseImage",
    "NodeImageCache",
    "ChunkStore",
    "NodeChunkCache",
    "DIGEST_BYTES",
    "chunk_digests",
    "digest_key",
    "BufferPool",
    "NodeMemoryManager",
    "MemoryRegion",
    "MemoryPressureError",
    "MEMORY_KINDS",
    "KIND_POOL",
    "KIND_IMAGE_CACHE",
    "KIND_DEVICE_IMAGE",
    "KIND_CHUNK_CAS",
    "KIND_WORKING_SET",
    "KIND_RESIDUAL",
    "KIND_SCRATCH",
    "UploadStream",
    "DeviceImageCache",
    "DevicePath",
    "IOStream",
    "PrefetchIOScheduler",
    "SpiceRestorer",
    "TensorHandle",
    "RestoreStats",
    "snapshot",
    "SnapshotStats",
    "FunctionRegistry",
    "FunctionSpec",
    "IntervalTable",
    "DEFAULT_PAGE",
    "KIND_ZERO",
    "KIND_BASE",
    "KIND_PRIVATE",
]
