"""JIF — Joint Image Format (the paper's ELF-inspired snapshot container).

One self-contained file holding everything needed to restore a model
instance::

    magic "JIF1" | u32 header_len | msgpack header | pad(64)
    | per-tensor interval tables (raw little-endian int64, zero-deserialize)
    | per-tensor chunk digests (raw (n,16) uint8 blake2b, v2 only)
    | pad(4096)
    | data segment: PRIVATE chunks, contiguous, in first-access order

The header carries batched metadata (pytree structure descriptor, dtypes/
shapes, logical sharding axes, access order, RNG/step/arch config) so the
whole metadata restore is ONE decode — no per-resource replay.  The data
segment layout enables restoring the working set with a single sequential
high-throughput read.

Version 2 additions (the v1 layout above is still read transparently):

* ``ws_boundary`` — the data-segment chunk where the traced working set
  ends: everything before it restores with one sequential read before
  execution resumes; everything after is residual background prefetch.
* ``parent`` — optional on-disk parent reference for delta snapshots: the
  image only stores chunks that differ from the parent JIF, and restore
  resolves BASE chunks through the parent chain (bootstrapping the node
  cache from disk when needed).
* per-tensor chunk digests — stored raw so a child snapshot can classify
  against this image without materializing its data segment.
"""
from __future__ import annotations

import dataclasses
import io
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import msgpack
import numpy as np

from repro_torch.core.digest import DIGEST_BYTES as _DIGEST_BYTES
from repro_torch.core.digest import chunk_digest, zero_chunk_digest
from repro_torch.core.overlay import IntervalTable

MAGIC = b"JIF1"
ALIGN_TABLE = 64
ALIGN_DATA = 4096
VERSION = 2

# v1 images carry no digest region; backfilled digests are persisted next to
# the image so the hash cost is paid once per image, not once per restore
SIDECAR_SUFFIX = ".digests"


def digest_sidecar_path(path: str) -> str:
    return path + SIDECAR_SUFFIX


@dataclasses.dataclass
class TensorEntry:
    name: str
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    itable_off: int = 0
    itable_rows: int = 0
    digest_off: int = 0  # 0 = no stored digests (v1 images)
    digest_rows: int = 0

    def to_header(self) -> Dict:
        return {
            "name": self.name,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "nbytes": self.nbytes,
            "itable_off": self.itable_off,
            "itable_rows": self.itable_rows,
            "digest_off": self.digest_off,
            "digest_rows": self.digest_rows,
        }

    @classmethod
    def from_header(cls, d: Dict) -> "TensorEntry":
        return cls(
            name=d["name"],
            dtype=d["dtype"],
            shape=tuple(d["shape"]),
            nbytes=d["nbytes"],
            itable_off=d["itable_off"],
            itable_rows=d["itable_rows"],
            digest_off=d.get("digest_off", 0),
            digest_rows=d.get("digest_rows", 0),
        )


def _pad(f, align: int):
    off = f.tell()
    rem = off % align
    if rem:
        f.write(b"\0" * (align - rem))


def write_jif(
    path: str,
    meta: Dict[str, Any],
    tensors: List[TensorEntry],
    itables: Dict[str, np.ndarray],
    data_chunks: Iterable[bytes],
    page_size: int,
    base_ref: Optional[Dict] = None,
    digests: Optional[Dict[str, np.ndarray]] = None,
    ws_boundary: Optional[int] = None,
) -> Dict[str, int]:
    """Write atomically (tmp + rename). Returns offsets/stats."""
    tmp = path + ".tmp"
    BIG = 2**62  # worst-case-width placeholders: patched header never grows
    with open(tmp, "wb", buffering=1024 * 1024) as f:
        f.write(MAGIC + b"\0\0\0\0")

        for t in tensors:  # rows known up front; offsets patched after layout
            t.itable_rows = np.ascontiguousarray(itables[t.name], np.int64).reshape(-1, 4).shape[0]
            t.itable_off = BIG
            if digests is not None and t.name in digests:
                t.digest_rows = len(digests[t.name])
                t.digest_off = BIG
        draft = _encode_header(meta, tensors, page_size, base_ref, BIG, BIG, ws_boundary)
        f.write(draft)
        _pad(f, ALIGN_TABLE)

        table_region = f.tell()
        for t in tensors:
            it = np.ascontiguousarray(itables[t.name], np.int64).reshape(-1, 4)
            _pad(f, ALIGN_TABLE)
            t.itable_off = f.tell()
            f.write(it.tobytes())

        if digests is not None:
            for t in tensors:
                dg = digests.get(t.name)
                if dg is None:
                    continue
                _pad(f, ALIGN_TABLE)
                t.digest_off = f.tell()
                f.write(np.ascontiguousarray(dg, np.uint8).tobytes())

        _pad(f, ALIGN_DATA)
        data_off = f.tell()
        data_len = 0
        for chunk in data_chunks:
            f.write(chunk)
            data_len += len(chunk)
        f.flush()
        os.fsync(f.fileno())

    # patch the header in place with final offsets (pad to reserved size)
    final = _encode_header(meta, tensors, page_size, base_ref, data_off, data_len, ws_boundary)
    assert len(final) <= len(draft), "header grew past its reservation"
    with open(tmp, "r+b") as f:
        f.seek(0)
        # u32 holds the TRUE header length; the reservation slack stays as
        # padding between header and tables (offsets are absolute anyway)
        f.write(MAGIC + len(final).to_bytes(4, "little"))
        f.write(final + b"\0" * (len(draft) - len(final)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return {"data_off": data_off, "data_len": data_len, "table_region": table_region}


def _encode_header(meta, tensors, page_size, base_ref, data_off, data_len, ws_boundary=None) -> bytes:
    header = {
        "version": VERSION,
        "page_size": page_size,
        "base": base_ref,
        "meta": meta,
        "tensors": [t.to_header() for t in tensors],
        "data_off": data_off,
        "data_len": data_len,
    }
    if ws_boundary is not None:
        header["ws_boundary"] = ws_boundary
    if base_ref and base_ref.get("path"):
        header["parent"] = base_ref
    return msgpack.packb(header, use_bin_type=True)


class JifReader:
    """Header + interval tables in two small reads; data via pread ranges.

    All post-construction reads go through ``os.pread`` on the shared fd, so
    one reader is safe under concurrent itable/digest/data loads from the
    scheduler's threads (no shared seek pointer)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            magic = self._f.read(4)
            if magic != MAGIC:
                raise ValueError(f"{path}: not a JIF file")
            hlen = int.from_bytes(self._f.read(4), "little")
            self.header = msgpack.unpackb(self._f.read(hlen), raw=False)
            self.version: int = self.header.get("version", 1)
            self.page_size: int = self.header["page_size"]
            self.meta: Dict = self.header["meta"]
            self.base_ref = self.header.get("base")
            self.data_off: int = self.header["data_off"]
            self.data_len: int = self.header["data_len"]
            self.tensors = [TensorEntry.from_header(d) for d in self.header["tensors"]]
            self.by_name = {t.name: t for t in self.tensors}
        except BaseException:
            self._f.close()  # a corrupt image must not leak the fd to GC
            raise
        self._itables: Dict[str, IntervalTable] = {}
        # backfilled digests for v1 images: loaded lazily from the sidecar
        # (or computed by ensure_digests); None = not yet probed
        self._sidecar: Optional[Dict[str, np.ndarray]] = None
        self._sidecar_probed = False

    @property
    def n_data_chunks(self) -> int:
        return -(-self.data_len // self.page_size)

    @property
    def ws_boundary(self) -> int:
        """Data-segment chunk where the traced working set ends.  v1 images
        carry no boundary: the whole data segment is the working set."""
        ws = self.header.get("ws_boundary")
        return self.n_data_chunks if ws is None else int(ws)

    @property
    def parent(self) -> Optional[Dict]:
        """On-disk parent ref ({name, path}) for delta images, else None."""
        p = self.header.get("parent")
        if p is None and self.base_ref and self.base_ref.get("path"):
            p = self.base_ref
        return p

    # --- metadata restore: batched, zero-deserialize interval tables -------
    def itable(self, name: str) -> IntervalTable:
        if name not in self._itables:
            t = self.by_name[name]
            raw = os.pread(self._f.fileno(), t.itable_rows * 4 * 8, t.itable_off)
            self._itables[name] = IntervalTable(
                np.frombuffer(raw, np.int64).reshape(-1, 4)
            )
        return self._itables[name]

    def load_all_itables(self) -> None:
        for t in self.tensors:
            self.itable(t.name)

    def digests(self, name: str) -> Optional[np.ndarray]:
        """Per-tensor chunk digests ((n, 16) uint8): the stored v2 digest
        region, else a backfill sidecar if one exists, else None."""
        t = self.by_name[name]
        if not t.digest_off:
            side = self._load_sidecar()
            return side.get(name) if side else None
        raw = os.pread(self._f.fileno(), t.digest_rows * _DIGEST_BYTES, t.digest_off)
        return np.frombuffer(raw, np.uint8).reshape(-1, _DIGEST_BYTES)

    @property
    def has_digests(self) -> bool:
        """True when every tensor has digests available — stored in the
        image (v2) or backfilled via a valid sidecar (v1)."""
        if not self.tensors:
            return False
        if all(t.digest_off for t in self.tensors):
            return True
        side = self._load_sidecar()
        if not side:
            return False
        return all(t.digest_off or t.name in side for t in self.tensors)

    # --- v1 digest backfill (persisted sidecar) -----------------------------
    def _binding(self) -> Dict[str, int]:
        st = os.stat(self.path)
        return {"mtime_ns": st.st_mtime_ns, "size": st.st_size}

    def _load_sidecar(self) -> Optional[Dict[str, np.ndarray]]:
        """Load (once) the ``<path>.digests`` sidecar, if present and still
        bound to THIS file's identity (a rewritten image invalidates it)."""
        if self._sidecar_probed:
            return self._sidecar
        self._sidecar_probed = True
        sp = digest_sidecar_path(self.path)
        try:
            with open(sp, "rb") as f:
                doc = msgpack.unpackb(f.read(), raw=False)
            if doc.get("binding") != self._binding():
                return None  # stale: the jif was rewritten since backfill
            self._sidecar = {
                name: np.frombuffer(raw, np.uint8).reshape(-1, _DIGEST_BYTES)
                for name, raw in doc["tensors"].items()
            }
        except (OSError, ValueError, msgpack.UnpackException):
            return None
        return self._sidecar

    def write_digest_sidecar(self, digests: Dict[str, np.ndarray]) -> None:
        """Persist backfilled digests next to the image (atomic tmp+rename),
        bound to the jif's current identity, and adopt them in-process."""
        doc = {
            "binding": self._binding(),
            "tensors": {
                name: np.ascontiguousarray(dg, np.uint8).tobytes()
                for name, dg in digests.items()
            },
        }
        sp = digest_sidecar_path(self.path)
        tmp = sp + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(doc, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, sp)
        self._sidecar = {
            name: np.frombuffer(doc["tensors"][name], np.uint8).reshape(-1, _DIGEST_BYTES)
            for name in doc["tensors"]
        }
        self._sidecar_probed = True

    def ensure_digests(self, base=None, write_sidecar: bool = True) -> bool:
        """Backfill digests for a pre-v2 image so it participates in dedup.

        Hashes each tensor's chunks from what the image already encodes:
        PRIVATE chunks from the data segment (unpadded tails), ZERO chunks
        as zero runs, BASE chunks from ``base`` (a resolved
        :class:`~repro_torch.core.cache.BaseImage`).  A delta image with BASE
        chunks and no ``base`` raises ``ValueError`` — its bytes are not in
        this file.  Persists a sidecar by default so the hash cost is paid
        once per image.  Returns True once digests cover every tensor."""
        if self.has_digests:
            return True
        ps = self.page_size
        out: Dict[str, np.ndarray] = {}
        for t in self.tensors:
            if t.digest_off:
                continue
            n = max(1, -(-t.nbytes // ps))
            dg = np.empty((n, _DIGEST_BYTES), np.uint8)

            def clen(page: int) -> int:  # unpadded length of chunk `page`
                return min(ps, t.nbytes - page * ps)

            for start, count, kind, src in self.itable(t.name).table:
                start, count, kind, src = int(start), int(count), int(kind), int(src)
                if kind == 2:  # PRIVATE: hash straight from the data segment
                    raw = self.pread_chunks(src, count)
                    for j in range(count):
                        dg[start + j] = np.frombuffer(
                            chunk_digest(raw[j * ps : j * ps + clen(start + j)]),
                            np.uint8,
                        )
                elif kind == 0:  # ZERO
                    for j in range(count):
                        dg[start + j] = np.frombuffer(
                            zero_chunk_digest(clen(start + j)), np.uint8
                        )
                else:  # BASE: bytes live in the parent, not this file
                    if base is None:
                        raise ValueError(
                            f"{self.path}: tensor {t.name!r} has BASE chunks; "
                            "backfilling digests needs the resolved base image"
                        )
                    raw = np.ascontiguousarray(
                        base.chunk_bytes(t.name, start, count), np.uint8
                    ).tobytes()
                    for j in range(count):
                        dg[start + j] = np.frombuffer(
                            chunk_digest(raw[j * ps : j * ps + clen(start + j)]),
                            np.uint8,
                        )
            out[t.name] = dg
        if write_sidecar:
            self.write_digest_sidecar(out)
        else:
            self._sidecar = dict(out)
            self._sidecar_probed = True
        return True

    # --- data segment I/O ---------------------------------------------------
    def pread_chunks(self, chunk_start: int, n: int) -> bytes:
        """Read n private chunks starting at data-segment chunk offset."""
        off = self.data_off + chunk_start * self.page_size
        ln = min(n * self.page_size, self.data_len - chunk_start * self.page_size)
        return os.pread(self._f.fileno(), ln, off)

    def pread_range(self, byte_off: int, nbytes: int) -> bytes:
        return os.pread(self._f.fileno(), nbytes, self.data_off + byte_off)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
