"""Overlay tables: the Overlay-VMA analogue.

Each tensor's bytes are split into fixed-size chunks ("pages").  Chunks are
classified {ZERO, BASE, PRIVATE}: ZERO chunks are never stored or fetched
(satisfied from the zero pool), BASE chunks are deduplicated against a shared
base image (the page-cache analogue), PRIVATE chunks are the sparse overlay
stored in the JIF.  The classification is run-length encoded into a flat,
sorted interval table — the paper's "pre-balanced B-tree stored in a compact
binary format that requires no deserialization at restore time" — and looked
up by binary search.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# chunk identity lives in repro_torch.core.digest (shared with jif/lifecycle/
# chunkstore); re-exported here for back-compat with existing callers
from repro_torch.core.digest import DIGEST_BYTES as _DIGEST_BYTES
from repro_torch.core.digest import chunk_digests

KIND_ZERO = 0
KIND_BASE = 1
KIND_PRIVATE = 2

DEFAULT_PAGE = 64 * 1024  # 16 OS pages; hash/dedup granularity


def n_chunks(nbytes: int, page_size: int) -> int:
    return max(1, -(-nbytes // page_size))


def zero_mask(buf: memoryview, page_size: int) -> np.ndarray:
    """(n,) bool: True where the chunk is entirely zero (vectorized)."""
    buf = memoryview(buf).cast("B")
    nb = len(buf)
    n = n_chunks(nb, page_size)
    full = nb // page_size
    mask = np.zeros((n,), bool)
    if full:
        body = np.frombuffer(buf[: full * page_size], np.uint8).reshape(full, page_size)
        mask[:full] = ~body.any(axis=1)
    if full < n:
        tail = np.frombuffer(buf[full * page_size :], np.uint8)
        mask[full] = not tail.any()
    return mask


def classify(
    buf: memoryview,
    page_size: int,
    base_digests: Optional[np.ndarray] = None,
    digests: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(n,) uint8 chunk kinds for one tensor's bytes.  Pass precomputed
    ``digests`` of ``buf`` to avoid hashing twice (the snapshot pipeline
    hashes every tensor anyway for the v2 digest region)."""
    zm = zero_mask(buf, page_size)
    kinds = np.full(zm.shape, KIND_PRIVATE, np.uint8)
    kinds[zm] = KIND_ZERO
    if base_digests is not None and len(base_digests):
        dg = digests if digests is not None else chunk_digests(buf, page_size)
        m = min(len(dg), len(base_digests))
        same = (dg[:m] == base_digests[:m]).all(axis=1)
        # BASE beats ZERO only when the base chunk is also zero — prefer ZERO
        # (cheaper: no copy at all), so only flip PRIVATE chunks to BASE.
        flip = same & (kinds[:m] == KIND_PRIVATE)
        kinds[:m][flip] = KIND_BASE
    return kinds


def intervals_from_kinds(kinds: np.ndarray) -> np.ndarray:
    """Run-length encode kinds -> (n_iv, 4) int64 [start, count, kind, src].

    ``src`` (private-data chunk offset within the JIF data segment) is filled
    in by the snapshot writer; -1 otherwise.
    """
    if len(kinds) == 0:
        return np.zeros((0, 4), np.int64)
    change = np.flatnonzero(np.diff(kinds.astype(np.int16))) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(kinds)]])
    out = np.empty((len(starts), 4), np.int64)
    out[:, 0] = starts
    out[:, 1] = ends - starts
    out[:, 2] = kinds[starts]
    out[:, 3] = -1
    return out


class IntervalTable:
    """Binary-searchable interval view (flat int64 array, zero-deserialize)."""

    def __init__(self, table: np.ndarray):
        self.table = np.ascontiguousarray(table, np.int64).reshape(-1, 4)
        self._starts = self.table[:, 0]

    def lookup(self, page: int) -> Tuple[int, int]:
        """-> (kind, src_chunk or -1) for one page index."""
        i = int(np.searchsorted(self._starts, page, side="right")) - 1
        start, count, kind, src = self.table[i]
        assert start <= page < start + count, "page out of table range"
        off = src + (page - start) if src >= 0 else -1
        return int(kind), int(off)

    def counts(self) -> Dict[int, int]:
        out = {KIND_ZERO: 0, KIND_BASE: 0, KIND_PRIVATE: 0}
        for start, count, kind, _ in self.table:
            out[int(kind)] += int(count)
        return out

    @property
    def n_pages(self) -> int:
        if len(self.table) == 0:
            return 0
        return int(self.table[-1, 0] + self.table[-1, 1])

    def private_runs(self):
        """Yield (page_start, n, src_chunk) runs of PRIVATE chunks."""
        for start, count, kind, src in self.table:
            if kind == KIND_PRIVATE:
                yield int(start), int(count), int(src)

    def base_runs(self):
        for start, count, kind, _ in self.table:
            if kind == KIND_BASE:
                yield int(start), int(count)
