"""Chunk identity — THE single definition of the content digest.

Chunk digests are first-class identity across the whole stack: the snapshot
writer stores them in the JIF v2 digest region, overlay classification
compares them against a base, and the content-addressed chunk store
(:mod:`repro_torch.core.chunkstore`) keys its on-disk CAS and the node-resident
chunk cache by them.  All three MUST agree on the hash function, its width,
and the chunking convention (the final chunk of a tensor is hashed over its
*unpadded* tail bytes), or identity silently diverges — so the constants and
helpers live here and everywhere else imports them.
"""
from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np

__all__ = [
    "DIGEST_BYTES",
    "chunk_digest",
    "chunk_digests",
    "digest_key",
    "zero_chunk_digest",
]

# blake2b truncated to 16 bytes: collision-safe at cluster scale while
# keeping the per-tensor digest region (n_chunks x 16) small enough to read
# in one pread at restore-planning time.
DIGEST_BYTES = 16


def chunk_digest(data) -> bytes:
    """Digest of ONE chunk's (unpadded) bytes."""
    return hashlib.blake2b(data, digest_size=DIGEST_BYTES).digest()


def chunk_digests(buf: memoryview, page_size: int) -> np.ndarray:
    """(n, 16) uint8 blake2b digests per chunk of ``buf``.  The last chunk
    is hashed over the actual tail length, not padded to ``page_size`` —
    restore-side CAS lookups must truncate the same way."""
    buf = memoryview(buf).cast("B")
    n = max(1, -(-len(buf) // page_size))
    out = np.empty((n, DIGEST_BYTES), np.uint8)
    for i in range(n):
        h = hashlib.blake2b(
            buf[i * page_size : (i + 1) * page_size], digest_size=DIGEST_BYTES
        )
        out[i] = np.frombuffer(h.digest(), np.uint8)
    return out


def digest_key(row) -> bytes:
    """Canonical hashable key for one digest (a (16,) uint8 row or bytes)."""
    if isinstance(row, (bytes, bytearray)):
        return bytes(row)
    return row.tobytes()


_zero_digests: Dict[int, bytes] = {}


def zero_chunk_digest(length: int) -> bytes:
    """Digest of an all-zero chunk of ``length`` bytes (memoized — v1
    backfill hashes the same zero run lengths over and over)."""
    dg = _zero_digests.get(length)
    if dg is None:
        dg = _zero_digests[length] = chunk_digest(bytes(length))
    return dg
