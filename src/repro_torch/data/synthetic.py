"""Deterministic synthetic LM data pipeline: seeded, shardable per host,
restartable from a step offset (checkpoint/restart needs the iterator state
to be part of the training state)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Zipf-ish token streams with next-token structure (shift targets).

    Deterministic in (seed, step, host): any host can reproduce any step,
    which is what makes elastic re-sharding and restart trivial.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.RandomState((c.seed * 1_000_003 + step) % 2**31)
        # zipf-ish marginal over the vocab, then a deterministic shift map
        z = rng.zipf(1.3, size=(c.global_batch, c.seq_len + 1)) % c.vocab_size
        toks = z.astype(np.int32)
        lo = self.cfg.host_id * self.local_batch
        hi = lo + self.local_batch
        return {"tokens": toks[lo:hi, :-1], "targets": toks[lo:hi, 1:]}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1
