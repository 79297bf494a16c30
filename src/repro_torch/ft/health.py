"""Heartbeats + straggler detection.

At 1000+ nodes the control plane needs (a) liveness — miss N heartbeats ->
declare dead -> trigger elastic remesh + JIF restore on the survivors, and
(b) straggler mitigation — per-step duration outliers flag slow hosts so
the data pipeline can rebalance shards away from them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class HostHealth:
    last_beat: float
    step_times: deque


class HealthMonitor:
    def __init__(
        self,
        hosts: List[str],
        heartbeat_timeout_s: float = 30.0,
        straggler_factor: float = 1.5,
        window: int = 16,
        clock=time.monotonic,
    ):
        self._clock = clock
        self.timeout = heartbeat_timeout_s
        self.factor = straggler_factor
        self._h: Dict[str, HostHealth] = {
            h: HostHealth(self._clock(), deque(maxlen=window)) for h in hosts
        }

    def heartbeat(self, host: str, step_time_s: Optional[float] = None) -> None:
        hh = self._h[host]
        hh.last_beat = self._clock()
        if step_time_s is not None:
            hh.step_times.append(step_time_s)

    def dead_hosts(self) -> Set[str]:
        now = self._clock()
        return {h for h, hh in self._h.items() if now - hh.last_beat > self.timeout}

    def stragglers(self) -> Set[str]:
        meds = []
        per_host = {}
        for h, hh in self._h.items():
            if hh.step_times:
                t = sorted(hh.step_times)[len(hh.step_times) // 2]
                per_host[h] = t
                meds.append(t)
        if not meds:
            return set()
        global_med = sorted(meds)[len(meds) // 2]
        return {h for h, t in per_host.items() if t > self.factor * global_med}

    def remove(self, host: str) -> None:
        self._h.pop(host, None)

    def live_hosts(self) -> List[str]:
        dead = self.dead_hosts()
        return sorted(h for h in self._h if h not in dead)


def rebalance_shards(hosts: List[str], stragglers: Set[str], n_shards: int) -> Dict[str, List[int]]:
    """Weighted shard assignment: stragglers get half weight."""
    weights = {h: (0.5 if h in stragglers else 1.0) for h in hosts}
    total = sum(weights.values())
    out: Dict[str, List[int]] = {h: [] for h in hosts}
    acc = 0.0
    cursor = 0
    for h in hosts:
        share = int(round(n_shards * weights[h] / total))
        out[h] = list(range(cursor, min(cursor + share, n_shards)))
        cursor += len(out[h])
    # distribute remainder
    i = 0
    while cursor < n_shards:
        out[hosts[i % len(hosts)]].append(cursor)
        cursor += 1
        i += 1
    return out
