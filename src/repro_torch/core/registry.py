"""Function registry: the serverless control-plane view of the model zoo.

Each registered *function* is a model instance with a JIF snapshot on disk,
an optional base image (shared with sibling functions), and serving
parameters.  Ownership sits with the control plane
(:class:`repro_torch.serve.cluster.FunctionCatalog`); data-plane nodes hold a
read-mostly reference and resolve invocations through it.  All operations
are thread-safe — in a cluster the catalog registers new functions while
every node's invoke pool reads concurrently."""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional


@dataclasses.dataclass
class FunctionSpec:
    name: str
    arch: str
    jif_path: str
    base_image: Optional[str] = None  # node-cache key
    warm_ttl_s: float = 0.0  # keep-alive window (0: rely on fast restore)
    max_new_tokens: int = 16
    registered_at: float = dataclasses.field(default_factory=time.time)


class FunctionRegistry:
    def __init__(self):
        self._fns: Dict[str, FunctionSpec] = {}
        self._lock = threading.Lock()

    def register(self, spec: FunctionSpec) -> None:
        with self._lock:
            self._fns[spec.name] = spec

    def unregister(self, name: str) -> Optional[FunctionSpec]:
        with self._lock:
            return self._fns.pop(name, None)

    def get(self, name: str) -> FunctionSpec:
        with self._lock:
            return self._fns[name]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._fns

    def __len__(self) -> int:
        with self._lock:
            return len(self._fns)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._fns)

    def save(self, path: str) -> None:
        with self._lock:
            payload = {n: dataclasses.asdict(s) for n, s in self._fns.items()}
        Path(path).write_text(json.dumps(payload, indent=2))

    @classmethod
    def load(cls, path: str) -> "FunctionRegistry":
        reg = cls()
        for n, d in json.loads(Path(path).read_text()).items():
            reg.register(FunctionSpec(**d))
        return reg
