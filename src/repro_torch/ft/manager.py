"""Checkpoint manager built on the JIF engine.

The paper's mechanism does double duty here: training checkpoints are JIF
snapshots written asynchronously with **incremental dedup** — each delta
checkpoint stores only chunks that changed vs the last *anchor* (full)
checkpoint, zero chunks elided, with atomic publish and keep-k GC.  Restore
is the same fast path the serving engine uses (restart-after-failure IS a
cold start — the paper's point).

The counterpart of ``repro.ft.manager``: a save copies the state to the
host (``interop.to_host``: torch tensors on any device, or numpy, become
numpy arrays, and bf16 tensors CPU torch tensors, so no ``ml_dtypes``), and
a restore returns host views as the port's ``SpiceRestorer`` gives them
(numpy, or CPU torch tensors for bf16 leaves).
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import BaseImage, NodeImageCache, SpiceRestorer, snapshot
from repro_torch.core.overlay import DEFAULT_PAGE
from repro_torch.interop import to_host, tree_map


def _restore(path: str, node_cache: Optional[NodeImageCache] = None):
    """(state, meta) of the JIF at ``path``, restored on the host; the
    restorer's private prefetch scheduler is shut down after."""
    restorer = SpiceRestorer(node_cache=node_cache)
    try:
        state, meta, _, _ = restorer.restore(path)
    finally:
        restorer.iosched.shutdown()
    return state, meta


class CheckpointManager:
    """``callbacks`` run after every completed save (on the save thread in
    async mode) with ``cb.on_checkpoint(manager, step, state_np, entry)``
    where ``entry`` is the just-appended :attr:`history` record — the hook
    the train→serve deployment pipeline publishes through
    (:class:`repro_torch.ft.publish.DeltaPublishCallback`).  A callback exception
    fails the save exactly like a write error: captured and re-raised."""

    def __init__(
        self,
        directory: str,
        keep: int = 3,
        anchor_every: int = 4,  # every k-th checkpoint is a full anchor
        page_size: int = DEFAULT_PAGE,
        async_save: bool = True,
        callbacks: Sequence[Any] = (),
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.anchor_every = anchor_every
        self.page_size = page_size
        self.async_save = async_save
        self.callbacks: List[Any] = list(callbacks)
        self.cache = NodeImageCache(capacity_bytes=32 << 30)
        self._anchor_name: Optional[str] = None
        self._n_saved = 0
        self._pending: Optional[threading.Thread] = None
        # a daemon-thread save that died must not die silently: the failure
        # is parked here and re-raised at the next wait()/save() on the
        # training thread, where the loop can actually react to it
        self._save_error: Optional[BaseException] = None
        self.history: List[Dict] = []

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, blocking: bool = False) -> None:
        state_np = tree_map(to_host, state)  # device->host copy on the caller
        self.wait()  # one in-flight async save at a time; raises its error
        if self.async_save and not blocking:
            self._pending = threading.Thread(
                target=self._save_guarded, args=(step, state_np), daemon=True
            )
            self._pending.start()
        else:
            self._save_sync(step, state_np)

    def wait(self) -> None:
        """Join any in-flight async save and surface its failure: an
        exception raised on the save thread (snapshot write, GC, or a
        publish callback) re-raises HERE, on the caller's thread."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        error, self._save_error = self._save_error, None
        if error is not None:
            raise error

    def _save_guarded(self, step: int, state_np) -> None:
        try:
            self._save_sync(step, state_np)
        except BaseException as exc:  # noqa: BLE001 — re-raised at wait()
            self._save_error = exc

    def _save_sync(self, step: int, state_np) -> None:
        t0 = time.perf_counter()
        anchor = self._n_saved % self.anchor_every == 0
        path = self.dir / f"ckpt_{step:08d}.jif"
        base = None if anchor else self.cache.get(self._anchor_name)
        stats = snapshot(
            state_np,
            str(path),  # jif writer publishes atomically (tmp+rename)
            base=base,
            page_size=self.page_size,
            meta={"step": step, "anchor": anchor},
        )
        if anchor:
            name = f"anchor:{path.name}"
            self.cache.put(BaseImage.from_state(name, state_np, self.page_size))
            self._anchor_name = name
        self._n_saved += 1
        self.history.append(
            {
                "step": step,
                "path": str(path),
                "anchor": anchor,
                "anchor_name": self._anchor_name,
                "bytes_written": stats.private_bytes,
                "total_bytes": stats.total_bytes,
                "save_s": time.perf_counter() - t0,
            }
        )
        (self.dir / "MANIFEST.json").write_text(json.dumps(self.history, indent=1))
        self._gc()
        entry = self.history[-1]
        for cb in self.callbacks:
            cb.on_checkpoint(self, step, state_np, entry)

    def _gc(self) -> None:
        """keep-k GC that never breaks a delta chain: a delta is only
        deletable together with everything older than its anchor."""
        if len(self.history) <= self.keep:
            return
        cut = len(self.history) - self.keep
        # move the cut back to the newest anchor at/before it so survivors
        # (anchor + its deltas) stay restorable
        while cut > 0 and not self.history[cut]["anchor"]:
            cut -= 1
        for h in self.history[:cut]:
            try:
                os.unlink(h["path"])
            except FileNotFoundError:
                pass
        self.history = self.history[cut:]

    # -------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        man = self.dir / "MANIFEST.json"
        if not man.exists():
            return None
        hist = json.loads(man.read_text())
        return hist[-1]["step"] if hist else None

    def restore(self, step: Optional[int] = None) -> Tuple[Any, int]:
        man = json.loads((self.dir / "MANIFEST.json").read_text())
        entry = man[-1] if step is None else next(h for h in man if h["step"] == step)
        # rebuild the anchor in the cache if this process just restarted
        if entry["anchor_name"] and self.cache.get(entry["anchor_name"]) is None:
            a = next(
                h for h in man if h["anchor"] and f"anchor:{Path(h['path']).name}" == entry["anchor_name"]
            )
            anchor_state, _ = _restore(a["path"])
            self.cache.put(
                BaseImage.from_state(entry["anchor_name"], anchor_state, self.page_size)
            )
        state, meta = _restore(entry["path"], self.cache)
        return state, int(meta["step"])
