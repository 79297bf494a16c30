"""Checkpoint → catalog publishing: the train half of the train→serve
continuous-delta pipeline.

:class:`DeltaPublishCallback` rides :class:`repro_torch.ft.manager.
CheckpointManager`'s ``callbacks`` hook: every k-th completed checkpoint
save is delta-published into a :class:`repro_torch.serve.deploy.
RolloutController` as the next version of a logical function — sharing
the base image's chunks through the CAS (the publish writes only the
pages the fine-tune actually dirtied) — and, by default, immediately
begins a canary so a fraction of live traffic starts serving it.

The callback runs on the manager's save thread (async mode), so
publishing overlaps the next training steps; a publish failure surfaces
on the training thread at the next ``save()``/``wait()`` exactly like a
checkpoint write failure would.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from repro_torch.serve.deploy import RolloutController, VersionRecord

__all__ = ["DeltaPublishCallback"]


def _default_extract(state: Any):
    """Training state is ``{"params": ..., "opt": ...}``; serving
    publishes the params tree."""
    return state["params"]


class DeltaPublishCallback:
    """Publish every ``every``-th checkpoint as a new canary version.

    ``extract`` maps the checkpointed training state to the params tree
    to serve — the hook for parameter-efficient fine-tunes that publish
    only a merged subset of trained weights (smaller dirty set → smaller
    delta).  ``published`` collects the :class:`VersionRecord`\\ s in
    publish order."""

    def __init__(
        self,
        deploy: RolloutController,
        fname: str,
        cfg,
        every: int = 1,
        canary_fraction: float = 0.25,
        auto_canary: bool = True,
        extract: Optional[Callable[[Any], Any]] = None,
        dirpath: Optional[str] = None,
        memory=None,
    ):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.deploy = deploy
        self.fname = fname
        self.cfg = cfg
        self.every = every
        self.canary_fraction = canary_fraction
        self.auto_canary = auto_canary
        self.extract = extract or _default_extract
        self.dirpath = dirpath
        self.memory = memory
        self.published: List[VersionRecord] = []
        self._seen = 0
        deploy.track(fname)  # fail fast if the base was never published

    def on_checkpoint(self, manager, step: int, state, entry) -> None:
        self._seen += 1
        if (self._seen - 1) % self.every:
            return
        rec = self.deploy.publish_version(
            self.fname, self.cfg, self.extract(state),
            step=step, dirpath=self.dirpath, memory=self.memory,
        )
        if self.auto_canary:
            self.deploy.begin_canary(
                self.fname, rec.version, self.canary_fraction
            )
        self.published.append(rec)
