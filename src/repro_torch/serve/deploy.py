"""Train→serve continuous-delta deployment pipeline.

The `ft/` training stack and the serving stack finally talk: every
checkpoint a running fine-tune writes can become a *versioned function*
in the :class:`~repro_torch.serve.cluster.FunctionCatalog`, delta-published
against the version it was trained from — so version N+1 costs only its
dirty pages in new storage, shares every base chunk through the CAS, and
restores through the same near-warm path as any other function.

* :class:`VersionRecord` / :class:`VersionedFunction` — the lineage of one
  logical function: each version is an ordinary registered spec
  (``fname`` for v1, ``fname@v2`` …) whose JIF chains to its parent
  version's JIF on disk.
* :class:`RolloutController` — the control loop.  ``publish_version``
  delta-publishes a new version; ``begin_canary`` routes a seeded,
  deterministic fraction of the logical function's traffic to it (the
  router calls :meth:`resolve` before placement, so sticky routing,
  restore joining and warm hits all key on the version actually served);
  ``promote`` repoints the stable pointer; ``rollback`` is *instant* —
  a pointer move back to the parent snapshot, zero new bytes written,
  with the parent typically still WARM on its serving node; ``retire`` /
  ``gc_retired`` release a dead version's CAS refs and JIF.
* :class:`QualityGate` — pluggable promote/reject decision over real
  canary outputs; :meth:`RolloutController.evaluate_canary` drives probe
  invocations through the router and promotes or rejects on the verdict.
* :class:`ColocatedTrainer` — admits each training step onto the serving
  fleet as a BATCH-class *payload* invocation: the step waits its turn in
  the QoS-ordered run queue under the node's admission caps
  (``max_batch_inflight`` bounds its worker occupancy), which is the
  serve/train colocation contract — background training can contend for
  a node but never starve LATENCY dispatch.

The full loop — ``CheckpointManager.save`` → ``DeltaPublishCallback`` →
``publish_version`` → ``begin_canary`` → ``evaluate_canary`` →
promote/rollback — comes to the port with its training stack
(``ft/manager.py`` and ``ft/publish.py``); until then a caller publishes
versions with :meth:`RolloutController.publish_version` directly.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.cluster import FunctionCatalog
from repro_torch.serve.invocation import Invocation, Overloaded, QosClass

__all__ = [
    "VersionRecord",
    "VersionedFunction",
    "RolloutController",
    "QualityGate",
    "TokenHealthGate",
    "ColocatedTrainer",
]

# VersionRecord.status lifecycle: "live" (published; may be pointed at by
# the stable/canary pointers) -> "rejected" (canary that failed its gate
# or was superseded) | "rolled_back" (former stable the lineage backed out
# of) -> "retired" (CAS refs released, spec unregistered, JIF unlinked).
LIVE = "live"
REJECTED = "rejected"
ROLLED_BACK = "rolled_back"
RETIRED = "retired"


@dataclasses.dataclass
class VersionRecord:
    """One published version of a logical function."""

    version: int
    name: str                 # concrete registered function name
    jif_path: str
    parent: Optional[int]     # parent version id (delta base); None for v1
    step: Optional[int]       # training step that produced it (None for v1)
    status: str = LIVE
    private_bytes: int = 0    # new storage this publish actually cost
    total_bytes: int = 0      # full logical image size
    published_mono: float = 0.0      # time.monotonic() at publish
    first_routed_mono: Optional[float] = None  # first canary route


class VersionedFunction:
    """The version lineage of one logical function.  ``current`` is the
    stable version every unsplit invocation serves; ``canary`` (when set)
    takes ``canary_fraction`` of the traffic via a seeded RNG so the split
    sequence is a pure function of (controller seed, version, name)."""

    def __init__(self, logical: str, base: VersionRecord):
        self.logical = logical
        self.records: Dict[int, VersionRecord] = {base.version: base}
        self.current: int = base.version
        self.canary: Optional[int] = None
        self.canary_fraction: float = 0.0
        self.rng: Optional[np.random.Generator] = None

    def record(self, version: int) -> VersionRecord:
        return self.records[version]

    def live_children(self, version: int) -> List[VersionRecord]:
        """Versions chaining directly off ``version`` that are not retired
        — while any exist, the parent's JIF must stay on disk (their delta
        restores read it)."""
        return [
            r for r in self.records.values()
            if r.parent == version and r.status != RETIRED
        ]


class QualityGate:
    """Promote/reject decision over a canary's real serving outputs."""

    def evaluate(self, results: Sequence[Any]) -> bool:
        raise NotImplementedError


class TokenHealthGate(QualityGate):
    """Default gate: every probe must have produced a non-empty integer
    token stream within the vocabulary — the cheapest "the new weights
    actually serve" check.  Real deployments plug in task metrics."""

    def __init__(self, vocab_size: Optional[int] = None):
        self.vocab_size = vocab_size

    def evaluate(self, results: Sequence[Any]) -> bool:
        if not results:
            return False
        for r in results:
            toks = np.asarray(r.tokens)
            if toks.size == 0 or not np.issubdtype(toks.dtype, np.integer):
                return False
            if self.vocab_size is not None and (
                int(toks.min()) < 0 or int(toks.max()) >= self.vocab_size
            ):
                return False
        return True


class RolloutController:
    """Versioned publish + staged rollout + instant rollback + retired-
    version GC for logical functions in one catalog.  Attach to a router
    (``controller.attach(router)`` or ``ClusterRouter(deploy=...)``-style
    wiring) to activate the per-invocation A/B split; without a router the
    controller still versions and publishes (single-node facades resolve
    manually)."""

    def __init__(
        self,
        catalog: FunctionCatalog,
        seed: int = 0,
        dirpath: Optional[str] = None,
    ):
        self.catalog = catalog
        self.seed = int(seed)
        self.dirpath = dirpath  # default publish directory for versions
        self._router = None
        self._lock = threading.RLock()
        self._functions: Dict[str, VersionedFunction] = {}
        self.stats = {
            "publishes": 0,
            "canaries": 0,
            "promotes": 0,
            "rollbacks": 0,
            "retired": 0,
            "gates_passed": 0,
            "gates_failed": 0,
            "canary_routed": 0,
            "stable_routed": 0,
        }

    # ------------------------------------------------------------- wiring
    def attach(self, router) -> "RolloutController":
        """Install this controller as ``router.deploy``: every submitted
        invocation's logical function name resolves through
        :meth:`resolve` before placement."""
        router.deploy = self
        self._router = router
        return self

    # ------------------------------------------------------------ lineage
    def track(self, fname: str) -> VersionedFunction:
        """Adopt an already-published function as version 1 of a lineage
        (idempotent).  The logical name IS v1's concrete name, so tracking
        changes nothing about how existing traffic serves."""
        with self._lock:
            vf = self._functions.get(fname)
            if vf is not None:
                return vf
            spec = self.catalog.registry.get(fname)
            st = self.catalog.publish_stats(fname)
            rec = VersionRecord(
                version=1, name=fname, jif_path=spec.jif_path, parent=None,
                step=None, status=LIVE,
                private_bytes=st.private_bytes if st else 0,
                total_bytes=st.total_bytes if st else 0,
                published_mono=time.monotonic(),
            )
            vf = VersionedFunction(fname, rec)
            self._functions[fname] = vf
            return vf

    def lineage(self, fname: str) -> VersionedFunction:
        with self._lock:
            return self._functions[fname]

    def versions(self, fname: str) -> List[VersionRecord]:
        with self._lock:
            vf = self._functions[fname]
            return [vf.records[v] for v in sorted(vf.records)]

    def current(self, fname: str) -> VersionRecord:
        with self._lock:
            vf = self._functions[fname]
            return vf.records[vf.current]

    def canary(self, fname: str) -> Optional[VersionRecord]:
        with self._lock:
            vf = self._functions[fname]
            return None if vf.canary is None else vf.records[vf.canary]

    # ------------------------------------------------------------ publish
    def publish_version(
        self,
        fname: str,
        cfg,
        params,
        step: Optional[int] = None,
        dirpath: Optional[str] = None,
        parent_version: Optional[int] = None,
        extra_state: Optional[Any] = None,
        memory=None,
    ) -> VersionRecord:
        """Delta-publish a new version of ``fname`` against its parent
        version's JIF (default: the current stable).  The new version is a
        full citizen of the catalog — registered spec, CAS-ingested
        chunks, restorable anywhere — but its publish writes only the
        pages that differ from the parent."""
        vf = self.track(fname)
        with self._lock:
            parent = vf.current if parent_version is None else parent_version
            parent_rec = vf.records[parent]
            n = max(vf.records) + 1
            base_spec = self.catalog.registry.get(vf.records[vf.current].name)
        where = dirpath or self.dirpath
        if where is None:
            raise ValueError("pass dirpath= (or set RolloutController(dirpath=))")
        name = f"{fname}@v{n}"
        # the expensive part (pre-warm trace + snapshot + CAS ingest) runs
        # outside the controller lock; versions inherit the lineage's
        # keep-alive window
        spec = self.catalog.publish(
            name, cfg, params, where, parent=parent_rec.jif_path,
            warm_ttl_s=base_spec.warm_ttl_s, formats=("jif",),
            extra_state=extra_state, memory=memory,
        )
        st = self.catalog.publish_stats(name)
        rec = VersionRecord(
            version=n, name=name, jif_path=spec.jif_path, parent=parent,
            step=step, status=LIVE,
            private_bytes=st.private_bytes if st else 0,
            total_bytes=st.total_bytes if st else 0,
            published_mono=time.monotonic(),
        )
        with self._lock:
            vf.records[n] = rec
            self.stats["publishes"] += 1
        return rec

    # ------------------------------------------------------------ rollout
    def begin_canary(
        self, fname: str, version: Optional[int] = None, fraction: float = 0.25
    ) -> VersionRecord:
        """Start routing ``fraction`` of ``fname``'s invocations to
        ``version`` (default: the newest published version).  A canary
        already in flight is superseded (marked rejected — continuous
        publishing outruns gating and the newest candidate wins)."""
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"canary fraction must be in (0, 1], got {fraction}")
        with self._lock:
            vf = self._functions[fname]
            if version is None:
                version = max(vf.records)
            rec = vf.records[version]
            if rec.status != LIVE or version == vf.current:
                raise ValueError(
                    f"{fname}@v{version} is not a canary candidate "
                    f"(status={rec.status}, current=v{vf.current})"
                )
            if vf.canary is not None and vf.canary != version:
                vf.records[vf.canary].status = REJECTED
            vf.canary = version
            vf.canary_fraction = float(fraction)
            # the split sequence is a pure function of (seed, version,
            # name): two controllers with the same seed route identically
            vf.rng = np.random.default_rng(
                [self.seed, version, zlib.crc32(fname.encode())]
            )
            self.stats["canaries"] += 1
            return rec

    def resolve(self, fname: str) -> str:
        """Map a logical function name to the concrete version this
        invocation serves.  Unknown names (including concrete version
        names invoked directly) pass through unchanged."""
        with self._lock:
            vf = self._functions.get(fname)
            if vf is None:
                return fname
            cur = vf.records[vf.current]
            if vf.canary is None:
                return cur.name
            can = vf.records[vf.canary]
            if float(vf.rng.random()) < vf.canary_fraction:
                self.stats["canary_routed"] += 1
                if can.first_routed_mono is None:
                    can.first_routed_mono = time.monotonic()
                return can.name
            self.stats["stable_routed"] += 1
            return cur.name

    def evaluate_canary(
        self,
        fname: str,
        prompt,
        gate: Optional[QualityGate] = None,
        n_probes: int = 3,
        max_new_tokens: int = 4,
        cfg=None,
        qos: QosClass = QosClass.BATCH,
        timeout: float = 300.0,
    ) -> bool:
        """Drive ``n_probes`` real invocations of the canary version
        through the router (BATCH class: probes queue behind live
        traffic), hand the results to the gate, and promote on pass /
        reject on fail.  Returns the verdict."""
        if self._router is None:
            raise RuntimeError("evaluate_canary needs an attached router")
        can = self.canary(fname)
        if can is None:
            raise RuntimeError(f"{fname}: no canary in flight")
        handles = [
            self._router.submit_invocation(Invocation(
                function=can.name, prompt=prompt,
                max_new_tokens=max_new_tokens, cfg=cfg, qos=qos,
            ))
            for _ in range(n_probes)
        ]
        results = [h.result(timeout) for h in handles]
        ok = (gate or TokenHealthGate()).evaluate(results)
        with self._lock:
            self.stats["gates_passed" if ok else "gates_failed"] += 1
        if ok:
            self.promote(fname, can.version)
        else:
            self.rollback(fname)
        return ok

    def promote(self, fname: str, version: Optional[int] = None) -> VersionRecord:
        """Repoint the stable pointer at the canary (or an explicit live
        version): from here every unsplit invocation serves it.  The old
        stable stays live — it is the new version's delta parent and the
        instant-rollback target."""
        with self._lock:
            vf = self._functions[fname]
            if version is None:
                if vf.canary is None:
                    raise RuntimeError(f"{fname}: nothing to promote")
                version = vf.canary
            rec = vf.records[version]
            if rec.status != LIVE:
                raise ValueError(f"cannot promote {rec.name} ({rec.status})")
            if vf.canary == version:
                vf.canary = None
                vf.canary_fraction = 0.0
            vf.current = version
            self.stats["promotes"] += 1
            return rec

    def rollback(self, fname: str) -> VersionRecord:
        """Instant rollback — a pointer move, zero new bytes published.
        With a canary in flight: the canary is rejected and the stable
        keeps serving.  Without one: the stable is backed out to its
        parent version, whose snapshot never left disk (and whose warm
        instances never left their nodes).  Returns the record now
        serving."""
        with self._lock:
            vf = self._functions[fname]
            if vf.canary is not None:
                vf.records[vf.canary].status = REJECTED
                vf.canary = None
                vf.canary_fraction = 0.0
                self.stats["rollbacks"] += 1
                return vf.records[vf.current]
            cur = vf.records[vf.current]
            if cur.parent is None:
                raise RuntimeError(f"{fname}: v{cur.version} has no parent")
            cur.status = ROLLED_BACK
            vf.current = cur.parent
            self.stats["rollbacks"] += 1
            return vf.records[vf.current]

    # ----------------------------------------------------------------- GC
    def retire(self, fname: str, version: int, unlink: bool = True) -> None:
        """Release one dead version: CAS manifest refs returned (private
        chunks no other image references are unlinked from the store),
        spec unregistered, warm instances evicted fleet-wide, JIF deleted.
        Refuses versions still routable (stable/canary/live) or with
        non-retired descendants (their delta restores read this JIF)."""
        with self._lock:
            vf = self._functions[fname]
            rec = vf.records[version]
            if version in (vf.current, vf.canary) or rec.status == LIVE:
                raise ValueError(f"{rec.name} is still routable ({rec.status})")
            if rec.status == RETIRED:
                return
            children = vf.live_children(version)
            if children:
                raise ValueError(
                    f"{rec.name} still parents live versions: "
                    f"{[c.name for c in children]}"
                )
            rec.status = RETIRED
            self.stats["retired"] += 1
        self.catalog.unpublish(rec.name, unlink=unlink)
        if self._router is not None:
            self._router.evict(rec.name)

    def gc_retired(self, fname: str) -> List[str]:
        """Retire every rejected/rolled-back version whose descendants are
        all retired, leaf-first until a fixed point.  Ancestors of the
        live head are never touched — they are the shared delta base the
        whole economics stands on."""
        done: List[str] = []
        while True:
            with self._lock:
                vf = self._functions[fname]
                victim = next(
                    (
                        r for r in vf.records.values()
                        if r.status in (REJECTED, ROLLED_BACK)
                        and not vf.live_children(r.version)
                    ),
                    None,
                )
            if victim is None:
                return done
            self.retire(fname, victim.version)
            done.append(victim.name)


class ColocatedTrainer:
    """Admit training compute onto the serving fleet as BATCH payload
    invocations.  Each :meth:`step` submits one thunk through the target
    (a :class:`~repro_torch.serve.cluster.ClusterRouter` or a single
    :class:`~repro_torch.serve.node.NodeScheduler`), waits its turn in the
    QoS-ordered run queue under the admission caps, and blocks for the
    result — training is sequential, so one step is in flight at a time,
    and a full batch lane backs the *trainer* off (bounded retry), never
    the serving traffic."""

    def __init__(
        self,
        target,
        job_name: str = "finetune",
        qos: QosClass = QosClass.BATCH,
        priority: int = 0,
        retry_backoff_s: float = 0.005,
    ):
        self.target = target
        self.job_name = job_name
        self.qos = qos
        self.priority = priority
        self.retry_backoff_s = retry_backoff_s
        self.stats = {"steps": 0, "admission_retries": 0, "queue_wait_s": 0.0}

    def step(self, fn: Callable, *args, timeout: float = 300.0, **kwargs):
        """Run ``fn(*args, **kwargs)`` as one admitted payload invocation
        and return its result."""
        cell: Dict[str, Any] = {}

        def thunk():
            cell["out"] = fn(*args, **kwargs)

        inv = Invocation(
            function=f"train:{self.job_name}", qos=self.qos,
            priority=self.priority, payload=thunk,
        )
        while True:
            try:
                handle = self.target.submit_invocation(inv)
                break
            except Overloaded:
                # the batch lane is full of *serving* batch work — training
                # yields and retries; admission never bends for it
                self.stats["admission_retries"] += 1
                time.sleep(self.retry_backoff_s)
        r = handle.result(timeout)
        self.stats["steps"] += 1
        self.stats["queue_wait_s"] += r.queue_wait_s
        return cell.get("out")
