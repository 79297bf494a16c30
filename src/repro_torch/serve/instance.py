"""Function instance lifecycle + layer-gated generation.

One :class:`FunctionInstance` per published function per node, moving
through an explicit state machine::

    COLD ──begin_restore──▶ RESTORING ──ws complete──▶ WARMING ──residual──▶ WARM
      ▲                         │ (no residual: promote straight to WARM)      │
      └───────────── (next invocation) ◀── EVICTED ◀────────── evict/TTL ──────┘

WARMING is the paper's WARM-at-working-set promotion: every tensor before
the JIF's ws boundary is resident, so invocations route warm and generate
layer-gated over the residual handles while the tail streams at background
priority; the residual's completion finalizes WARM (resolved device tree).

The instance owns everything a live function needs: the restore handle tree
(TensorHandles while the prefetcher streams), the resolver used to gate
each layer on exactly its parameters, keep-alive/TTL accounting, and
memory-footprint bookkeeping for the node's LRU eviction.  Invocations that
arrive while a restore is in flight *join* it — they generate over the same
handle tree, waiting per tensor, instead of issuing a second restore of the
same snapshot.

Generation executes models layer by layer so the first layers run while the
prefetcher is still streaming later layers from storage (the paper's §4.2
"execution resumes immediately while the bulk of memory is fetched").  Layer
readiness is *tracked* (TensorHandle events), never advisory.  PyTorch runs
eagerly, so there is no per-layer compile cache to restore.
"""
from __future__ import annotations

import contextlib
import enum
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.restore import RestoreStats, TensorHandle
from repro_torch.device import resolve_device
from repro_torch.interop import to_host, to_torch, tree_leaves, tree_map
from repro_torch.models.lm import serve_layers
from repro_torch.models.layers import embed, rmsnorm, unembed


def layerwise_state(cfg: ModelConfig, params) -> Dict:
    """Stacked params (torch tensors on any device, or numpy) -> per-layer
    host leaves (numpy, or CPU torch tensors for bf16): the serving layout
    that gets published."""
    host = tree_map(to_host, params)  # one device->host copy per leaf
    layers = []
    for rep in range(cfg.pattern_reps):
        for i in range(len(cfg.pattern)):
            layers.append(tree_map(lambda a: a[rep], host["pattern"][i]))
    for j in range(len(cfg.remainder)):
        layers.append(host["remainder"][j])
    return {
        "embed": host["embed"],
        "layers": layers,
        "final_norm": host["final_norm"],
    }


def _on_device(tree, device: torch.device):
    """Every leaf as a tensor on ``device``.  The access recorder's lazy
    leaves hand over what they hold (``materialize``, which records the
    touch); a tensor already there passes through; anything else goes
    through ``np.asarray`` first (``torch.as_tensor`` cannot infer the
    dtype of an array-like)."""

    def put(leaf):
        if hasattr(leaf, "materialize"):
            leaf = leaf.materialize()
        if isinstance(leaf, torch.Tensor):
            return leaf if leaf.device == device else leaf.to(device)
        return to_torch(np.asarray(leaf), device)

    return tree_map(put, tree)


def _head(cfg: ModelConfig, p_embed, p_norm, x) -> torch.Tensor:
    x = rmsnorm(x[:, -1:], p_norm, cfg.norm_eps)
    logits = unembed(cfg, p_embed, x, torch.float32)
    if obs.HOOKS:
        obs.step_logits(logits[:, -1])
    # torch.argmax returns the FIRST maximal index, as jnp.argmax does
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def wait_tree(tree):
    """Resolve TensorHandle leaves (blocking, tracked completion)."""
    return tree_map(
        lambda leaf: leaf.wait() if isinstance(leaf, TensorHandle) else leaf,
        tree,
        is_leaf=lambda l: isinstance(l, TensorHandle),
    )


_first_token = threading.local()  # the calling thread's last first-token stamp


def take_first_token() -> int:
    """The ``perf_counter_ns`` stamp at which this thread's last
    :func:`generate` had its first token on the host (0: none since the
    last call); the node stamps the FIRST_TOKEN event with it."""
    t = getattr(_first_token, "ns", 0)
    _first_token.ns = 0
    return t


def _pending(tree) -> bool:
    """Whether resolving ``tree`` will block on a restore."""
    return any(isinstance(leaf, TensorHandle) and not leaf.ready
               for leaf in tree_leaves(tree))


def generate(cfg, getter, state, prompt: np.ndarray, max_new: int, device=None):
    """Layer-gated generation: each layer waits for exactly its params.
    Returns (tokens, ttft_s); ``ttft_s`` ends when the first token is on
    the host.  Read-only over ``state``; safe to run concurrently from
    several invocations sharing one instance.  ``getter`` resolves handle
    leaves (None: leaves are arrays, tensors or lazy access-trace leaves);
    each layer is resolved and put on ``device`` once per call.

    With the span recorder on it records ``gen.prefill`` (to the first
    token on the host), inside it a ``gen.layer_wait`` each time a
    resolve blocks on the restore (``layer``: -1 the embedding, the
    number of layers the final norm), and a ``gen.decode_step`` a step,
    each ending when its token is on the host; spans the layers record
    (a MoE layer's ``gen.moe``) are children of the one open."""
    dev = resolve_device(device)
    on = obs.ON

    def resolve(t, layer):
        if on and getter is not None and _pending(t):
            w = obs.now()
            got = getter(t)
            obs.add("gen.layer_wait", w, obs.now(), layer=layer)
            return _on_device(got, dev)
        return _on_device(getter(t) if getter is not None else t, dev)

    B, S = prompt.shape
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    f32 = torch.float32

    t0 = obs.now()
    pre = obs.span("gen.prefill", start=t0)
    with pre:
        p_embed = resolve(state["embed"], -1)
        x = embed(cfg, p_embed, torch.as_tensor(np.asarray(prompt), device=dev), f32)
        layers = []

        def layer_at(i):
            layers.append(resolve(state["layers"][i], i))
            return layers[-1]

        x, caches = serve_layers(cfg, layer_at, x, positions, mode="prefill", caches=None,
                                 pos=None, compute_dtype=f32)
        p_norm = resolve(state["final_norm"], len(layers))
        tok = _head(cfg, p_embed, p_norm, x)
        out = [tok.cpu().numpy()]
        pre.stop = t1 = _first_token.ns = obs.now()

    pos = S
    for step in range(1, max_new):
        with obs.span("gen.decode_step", step=step):
            x = embed(cfg, p_embed, tok[:, None], f32)
            x, caches = serve_layers(cfg, layers.__getitem__, x, None, mode="decode",
                                     caches=caches, pos=pos, compute_dtype=f32)
            tok = _head(cfg, p_embed, p_norm, x)
            out.append(tok.cpu().numpy())
        pos += 1
    return np.stack(out, axis=1), (t1 - t0) / 1e9


class _FaasnapLeaf:
    def __init__(self, r, name):
        self._r = r
        self.name = name

    def fault(self):
        return self._r.ensure(self.name)


def faasnap_wait(tree, device=None):
    """Fault in FaaSnap-style lazy leaves and install them on ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda l: to_torch(l.fault(), dev, copy=True) if isinstance(l, _FaasnapLeaf) else l,
        tree,
        is_leaf=lambda l: isinstance(l, _FaasnapLeaf),
    )


class NotWarmError(RuntimeError):
    """The instance was not WARM when a warm-tree pin was requested —
    distinct from RuntimeErrors raised by work done *under* the pin, so
    callers with a not-warm fallback don't swallow real failures."""


# ---------------------------------------------------------- instance state
class InstanceState(enum.Enum):
    COLD = "cold"
    RESTORING = "restoring"
    WARMING = "warming"  # working set resident; residual streaming in
    WARM = "warm"
    EVICTED = "evicted"  # may keep a pinned working set (residual evicted):
    # the next restore then reads ONLY the residual bytes it dropped


class FunctionInstance:
    """Lifecycle container for one function on one node.

    Transitions are driven by the :class:`~repro_torch.serve.node.NodeScheduler`;
    every mutation happens under ``cond``'s lock.  ``generation`` counts
    restore generations — a new restore after eviction bumps it, so stale
    joiners can detect they are looking at a dead tree."""

    def __init__(self, spec, cfg: ModelConfig):
        self.spec = spec
        self.cfg = cfg
        self.state = InstanceState.COLD
        self.generation = 0
        # state-change hook (set by the owning NodeScheduler): fired by
        # _notify_transition() after every lifecycle edge, while ``cond`` is
        # still held — it must be non-blocking (the node uses it to bump a
        # load-epoch counter so cached NodeLoad snapshots invalidate)
        self.on_transition: Optional[Callable[["FunctionInstance"], None]] = None
        self.cond = threading.Condition()
        self.tree: Optional[Any] = None          # handles while RESTORING,
        self.getter: Optional[Callable] = None   # resolved arrays once WARM
        self.restore_stats: Optional[RestoreStats] = None
        self.restore_mode: Optional[str] = None
        self.last_used = 0.0
        self.warm_expiry = 0.0   # 0 = no keep-alive
        self.memory_bytes = 0
        self.inflight = 0
        self.ws_ready = False    # working set resident (WARMING/WARM)
        # ledger regions adopted from the restorer (repro_torch.core.memory):
        # ws_region charges the pinned working set, residual_region the
        # post-boundary tail.  Released on eviction; residual eviction
        # releases only residual_region and pins the ws leaves.
        self.ws_region = None
        self.residual_region = None
        self.ws_pinned: Optional[Dict[str, Any]] = None
        self.counters = {
            "cold_starts": 0, "warm_hits": 0, "joined": 0,
            "ttl_evictions": 0, "lru_evictions": 0, "ws_promotions": 0,
            "residual_evictions": 0, "ws_rerestores": 0,
        }

    # ------------------------------------------------------------ queries
    def expired(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        return (
            self.state is InstanceState.WARM
            and self.warm_expiry > 0
            and now >= self.warm_expiry
        )

    @property
    def idle(self) -> bool:
        return self.inflight == 0

    def restore_abortable(self, generation: int) -> bool:
        """True while restore ``generation`` may still be aborted by a
        cancellation: the instance is RESTORING that same generation and no
        joiner shares the handle tree (``inflight`` > 1 means concurrent
        invocations trusted the stream — aborting it would fail them for
        someone else's cancel).  Once the working set lands (WARMING/WARM)
        cancellation is a no-op by contract."""
        with self.cond:
            return (
                self.state is InstanceState.RESTORING
                and self.generation == generation
                and self.inflight <= 1
            )

    @contextlib.contextmanager
    def pinned_warm_tree(self):
        """Check-and-pin a WARM instance's tree atomically: yields the tree
        with ``inflight`` bumped so a concurrent eviction cannot null it
        mid-use (tracing, relayout state capture).  Raises ``NotWarmError``
        when the instance is not WARM — the check and the pin must happen
        under one lock hold, or an eviction could slip between them."""
        with self.cond:
            if self.state is not InstanceState.WARM:
                raise NotWarmError(
                    f"{self.spec.name}: needs a WARM instance (is {self.state.value})"
                )
            tree = self.tree
            self.inflight += 1
        try:
            yield tree
        finally:
            with self.cond:
                self.inflight -= 1
                self.cond.notify_all()

    # -------------------------------------------------------- transitions
    # All transition helpers assume ``self.cond`` is held by the caller.
    def _notify_transition(self) -> None:
        if self.on_transition is not None:
            try:
                self.on_transition(self)
            except Exception:
                pass  # an observer must never break a lifecycle edge

    def _clear(self, next_state: "InstanceState") -> None:
        """Drop all resident state and move to ``next_state`` (the single
        reset point: every field added to the instance clears here)."""
        self.state = next_state
        self.tree = None
        self.getter = None
        self.ws_ready = False
        self.warm_expiry = 0.0
        self.memory_bytes = 0
        self.ws_pinned = None
        for region in (self.ws_region, self.residual_region):
            if region is not None:
                region.release()
        self.ws_region = None
        self.residual_region = None
        self._notify_transition()
        self.cond.notify_all()

    def adopt_regions(self, ws_region, residual_region) -> None:
        """Take ownership of the restore's ledger regions: from here on the
        instance lifecycle (evict / residual-evict / clear) releases them."""
        for stale in (self.ws_region, self.residual_region):
            if stale is not None:
                stale.release()
        self.ws_region = ws_region
        self.residual_region = residual_region

    def begin_restore(self, mode: str) -> int:
        assert self.state in (InstanceState.COLD, InstanceState.EVICTED), self.state
        self.state = InstanceState.RESTORING
        self.generation += 1
        self.restore_mode = mode
        self.tree = None
        self.getter = None
        self.ws_ready = False
        self.counters["cold_starts"] += 1
        self._notify_transition()
        return self.generation

    def publish_restore(self, tree, getter, stats, regions=(None, None)) -> None:
        assert self.state is InstanceState.RESTORING, self.state
        self.tree = tree
        self.getter = getter
        self.restore_stats = stats
        self.adopt_regions(*regions)
        self.cond.notify_all()

    def promote_warming(self, ttl_s: float, now: float, est_bytes: int) -> None:
        """RESTORING → WARMING at working-set completion: the traced working
        set is resident, so invocations route warm (layer-gated over the
        residual handles) while the residual keeps streaming at background
        priority.  ``est_bytes`` (the image's logical size) stands in for
        memory accounting until the resolved tree replaces the handles."""
        assert self.state is InstanceState.RESTORING, self.state
        assert ttl_s > 0, "early promotion only makes sense with keep-alive"
        self.state = InstanceState.WARMING
        self.ws_ready = True
        self.warm_expiry = now + ttl_s
        self.memory_bytes = est_bytes
        self.last_used = now
        self._notify_transition()
        self.cond.notify_all()

    def finalize_warm(self, resolved_tree, now: float) -> None:
        """WARMING → WARM once the residual stream drained: swap the handle
        tree for the resolved (device-installed) one and account its real
        footprint.  The keep-alive window set at WARMING promotion stands."""
        assert self.state is InstanceState.WARMING, self.state
        self.state = InstanceState.WARM
        self.tree = resolved_tree
        self.getter = None
        self.memory_bytes = _tree_bytes(resolved_tree)
        self._notify_transition()
        self.cond.notify_all()

    def promote_warm(self, resolved_tree, ttl_s: float, now: float) -> None:
        assert self.state is InstanceState.RESTORING, self.state
        if ttl_s > 0:
            self.state = InstanceState.WARM
            self.ws_ready = True
            self.tree = resolved_tree
            self.getter = None
            self.warm_expiry = now + ttl_s
            self.memory_bytes = _tree_bytes(resolved_tree)
        else:
            # no keep-alive: drop straight back to COLD, free the state
            self._clear(InstanceState.COLD)
        self.last_used = now
        self._notify_transition()
        self.cond.notify_all()

    def evict(self, reason: str = "manual") -> bool:
        """WARM → EVICTED (idle instances only).  Returns True if evicted.
        An EVICTED instance still holding a pinned working set drops it too
        (full eviction — the next restore reads everything again)."""
        if self.state is InstanceState.EVICTED and self.ws_pinned is not None:
            self.drop_ws_pinned()
            return False  # state unchanged; only the pin was dropped
        if self.state is not InstanceState.WARM or not self.idle:
            return False  # WARMING is never evictable: its residual stream
            # is still in flight and would write into freed buffers
        self._clear(InstanceState.EVICTED)
        if reason == "ttl":
            self.counters["ttl_evictions"] += 1
        elif reason == "lru":
            self.counters["lru_evictions"] += 1
        return True

    def evict_residual(self) -> int:
        """WARM → EVICTED keeping the working set pinned (the reclaim
        ladder's cheapest rung): only the residual region is released, the
        ws leaves stay resident so the next restore — the EVICTED →
        RESTORING re-restore path — reads only the residual bytes it
        dropped here.  Returns the bytes freed (0 if not applicable)."""
        from repro_torch.core.treeutil import flatten_state

        if (
            self.state is not InstanceState.WARM
            or not self.idle
            or self.residual_region is None
            or self.restore_stats is None
            or not self.restore_stats.ws_names
        ):
            return 0
        ws_names = set(self.restore_stats.ws_names)
        keep: Dict[str, Any] = {}
        try:
            leaves, _ = flatten_state(self.tree)
        except Exception:
            return 0  # unflattenable tree (shouldn't happen for WARM)
        for name, arr in leaves:
            if name in ws_names:
                keep[name] = arr
        freed = self.residual_region.nbytes
        self.residual_region.release()
        self.residual_region = None
        self.state = InstanceState.EVICTED
        self.tree = None
        self.getter = None
        self.ws_ready = False
        self.warm_expiry = 0.0
        self.ws_pinned = keep
        self.memory_bytes = (
            self.ws_region.nbytes if self.ws_region is not None
            else sum(getattr(a, "nbytes", 0) for a in keep.values())
        )
        self.counters["residual_evictions"] += 1
        self._notify_transition()
        self.cond.notify_all()
        return freed

    def drop_ws_pinned(self) -> int:
        """Release an EVICTED instance's pinned working set (the warm-LRU
        ladder rung).  Returns the bytes freed."""
        if self.ws_pinned is None:
            return 0
        freed = (
            self.ws_region.nbytes if self.ws_region is not None
            else sum(getattr(a, "nbytes", 0) for a in self.ws_pinned.values())
        )
        if self.ws_region is not None:
            self.ws_region.release()
        self.ws_region = None
        self.ws_pinned = None
        self.memory_bytes = 0
        self.cond.notify_all()
        return freed

    def take_ws_pinned(self):
        """Hand the pinned working set to the owner of a fresh restore.
        Returns (pinned dict or None, ws_region or None); the caller passes
        the dict as ``preloaded`` and the region as ``preloaded_region`` —
        the restorer resizes the region in place into the new ws region
        (ownership transfers there; do NOT release it separately), so the
        resident bytes stay charged across the re-restore."""
        pinned, region = self.ws_pinned, self.ws_region
        self.ws_pinned = None
        self.ws_region = None
        if pinned:
            self.counters["ws_rerestores"] += 1
        return pinned, region

    def abort_warming(self) -> None:
        """WARMING → EVICTED when residual finalization failed."""
        if self.state is InstanceState.WARMING:
            self._clear(InstanceState.EVICTED)

    def abort_restore(self) -> None:
        """RESTORING → EVICTED on a failed restore, releasing joiners."""
        if self.state is InstanceState.RESTORING:
            self._clear(InstanceState.EVICTED)


def _tree_bytes(tree) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        total += getattr(leaf, "nbytes", 0)
    return int(total)
