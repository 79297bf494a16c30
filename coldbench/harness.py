"""One run of one cell: set-up, the measured window, the correctness check.

The system under test is the port's ``ServerlessNode`` (``repro_torch.
serve.engine``) with the fused install: each cell's clients invoke its
functions through ``submit`` and ``result``, in a closed loop (one request
in flight a client), evicting a function before each invocation where the
cell's traffic is cold.  Everything else is the benchmark's own: the
weights and prompts from the seed, the fine-tunes, the plain reference,
the frozen work counts and the readers of the metrics.

Set-up (``setup_s``, split by stage): imports and CUDA, the seeded weights
on the card, the host base image, each function published as a JIF under
``TMPDIR``, and a warm-up that cold-starts every function of the cell once
and serves one warm invocation.  Then the window: ``seconds`` in which the
clients submit; a request submitted in it is waited for and counts, so the
window closes when the last one has its result.  A traced run follows the
untraced window (whose requests every reader of requests reads) with two
shorter ones: one profiled with the device's activity alone, for the
readers of device time, then one with every thread's host ops recorded,
for the breakdown's idle gaps only (``coldbench/trace.py``).

The check (``correct``), after the window, once the peak device memory has
been read: (1) every byte of each function's restored tree on the card
against the parameters the benchmark published; (2) the logits of every
prefill and decode step of the window's first request and a seeded
quarter of the rest,
recorded where the program's generation produces them, against the
reference's over the same prompt and served tokens; (3) every served
token's logit below the reference's best at its position.  The reference
runs once the program's state is freed.
"""
from __future__ import annotations

import gc
import tempfile
import threading
import time

import numpy as np
import torch

from coldbench import spec
from coldbench.costs import overlay_patch as k1_cost
from coldbench.reference import finetunes, weights

RESULT_TIMEOUT_S = 120.0  # a request not answered this long after the window is lost
SAMPLE = 0.25  # share of the window's requests whose every step's logits are compared
TRACE_S = 20.0  # a traced run's device window, after the untraced one
BREAKDOWN_S = 10.0  # its host window, every thread's host ops recorded


class LogitsRecorder:
    """Records, for the window's first and a seeded sample of the
    program's ``generate`` calls made by the node's workers, the
    last-position logits of every head, where the program computes them
    (its ``serve.instance.unembed``), and the prompt and tokens of the call.  ``fault`` plants a fault in the timed
    path for the tests and the calibration: ``"token"`` alters one served
    token after it is produced, ``"half_batch"`` serves the first half of
    the batch and copies its tokens to the rest, ``"patch"`` alters one
    element of every tensor the overlay-patch kernel restores, ``"tf32"``
    (the control) lets the program's float32 matrix products run in TF32
    in the window: the program turns TF32 off where its generation
    resolves its device, and the fault turns it back on there."""

    def __init__(self, seed: int, sample: float, fault=None):
        self._rng = np.random.default_rng([seed, 1])
        self._sample = sample
        self._fault = fault
        self._lock = threading.Lock()
        self._local = threading.local()
        self._first = True
        self.active = False
        self.calls = []  # (prompt, tokens served, [logits (B, V) a step])
        self._undo = []

    def _keep(self) -> bool:
        """The window's first call, then a seeded share of the rest."""
        with self._lock:
            first, self._first = self._first, False
            return bool(self._rng.random() < self._sample) or first

    def install(self):
        from repro_torch.kernels.overlay_patch import ops as k1_ops
        from repro_torch.serve import instance, node

        real_generate, real_unembed, real_patch = node.generate, instance.unembed, k1_ops.overlay_patch

        def generate(cfg, getter, state, prompt, max_new, device=None):
            half = self._fault == "half_batch"
            run_prompt = prompt[: len(prompt) // 2] if half else prompt
            keep = self.active and self._keep()
            self._local.logits = [] if keep else None
            try:
                toks, ttft = real_generate(cfg, getter, state, run_prompt, max_new, device=device)
            finally:
                logits, self._local.logits = self._local.logits, None
            if half:
                toks = np.concatenate([toks, toks])[: len(prompt)]
            if self._fault == "token" and self.active:
                toks = toks.copy()
                toks[-1, -1] = (toks[-1, -1] + 1) % cfg.vocab_size
            if keep:
                with self._lock:
                    self.calls.append((np.asarray(prompt), np.asarray(toks, dtype=np.int32), logits))
            return toks, ttft

        def unembed(cfg, p, x, compute_dtype):
            logits = real_unembed(cfg, p, x, compute_dtype)
            rec = getattr(self._local, "logits", None)
            if rec is not None:
                rec.append(logits[:, -1].detach().clone())
            return logits

        def overlay_patch(*args):
            out = real_patch(*args)
            if self.active:
                out.view(-1)[0] += 1
            return out

        node.generate, instance.unembed = generate, unembed
        self._undo = [(node, "generate", real_generate), (instance, "unembed", real_unembed)]
        if self._fault == "patch":
            k1_ops.overlay_patch = overlay_patch
            self._undo.append((k1_ops, "overlay_patch", real_patch))
        if self._fault == "tf32":
            real_resolve = instance.resolve_device

            def resolve_device(device=None):
                dev = real_resolve(device)
                if self.active:
                    torch.backends.cuda.matmul.allow_tf32 = True
                return dev

            instance.resolve_device = resolve_device
            self._undo.append((instance, "resolve_device", real_resolve))

    def remove(self):
        for mod, name, real in self._undo:
            setattr(mod, name, real)
        self._undo = []
        torch.backends.cuda.matmul.allow_tf32 = False


def _row(f, p_idx, t_sub, t_done, r, err):
    row = {"function": f, "prompt": p_idx, "submit": t_sub, "done": t_done, "error": err}
    if r is not None:
        stats = {k: float(v) for k, v in (r.stats or {}).items()
                 if isinstance(v, (int, float)) and not isinstance(v, bool)}
        row.update(cold=bool(r.cold), mode=r.mode, joined=bool(r.joined), queue_s=r.queue_s,
                   ttft_s=r.ttft_s, total_s=r.total_s, queue_wait_s=r.queue_wait_s,
                   stats=stats, tokens=np.asarray(r.tokens, dtype=np.int32))
    return row


def _right_kind(row, expect: str) -> bool:
    if row["error"] is not None:
        return False
    if expect == "cold":
        return row["cold"] and not row["joined"] and row["mode"] != "warm"
    return not row["cold"] and row["mode"] == "warm"


def _served(params, pcfg) -> dict:
    """A stacked tree in the layout the program publishes and restores:
    ``{"embed", "layers": [one dict a layer], "final_norm"}``."""
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": weights.per_layer(params, len(pcfg.pattern), pcfg.pattern_reps)}


def _leaf_pairs(restored, want):
    """(restored leaf, published leaf) pairs of one function's tree, or
    None where the two trees' leaves differ."""
    got, ref = dict(weights.leaves(restored)), dict(weights.leaves(want))
    if got.keys() != ref.keys():
        return None
    return [(got[k], ref[k]) for k in ref]


def _differing_bytes(pairs) -> int:
    n = 0
    for a, b in pairs:
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        a = a.to(b.device).contiguous()
        if a.shape != b.shape or a.dtype != b.dtype:
            n += b.numel() * b.element_size()
            continue
        n += int((a.view(-1).view(torch.uint8) != b.contiguous().view(-1).view(torch.uint8)).sum())
    return n


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device=None, cell: dict = None, config: dict = None, sample: float = SAMPLE,
        fault=None) -> dict:
    """One run; returns what the result line and the readers need.
    ``cell`` and ``config`` replace the files of that name (the tests' small
    sizes); ``fault`` is :class:`LogitsRecorder`'s."""
    from torch.profiler import record_function

    from repro_torch.core import BaseImage, BufferPool
    from repro_torch.serve.engine import ServerlessNode, layerwise_state

    cell = cell or spec.cell(cell_name)
    config = config or spec.config(cell["config"])
    ref = spec.reference(config)
    pcfg = spec.program_config(config)
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    fnames = sorted({f for c in cell["clients"] for f in c})
    B, S, new = cell["batch"], cell["prompt_len"], cell["new_tokens"]
    setup = {}
    torch.zeros(1, device=dev)
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    sync()
    t = time.perf_counter()
    setup["import_and_cuda"] = t - t_start

    # weights on the card from the seed, and the functions' fine-tunes
    leaf_specs = ref.leaf_specs(config)
    base = weights.draw(leaf_specs, seed, dev)
    funcs = {f: finetunes.make(base, config, config["functions"][f]) for f in fnames}
    image_bytes = sum(a.numel() * a.element_size() for _, a in weights.leaves(base))
    sync()
    setup["weights"] = time.perf_counter() - t
    t = time.perf_counter()

    budget = cell.get("budget_images")
    node = ServerlessNode(
        device=dev, install="fused", pool=BufferPool(capacity_bytes=image_bytes),
        memory_budget_bytes=None if budget is None else int(budget * image_bytes),
        max_workers=cell["max_workers"],
    )
    rec = LogitsRecorder(seed, sample, fault)
    d = tempfile.TemporaryDirectory(prefix="coldbench-")
    try:
        host_base = layerwise_state(pcfg, base)
        node.node_cache.put(BaseImage.from_state(config["base"], host_base), evictable=False)
        del host_base
        setup["base_image"] = time.perf_counter() - t
        publish_s = []
        for f in fnames:
            t = time.perf_counter()
            with record_function("coldbench.publish"):
                node.publish(f, pcfg, funcs[f], d.name, base_name=config["base"],
                             formats=("jif",), warm_ttl_s=cell["keep_alive_s"])
            publish_s.append(time.perf_counter() - t)
        setup["publish"] = sum(publish_s)
        del base, funcs
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        rng = np.random.default_rng([seed, 0])
        prompts = {}
        for f in fnames:
            prompts[f] = [rng.integers(0, config["vocab_size"], (B, S)).astype(np.int32)
                          for _ in range(cell["prompt_pool"])]
        keys = {p.tobytes() for ps in prompts.values() for p in ps}
        if len(keys) != len(fnames) * cell["prompt_pool"]:
            raise RuntimeError("two prompts of the pool coincide")

        # warm-up: each function cold once, the first one warm once
        t = time.perf_counter()
        rec.install()
        for f in fnames:
            node.evict(f)
            r = node.invoke(f, prompts[f][0], new, mode=cell["mode"], cfg=pcfg)
            if not r.cold:
                raise RuntimeError(f"warm-up: {f} was not a cold start")
        r = node.invoke(fnames[0], prompts[fnames[0]][0], new, mode=cell["mode"], cfg=pcfg)
        if r.cold:
            raise RuntimeError(f"warm-up: {fnames[0]} was not warm")
        sync()
        setup["warmup"] = time.perf_counter() - t

        # the window; in a traced run, two traced windows after it
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        rec.active = True
        rows, window_s = _window(node, cell, pcfg, prompts, seconds, dev)
        rec.active = False
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        rec.remove()
        reduced = _traced(node, cell, pcfg, prompts, seconds, dev) if trace else None

        ok = [r for r in rows if _right_kind(r, cell["expect"])]
        t = time.perf_counter()
        # the check: (1) restored bytes, against the weights drawn again
        base = weights.draw(leaf_specs, seed, dev)
        funcs = {f: finetunes.make(base, config, config["functions"][f]) for f in fnames}
        differing = 0
        for f in fnames:
            inst = node.scheduler.instance(f)
            try:
                with inst.pinned_warm_tree() as tree:
                    pairs = _leaf_pairs(tree, _served(funcs[f], pcfg))
                    differing += float("inf") if pairs is None else _differing_bytes(pairs)
            except (AttributeError, RuntimeError):  # not warm after the window
                differing = float("inf")
        node.close()
        node = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        base_leaves = [a for _, a in weights.leaves(_served(base, pcfg))]
        k1 = {f: k1_cost.cold_start_work([a for _, a in weights.leaves(_served(funcs[f], pcfg))],
                                         base_leaves) for f in fnames}
        checks = _check_outputs(ref, config, funcs, prompts, ok, rec.calls)
        checks = {"restored_bytes_differing": differing, **checks}
        check_s = time.perf_counter() - t
    finally:
        rec.remove()
        if node is not None:
            node.close()
        d.cleanup()
    limits = cell["correct"]
    correct = bool(ok) and all(checks[k] <= limits[k] for k in limits)
    return {
        "cell": cell, "config": config, "seed": seed, "window_s": window_s,
        "setup_s": setup_s, "setup": setup, "publish_s": publish_s, "rows": rows, "ok": ok,
        "attempted": len(rows), "failed": len(rows) - len(ok), "memory_peak": memory_peak,
        "trace": reduced, "k1": k1, "checks": checks, "limits": limits, "correct": correct,
        "sampled": len(rec.calls), "check_s": check_s,
    }


def _window(node, cell, pcfg, prompts, seconds, dev):
    """``seconds`` of the cell's clients, each in a closed loop (evict where
    the cell is cold, ``submit``, ``result``); a request submitted in the
    window is waited for.  Returns (the requests' rows, the window's length)."""
    from torch.profiler import record_function

    cuda = dev.type == "cuda"
    rows = []
    lock = threading.Lock()
    new = cell["new_tokens"]
    t_end = time.perf_counter() + seconds

    def client(functions):
        k = 0
        while time.perf_counter() < t_end:
            f = functions[k % len(functions)]
            p_idx = (k // len(functions)) % cell["prompt_pool"]
            if cell["evict"]:
                with record_function("coldbench.evict"):
                    node.evict(f)
            t_sub = time.perf_counter()
            r = err = None
            try:
                with record_function("coldbench.submit"):
                    h = node.submit(f, prompts[f][p_idx], new, mode=cell["mode"], cfg=pcfg)
                with record_function("coldbench.result"):
                    r = h.result(seconds + RESULT_TIMEOUT_S)
            except Exception as exc:  # noqa: BLE001 — counted as failed
                err = f"{type(exc).__name__}: {exc}"
            row = _row(f, p_idx, t_sub, time.perf_counter(), r, err)
            if cuda:
                row["allocated"] = torch.cuda.memory_allocated(dev)
            with lock:
                rows.append(row)
            k += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{i}")
               for i, c in enumerate(cell["clients"])]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if cuda:
        torch.cuda.synchronize(dev)
    return rows, time.perf_counter() - t0


def _traced(node, cell, pcfg, prompts, seconds, dev) -> dict:
    """The traced run's reduction (``coldbench/trace.py``): a window of up
    to ``TRACE_S`` profiled with the device's activity alone, whose
    requests (``ok``) and length (``window_s``) go with it, then one of up
    to ``BREAKDOWN_S`` with every thread's host ops besides, which gives
    only the idle gaps.  Neither window's requests count in the run's."""
    from coldbench import trace as tracing

    cuda = dev.type == "cuda"
    with tracing.profiled(True, cuda, host=False) as prof:
        rows, window_s = _window(node, cell, pcfg, prompts, min(seconds, TRACE_S), dev)
    out = tracing.reduce(prof)
    del prof
    out.update(ok=[r for r in rows if _right_kind(r, cell["expect"])], window_s=window_s)
    with tracing.profiled(True, cuda, host=True) as prof:
        _window(node, cell, pcfg, prompts, min(seconds, BREAKDOWN_S), dev)
    out["idle_gaps"] = tracing.reduce(prof)["idle_gaps"]
    return out


def _rel_err(got, want) -> float:
    """The largest, over the steps, of ``max |got - want| / max |want|`` of
    a step's logits (``(B, steps, V)``)."""
    return float(((got - want).abs().amax(dim=(0, 2)) / want.abs().amax(dim=(0, 2))).max())


def _gap(want, tokens) -> float:
    """The largest, over the steps, of the amount by which a chosen token's
    logit lies below the best of its position, over the step's ``max
    |want|`` (``want`` (B, steps, V), ``tokens`` (B, steps))."""
    chosen = want.gather(-1, tokens[..., None])[..., 0]
    below = (want.amax(-1) - chosen).amax(0)
    return float((below / want.abs().amax(dim=(0, 2))).max())


def _check_outputs(ref, config, funcs, prompts, ok, calls):
    """The numbers compared.

    ``logits_rel_err``: over the sampled calls, the largest ``max |program
    - reference| / max |reference|`` of a step's logits, the reference fed
    the same prompt and served tokens.  ``token_gap``: over every served
    token of the window, the largest amount by which its logit in the
    reference lies below the reference's best at that position, over the
    step's ``max |reference|``: a token chosen from logits within ``e`` of
    the reference's (``logits_rel_err``) lies at most ``2 e`` below."""
    owner = {p.tobytes(): (f, i) for f, ps in prompts.items() for i, p in enumerate(ps)}
    cache = {}

    def reference(f, p_idx, toks):
        key = (f, p_idx, toks.tobytes())
        if key not in cache:
            torch.backends.cuda.matmul.allow_tf32 = False
            with torch.no_grad():
                cache[key] = ref.served_logits(config, funcs[f], prompts[f][p_idx],
                                               torch.as_tensor(toks.astype(np.int64)))
        return cache[key]

    inf = float("inf")
    rel = 0.0 if calls else inf
    for prompt, toks, logits in calls:
        f, p_idx = owner[prompt.tobytes()]
        want = reference(f, p_idx, toks)
        if len(logits) != want.shape[1] or any(g.shape != want[:, j].shape
                                                for j, g in enumerate(logits)):
            rel = inf
            continue
        rel = max(rel, _rel_err(torch.stack(logits, 1).to(want.device), want))
    gap = 0.0 if ok else inf
    for row in ok:
        toks = row["tokens"]
        want = reference(row["function"], row["prompt"], toks)
        served = torch.as_tensor(toks.astype(np.int64), device=want.device)
        if served.shape != want.shape[:2]:
            gap = inf
            continue
        gap = max(gap, _gap(want, served))
    return {"logits_rel_err": rel, "token_gap": gap}
