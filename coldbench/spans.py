"""The program's own spans in a traced run: a window served with the port's
span recorder (``repro_torch.obs``) on, under the device-only profile,
reduced to what the readers of ``gen.layer_wait_ms``,
``gen.decode_span_ms``, ``gen.decode_idle_pct`` and
``invoke.complete_wait_ms`` take (``run["trace"]["program"]``).

:func:`window` serves it, as long as the device window
(``harness.TRACE_S`` at most), for a traced run to call after the windows
of ``coldbench/trace.py`` (``harness._traced`` does not call it yet); the
run's other windows keep the recorder off.  :func:`reduce` maps the device's
busy intervals onto the spans' clock through ``obs.clock_pair`` (the
profiler stamps the wall clock) and prints on standard error:

* the alignment check: K1's launches (``overlay_patch_kernel``) that lie
  inside an ``install.job`` span and K3's (``decode_attention_kernel``,
  ``decode_generic_kernel``, ``decode_combine_kernel``) inside a
  ``gen.decode_step`` span, 50 us either side;
* the window's idle device time by the innermost program span open then
  (the deepest in its request's tree; the latest begun among equals), the
  ten largest sums.

The reduction (times in ns on the spans' clock): ``spans`` (intervals:
``name``, ``start``, ``end``, ``id``, ``parent``, ``req``, ``attrs``),
``busy`` (the merged device intervals), ``window``, ``aligned`` (per
kernel, launches inside and counted) and ``idle_by_span``.
"""
from __future__ import annotations

import statistics
import sys

import numpy as np

TOL_NS = 50_000  # a launch may lie this far outside its span
K1 = ("overlay_patch_kernel",)
K3 = ("decode_attention_kernel", "decode_generic_kernel", "decode_combine_kernel")
ALIGNED = {"K1": (K1, "install.job"), "K3": (K3, "gen.decode_step")}
TOP = 10


def window(node, cell, pcfg, prompts, seconds, dev) -> dict:
    """Serve the cell's clients for up to ``harness.TRACE_S`` with the
    recorder on, under the device-only profile; returns the reduction with
    the window's requests (``rows``)."""
    from coldbench import harness
    from coldbench import trace as tracing
    from repro_torch import obs

    cuda = dev.type == "cuda"
    sched = node.scheduler
    obs.drain()
    obs.enable()
    try:
        with tracing.profiled(True, cuda, host=False) as prof:
            a = obs.clock_pair()
            rows, window_s = harness._window(node, cell, pcfg, prompts,
                                             min(seconds, harness.TRACE_S), dev)
            # the last restore's residual uploads land inside the window too
            sched.drain_residual(harness.RESULT_TIMEOUT_S)
            if sched.upload_stream is not None:
                sched.upload_stream.flush(harness.RESULT_TIMEOUT_S)
            b = obs.clock_pair()
    finally:
        obs.disable()
    spans = obs.drain()
    device = [(s, t, n) for s, t, n, on_device in tracing._events(prof) if on_device]
    del prof
    out = reduce(spans, device, a, b)
    out.update(rows=rows, window_s=window_s)
    return out


def reduce(spans, device, a, b) -> dict:
    """``spans`` (``obs.Span``), ``device`` ((start us, end us, name) on the
    wall clock), ``a`` and ``b`` the clock pairs read as the window opened
    and closed."""
    offset = ((a[1] - a[0]) + (b[1] - b[0])) // 2  # wall - spans' clock, ns
    kept = [{"name": s.name, "start": s.start, "end": s.end, "id": s.id,
             "parent": s.parent, "req": s.req, "attrs": dict(s.attrs)}
            for s in spans if s.ph == "X"]
    iv = np.asarray([(s, t) for s, t, _ in device], dtype=np.float64).reshape(-1, 2)
    iv = iv * 1e3 - offset
    names = [n for _, _, n in device]
    within = (iv[:, 0] >= a[0]) & (iv[:, 1] <= b[0])  # ops of the window alone
    iv, names = iv[within], [n for n, w in zip(names, within) if w]
    busy = merge(iv)
    aligned = {}
    for key, (kernels, span_name) in ALIGNED.items():
        hit = {n: any(k in n for k in kernels) for n in set(names)}
        launches = iv[[hit[n] for n in names]] if names else iv
        aligned[key] = [inside(launches, [x for x in kept if x["name"] == span_name]),
                        len(launches)]
    out = {"spans": kept, "busy": busy.tolist(), "window": [a[0], b[0]], "aligned": aligned,
           "idle_by_span": idle_by_span(kept, busy, a[0], b[0])}
    report(out)
    return out


def merge(iv) -> np.ndarray:
    """Sorted, disjoint union of (start, end) rows."""
    iv = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > reach[:-1]])
    return np.stack([iv[first, 0], np.maximum.reduceat(iv[:, 1], first)], axis=1)


def inside(launches, spans, tol=TOL_NS) -> int:
    """How many (start, end) launches lie within a span, ``tol`` either side."""
    if not spans or len(launches) == 0:
        return 0
    spans = sorted((x["start"], x["end"]) for x in spans)
    starts = np.asarray([s for s, _ in spans], dtype=np.float64)
    reach = np.maximum.accumulate(np.asarray([e for _, e in spans], dtype=np.float64))
    launches = np.asarray(launches, dtype=np.float64).reshape(-1, 2)
    i = np.searchsorted(starts, launches[:, 0] + tol, side="right") - 1
    return int(((i >= 0) & (reach[np.maximum(i, 0)] >= launches[:, 1] - tol)).sum())


def covered(busy, s, e) -> float:
    """The time of [s, e] that the merged ``busy`` intervals cover."""
    busy = np.asarray(busy, dtype=np.float64).reshape(-1, 2)
    i = np.searchsorted(busy[:, 1], s, side="right")
    j = np.searchsorted(busy[:, 0], e, side="left")
    if j <= i:
        return 0.0
    part = busy[i:j]
    return float((np.minimum(part[:, 1], e) - np.maximum(part[:, 0], s)).clip(min=0).sum())


def idle_by_span(spans, busy, w0, w1) -> list:
    """The device's idle time in [w0, w1], summed by the innermost program
    span open then, in s: the ten largest.  The window is cut at every
    span's and busy interval's ends; each piece goes to the deepest span
    covering it (the latest begun among equals)."""
    busy = np.asarray(busy, dtype=np.float64).reshape(-1, 2)
    by_id = {x["id"]: x for x in spans}
    depth = {}

    def depth_of(sid):
        chain, p = [], sid
        while p in by_id and p not in depth:
            chain.append(p)
            p = by_id[p]["parent"]
        d = depth.get(p, -1)
        for q in reversed(chain):
            d += 1
            depth[q] = d
        return depth[sid]

    edges = [[w0, w1], busy.ravel(), [x["start"] for x in spans], [x["end"] for x in spans]]
    cuts = np.unique(np.concatenate([np.asarray(e, dtype=np.float64) for e in edges]))
    cuts = cuts[(cuts >= w0) & (cuts <= w1)]
    if len(cuts) < 2:
        return []
    mid = 0.5 * (cuts[:-1] + cuts[1:])
    k = np.searchsorted(busy[:, 0], mid, side="right") - 1
    on = (k >= 0) & (mid < busy[np.maximum(k, 0), 1]) if len(busy) else np.zeros(len(mid), bool)
    idle = np.where(on, 0.0, np.diff(cuts))
    owner = np.full(len(mid), -1)
    order = sorted(range(len(spans)), key=lambda i: (depth_of(spans[i]["id"]), spans[i]["start"]))
    for i in order:  # deeper and later spans paint over the ones they lie in
        lo, hi = np.searchsorted(cuts, [spans[i]["start"], spans[i]["end"]], side="left")
        owner[lo:hi] = i
    per = np.bincount(owner + 1, weights=idle, minlength=len(spans) + 1)
    sums = {}
    for i in np.flatnonzero(per):
        name = spans[i - 1]["name"] if i else "no program span"
        sums[name] = sums.get(name, 0.0) + float(per[i]) * 1e-9
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def report(out) -> None:
    al = "; ".join(f"{k} launches inside {ALIGNED[k][1]}: {n}/{m}"
                   + (f" ({100 * n / m:.2f}%)" if m else "")
                   for k, (n, m) in out["aligned"].items())
    print(f"program window: {al}", file=sys.stderr)
    print("program window idle by innermost span (s): " + ", ".join(
        f"{n} {s:.4f}" for n, s in out["idle_by_span"]), file=sys.stderr)


def program(run):
    """The traced run's program window (None where there is none)."""
    tr = run.get("trace")
    return tr.get("program") if tr else None


def cold_starts(prog) -> set:
    """The requests of the program window that owned a restore."""
    return {x["req"] for x in prog["spans"] if x["name"] == "restore" and x["req"]}


def per_cold_start_ms(run, name):
    """Median over the program window's cold starts of the summed ``name``
    spans of each, in ms (None where no cold start was traced)."""
    prog = program(run)
    if not prog:
        return None
    reqs = cold_starts(prog)
    sums = dict.fromkeys(reqs, 0)
    for x in prog["spans"]:
        if x["name"] == name and x["req"] in sums:
            sums[x["req"]] += x["end"] - x["start"]
    return statistics.median(sums.values()) * 1e-6 if sums else None


def aligned_share(prog):
    """Share of the counted launches that lie inside their spans (None
    where none was counted)."""
    n = sum(v[0] for v in prog["aligned"].values())
    m = sum(v[1] for v in prog["aligned"].values())
    return n / m if m else None
