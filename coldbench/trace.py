"""The traced run's profiles, reduced to what the metric readers and the
result's ``breakdown`` take.

A traced run reads its requests from its untraced window, so the readers
of host-clock and program metrics read the system, not the profiler.
After it, one window is profiled with the device's activity alone (CUPTI:
kernels, copies, fills and the CUDA calls that launch them), for the
readers of device time, and a last one with every thread's host ops
recorded besides, which gives only ``idle_gaps``.  On an H100, warm decode
steps took some 20% longer under the first profile and 2.4 times as long
under the second.

* ``kernels``: device time and launches by kernel name;
* ``busy_s``: the union of the intervals in which an operation (kernel,
  copy or fill) ran on the device;
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the device's idle time, gap by gap, by what the host was
  doing then (the host op overlapping the gap most, on any thread), the
  ten largest sums.
"""
from __future__ import annotations

import contextlib

import numpy as np

TOP = 10
GAPS = 4000  # the longest idle gaps that are attributed to a host op
OWN = "coldbench."  # the benchmark's own ranges around its calls into the node


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool = True, host: bool = True):
    """A profiler over the block (None when not ``enabled``): the device's
    activity where ``cuda``, and every thread's host ops where ``host`` (or
    where there is no device to trace)."""
    if not enabled:
        yield None
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if host or not cuda:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    else:
        acts, extra = [ProfilerActivity.CUDA], {}
    with profile(activities=acts, **extra) as prof:
        yield prof


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of (start, end) rows."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _events(prof):
    """(start, end, name, on the device) of every event, in us, from the
    profiler's raw results: its ``events()`` parse them in Python at some
    80 us an event, minutes for a window's millions."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() != DeviceType.CPU
        if device and e.is_user_annotation():
            continue  # a record_function range's shadow on the device
        out.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name(), device))
    return out


def reduce(prof) -> dict:
    """The profile's reduction (times in seconds)."""
    dev, host = [], []
    for s, t, name, device in _events(prof):
        (dev if device else host).append((s, t, name))
    kernels = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) * 1e-6
    busy = _merge(np.asarray([(s, t) for s, t, _ in dev], dtype=np.float64).reshape(-1, 2))
    return {
        "kernels": kernels,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6,
        "device_ops": [[n, k[1]] for n, k in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": _gaps(busy, host),
    }


def _gaps(busy: np.ndarray, host) -> list:
    if len(busy) < 2:
        return []
    g0, g1 = busy[:-1, 1], busy[1:, 0]
    order = np.argsort(g0 - g1)[:GAPS]  # longest first
    own = [(s, t, n) for s, t, n in host if n.startswith(OWN)]
    ops = [(s, t, n) for s, t, n in host if not n.startswith(OWN)]
    sums = {}
    ops.sort()
    o_start = np.asarray([r[0] for r in ops], dtype=np.float64)
    o_end = np.asarray([r[1] for r in ops], dtype=np.float64)
    longest = float((o_end - o_start).max()) if len(ops) else 0.0
    for i in order:
        a, b = g0[i], g1[i]
        label = None
        if len(ops):
            lo = np.searchsorted(o_start, a - longest, side="left")
            hi = np.searchsorted(o_start, b, side="left")
            if hi > lo:
                ov = np.minimum(o_end[lo:hi], b) - np.maximum(o_start[lo:hi], a)
                j = int(np.argmax(ov))
                if ov[j] > 0:
                    label = ops[lo + j][2]
        if label is None:
            mid = 0.5 * (a + b)
            inside = [n for s, t, n in own if s <= mid <= t]
            label = inside[-1] if inside else "no host op recorded"
        sums[label] = sums.get(label, 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]
