"""Run one cell of the port's benchmark and print its result line.

    python coldbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (``torch.cuda.is_available()``, as many as the cell's
``chips``); without one it exits with 3 and prints no result.  The port is
imported from ``src/`` beside this folder, and its CUDA kernels are built
once per checkout into ``build/kernels/``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number the correctness check
compared, with its limit.  The same numbers end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_MODULES = ("jax", "jaxlib", "flax", "repro")  # by whole top-level name


def loaded_jax() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_MODULES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from coldbench import spec

    bench = spec.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3

    from coldbench import harness

    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, args.workload, kind):
        value = spec.reader(m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device("cuda")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
              "memory_peak_bytes": int(out["memory_peak"])}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        tr = out["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    # a number the check could not read (no request, no restored tree) is null
    line["checks"] = {k: {"value": v if math.isfinite(v) else None,
                          "limit": out["limits"].get(k)} for k, v in out["checks"].items()}
    found = loaded_jax()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    print(f"setup {json.dumps(out['setup'])}, publish {out['publish_s']}, window "
          f"{out['window_s']:.3f} s, check {out['check_s']:.3f} s ({out['sampled']} requests' "
          f"logits compared), power limit {power_limit()}", file=sys.stderr)
    ok = sorted(out["ok"], key=lambda r: r["submit"])
    print("requests (ttft ms, total ms, GB allocated): " + " ".join(
        f"{1e3 * (r['queue_s'] + r['ttft_s']):.0f},{1e3 * (r['done'] - r['submit']):.0f},"
        f"{r.get('allocated', 0) / 1e9:.1f}" for r in ok), file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


if __name__ == "__main__":
    sys.exit(main())
