"""Readings that the correctness check's limits are set from, on the card.

    python coldbench/calibrate.py --workload <cell> --seeds 101 102 ... \
        --control-seeds 201 202 203 --seconds 10

Each seed is one run of the cell through the harness, at the cell's own
sizes and load with a short window, every request's logits compared (not
a sample).  ``--seeds`` run the program as it is (the lower readings);
``--control-seeds`` run it with the control planted: its float32 matrix
products in TF32 for the window (the upper readings), the harness's own
check deciding ``correct``.  One process reads every seed; each line of
output is one run's JSON, the last the largest program reading and the
smallest control reading of each number.  It exits with 1 if a program
run comes out incorrect or a control run comes out correct.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    if not torch.cuda.is_available():
        print("calibrate.py reads the card: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    from coldbench import harness

    readings = {None: {}, "tf32": {}}
    wrong = 0
    t = T_START
    runs = [(s, None) for s in args.seeds] + [(s, "tf32") for s in args.control_seeds]
    for seed, fault in runs:
        out = harness.run(args.workload, seed, args.seconds, False, t_start=t, sample=1.0,
                          fault=fault)
        t = time.perf_counter()
        wrong += out["correct"] is (fault is not None)
        print(json.dumps({"seed": seed, "control": fault is not None, "correct": out["correct"],
                          "attempted": out["attempted"], "failed": out["failed"],
                          "compared": out["sampled"], "checks": out["checks"],
                          "setup_s": out["setup_s"]}), flush=True)
        for k, v in out["checks"].items():
            readings[fault].setdefault(k, []).append(v)
    print(json.dumps({"workload": args.workload,
                      "program_max": {k: max(v) for k, v in readings[None].items()},
                      "control_min": {k: min(v) for k, v in readings["tf32"].items()},
                      "runs_against_expectation": wrong}))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
