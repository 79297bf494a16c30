"""Median over the window's invocations of the time after the first token
over the decode steps (``(total_s - ttft_s) / (new_tokens - 1)``), in ms.
A cold start's ``total_s`` also waits for its restore to complete."""
import statistics


def read(run):
    steps = run["cell"]["new_tokens"] - 1
    v = [(r["total_s"] - r["ttft_s"]) / steps for r in run["ok"]]
    return statistics.median(v) * 1e3 if v and steps > 0 else None
