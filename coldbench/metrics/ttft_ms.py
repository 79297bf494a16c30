"""Median time to the first token, restore included: the node's admission
delay plus its own TTFT (``InvokeResult.queue_s + ttft_s``), over the
window's invocations, in ms."""
import statistics


def read(run):
    v = [r["queue_s"] + r["ttft_s"] for r in run["ok"]]
    return statistics.median(v) * 1e3 if v else None
