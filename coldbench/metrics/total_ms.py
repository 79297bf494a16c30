"""Median time from submit to result on the benchmark's own clock: what a
function's caller waits for, in ms."""
import statistics


def read(run):
    v = [r["done"] - r["submit"] for r in run["ok"]]
    return statistics.median(v) * 1e3 if v else None
