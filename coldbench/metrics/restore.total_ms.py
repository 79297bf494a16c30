"""Median length of the cold starts' restores (``RestoreStats.total_s``), in ms."""
import statistics


def read(run):
    v = [r["stats"]["total_s"] for r in run["ok"] if r["cold"] and "total_s" in r["stats"]]
    return statistics.median(v) * 1e3 if v else None
