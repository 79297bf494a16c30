"""Median over the window's cold starts of the time their upload jobs
waited on the upload stream's synchronize (``RestoreStats.sync_wait_s``,
from the stamps of the spans ``install.sync``), in ms."""
import statistics


def read(run):
    v = [r["stats"]["sync_wait_s"] for r in run["ok"]
         if r["cold"] and "sync_wait_s" in r["stats"]]
    return statistics.median(v) * 1e3 if v else None
