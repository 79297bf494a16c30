"""Median time the cold starts' restores spent in host-to-device uploads
and device patches (``RestoreStats.upload_s``), in ms."""
import statistics


def read(run):
    v = [r["stats"]["upload_s"] for r in run["ok"]
         if r["cold"] and r["stats"].get("upload_s", 0) > 0]
    return statistics.median(v) * 1e3 if v else None
