"""Bytes the cold starts' restores read over the seconds they took
(``RestoreStats.bytes_read`` over ``total_s``, each summed), in GB/s."""


def read(run):
    rows = [r["stats"] for r in run["ok"] if r["cold"] and "bytes_read" in r["stats"]]
    t = sum(s["total_s"] for s in rows)
    b = sum(s["bytes_read"] for s in rows)
    return b / t / 1e9 if t > 0 and b > 0 else None
