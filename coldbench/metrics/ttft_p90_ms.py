"""The 90th percentile of the time to the first token (``queue_s +
ttft_s``), over all the window's invocations, in ms (numpy's linear
percentile)."""
import numpy as np


def read(run):
    v = [r["queue_s"] + r["ttft_s"] for r in run["ok"]]
    return float(np.percentile(v, 90)) * 1e3 if v else None
