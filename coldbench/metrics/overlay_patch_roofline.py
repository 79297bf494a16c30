"""K1's device time in the traced window (kernels named
``overlay_patch_kernel``) against the least time its work needs at the
card's memory bandwidth: the frozen count of ``coldbench/costs/
overlay_patch.py`` for each cold start of that window, in %."""
from coldbench.costs import peaks


def read(run):
    tr = run["trace"]
    ks = [v for n, v in tr["kernels"].items() if "overlay_patch_kernel" in n]
    launches, secs = sum(v[0] for v in ks), sum(v[1] for v in ks)
    per_fn = run["k1"]
    want = sum(per_fn[r["function"]][0] for r in tr["ok"] if r["cold"])
    nbytes = sum(per_fn[r["function"]][1] for r in tr["ok"] if r["cold"])
    if not launches or not want or secs <= 0:
        return None
    # the launches the trace saw carry the window's bytes in proportion
    return 100.0 * (nbytes * launches / want) / peaks.HBM_BYTES_PER_S / secs
