"""The model FLOPs of the invocations the window completed (the frozen
formula of ``coldbench/costs/flops_<reference>.py``) over the time in which
at least one of them was in flight (the union of their submit-to-result
intervals) and the card's f32 peak, in %."""
import importlib

import numpy as np

from coldbench.costs import peaks


def read(run):
    ok = run["ok"]
    if not ok:
        return None
    cell, config = run["cell"], run["config"]
    flops = importlib.import_module(f"coldbench.costs.flops_{config['reference']}")
    total = flops.invocation_flops(config, cell["batch"], cell["prompt_len"],
                                   cell["new_tokens"]) * len(ok)
    iv = sorted((r["submit"], r["done"]) for r in ok)
    busy, (s, e) = 0.0, iv[0]
    for a, b in iv[1:]:
        if a > e:
            busy, s, e = busy + e - s, a, b
        else:
            e = max(e, b)
    busy += e - s
    return 100.0 * total / busy / peaks.F32_FLOPS if busy > 0 else None
