"""K4's device time in the traced window (its three kernels, ``ssd_*``;
one ``ssd_chunk_out_kernel`` a call) against the least time its calls
need: each prefill layer's frozen count (``coldbench/costs/ssd_scan.py``)
at the cell's batch and prompt, in %."""
from coldbench.costs import peaks
from coldbench.costs.ssd_scan import call_work
from coldbench.reference.mamba2 import dims


def read(run):
    tr = run["trace"]
    calls = secs = 0
    for name, (n, s) in tr["kernels"].items():
        if "ssd_chunk_out_kernel" in name:
            calls += n
        if "ssd_chunk_out_kernel" in name or "ssd_chunk_state_kernel" in name \
                or "ssd_state_pass_kernel" in name:
            secs += s
    if not calls or secs <= 0:
        return None
    m, cell = dims(run["config"]), run["cell"]
    flops, nbytes = call_work(cell["batch"], cell["prompt_len"], m["H"], m["P"], m["G"], m["N"])
    return 100.0 * calls * peaks.bound_s(flops, nbytes) / secs
