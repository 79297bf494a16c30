"""K3's device time in the traced window (kernels named
``decode_attention_kernel``, ``decode_generic_kernel`` and the split
combine ``decode_combine_kernel``) against the least time its calls need:
each call's frozen count (``coldbench/costs/decode_attention.py``) at the
cell's batch, heads and a prompt-sized clamped cache, in %."""
from coldbench.costs import peaks
from coldbench.costs.decode_attention import call_work
from coldbench.reference.dense_lm import dims


def read(run):
    tr = run["trace"]
    calls = secs = 0
    for name, (n, s) in tr["kernels"].items():
        if "decode_attention_kernel" in name or "decode_generic_kernel" in name:
            calls, secs = calls + n, secs + s
        elif "decode_combine_kernel" in name:
            secs += s
    if not calls or secs <= 0:
        return None
    m, cell = dims(run["config"]), run["cell"]
    S = cell["prompt_len"]
    flops, nbytes = call_work(cell["batch"], m["H"], m["kvH"], m["hd"], S, S)
    return 100.0 * calls * peaks.bound_s(flops, nbytes) / secs
