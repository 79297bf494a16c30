"""K5's device time in the traced window (its two kernels, ``moe_experts_*``;
one ``moe_experts_gate_up_kernel`` a MoE layer call) against the least time
its calls need: an invocation makes one call a MoE layer over the prompt's
B x S tokens and one a layer at each of its ``new - 1`` decode steps over B
tokens, each at the frozen count of ``coldbench/costs/moe_experts.py``
under uniform routing, in %.  The pairs that the routing actually sends to
the held experts are not in the trace, so the bound is the expectation's;
PERF.md gives how far the routed pairs fell from it on the card."""
from coldbench import spec
from coldbench.costs import peaks
from coldbench.costs.moe_experts import call_work, expected


def read(run):
    tr = run["trace"]
    calls = secs = 0
    for name, (n, s) in tr["kernels"].items():
        if "moe_experts_gate_up_kernel" in name:
            calls += n
        if "moe_experts_" in name:
            secs += s
    if not calls or secs <= 0:
        return None
    m, cell = spec.reference(run["config"]).dims(run["config"]), run["cell"]
    B, S, new = cell["batch"], cell["prompt_len"], cell["new_tokens"]
    layers = len(m["types"])

    def bound(T):
        work = call_work(*expected(T, m["k"], m["E"], m["held"]), m["d"], m["f"])
        return peaks.bound_s(*work)

    per_invocation = layers * (bound(B * S) + (new - 1) * bound(B))
    return 100.0 * calls / (layers * new) * per_invocation / secs
