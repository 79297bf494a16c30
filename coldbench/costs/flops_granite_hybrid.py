"""Model FLOPs of one invocation of Granite 4.0-H (coldbench.reference.
granite_hybrid): 2 flops a weight a token for every projection (a Mamba-2
layer's input and output projections and causal convolution, an attention
layer's q/k/v/o, the router over all E experts, the shared expert), the
SSD scan's 4 H P N a token, attention's QK^T and PV at 4 hd flops a key and
head, the held experts' 6 d f a pair at the expected ``k held / E`` pairs a
token (``coldbench/costs/moe_experts.py``), the head's 2 d V a served
token.  The prefill runs B x S tokens causally; each of the ``new - 1``
decode steps runs B tokens against the S slots of the clamped cache."""
from coldbench.reference.granite_hybrid import dims


def invocation_flops(model: dict, B: int, S: int, new: int) -> float:
    m = dims(model)
    d, di, G, N, Hm, P, K = (m[k] for k in ("d", "di", "G", "N", "Hm", "P", "K"))
    H, kvH, hd = m["H"], m["kvH"], m["hd"]
    conv = di + 2 * G * N
    mamba = 2 * d * (2 * di + 2 * G * N + Hm) + 2 * di * d + 2 * K * conv + 4 * Hm * P * N
    attn = 2 * d * (H + 2 * kvH) * hd + 2 * H * hd * d
    ffn = 2 * d * m["E"] + 6 * d * m["fs"] + 6 * d * m["f"] * m["k"] * m["held"] / m["E"]
    tokens = B * S + B * (new - 1)
    keys = B * S * (S + 1) // 2 + B * (new - 1) * S
    n_attn = sum(t == "attention" for t in m["types"])
    per_token = (len(m["types"]) - n_attn) * mamba + n_attn * attn + len(m["types"]) * ffn
    return per_token * tokens + n_attn * 4 * hd * H * keys + 2 * d * m["V"] * B * new
