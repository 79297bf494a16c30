"""Model FLOPs of one invocation of a Mamba2 LM (coldbench.reference.mamba2):
2 flops a weight a token for the input and output projections and the
causal convolution, the state space model's 4 H P N a token (the SSD
scan's count), the head's 2 d V a served token.  B x S prompt tokens and
B x (new - 1) decode tokens."""
from coldbench.reference.mamba2 import dims


def invocation_flops(model: dict, B: int, S: int, new: int) -> float:
    m = dims(model)
    d, di, G, N, H, P, K, V, L = (m[k] for k in ("d", "di", "G", "N", "H", "P", "K", "V", "L"))
    conv = di + 2 * G * N
    per_token = 2 * d * (2 * di + 2 * G * N + H) + 2 * di * d + 2 * K * conv + 4 * H * P * N
    tokens = B * S + B * (new - 1)
    return L * per_token * tokens + 2 * d * V * B * new
