"""Model FLOPs of one invocation of a dense decoder LM (coldbench.reference.
dense_lm): 2 flops a weight a token for every projection, attention's
QK^T and PV at 4 hd flops a key and head, the head's 2 d V a served token.
The prefill runs B x S tokens causally (token t sees t + 1 keys); each of
the ``new - 1`` decode steps runs B tokens against the S slots of the
clamped cache; the head runs once for each of the ``new`` served tokens."""
from coldbench.reference.dense_lm import dims


def invocation_flops(model: dict, B: int, S: int, new: int) -> float:
    m = dims(model)
    d, H, kvH, hd, f, V, L = (m[k] for k in ("d", "H", "kvH", "hd", "f", "V", "L"))
    weights = d * (H + 2 * kvH) * hd + H * hd * d + 3 * d * f
    tokens = B * S + B * (new - 1)
    keys = B * S * (S + 1) // 2 + B * (new - 1) * S
    return L * (2 * weights * tokens + 4 * hd * H * keys) + 2 * d * V * B * new
