"""Plain PyTorch reference of an attention-free Mamba2 LM (arXiv:2405.21060):
each layer a pre-norm Mamba2 mixer (fused input projection to z, x, B, C
and dt; a depthwise causal convolution with SiLU over x, B and C; the
selective state space model; a gated RMSNorm; the output projection) on a
residual stream, then a final RMSNorm and the unembedding.  Float32 with
TF32 off; it imports nothing of the program.

The prompt goes through the chunked SSD form (the paper's listing 1:
intra-chunk term, chunk states, inter-chunk recurrence, state to output),
the served tokens through the recurrent form, one step each.

The vocabulary is padded to a multiple of ``pad_vocab_size_multiple``,
and the unembedding is the embedding's table (tied), as published.  One
departure from the published model, as the JAX package serves it: the
gated norm normalizes before the gate (``rmsnorm(y) * silu(z)``, where the
published ``RMSNormGated`` defaults to ``rmsnorm(y * silu(z))``); its
epsilon and the other norms' are the configuration's ``norm_eps``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from coldbench.reference.weights import Leaf


def dims(model: dict) -> dict:
    d = model["d_model"]
    di = model["expand"] * d
    G, N, P = model["ngroups"], model["d_state"], model["headdim"]
    pad = model.get("pad_vocab_size_multiple", 1)
    return {"d": d, "L": model["n_layer"], "di": di, "G": G, "N": N, "P": P,
            "H": di // P, "K": model["d_conv"], "V": -(-model["vocab_size"] // pad) * pad,
            "chunk": model["chunk_size"], "eps": model["norm_eps"],
            "tied": model["tie_embeddings"]}


def leaf_specs(model: dict):
    m = dims(model)
    d, L, di, G, N, H, K, V = (m[k] for k in ("d", "L", "di", "G", "N", "H", "K", "V"))
    conv = di + 2 * G * N
    mixer = {"in_proj": Leaf((L, d, 2 * di + 2 * G * N + H), "fanin"),
             "conv_w": Leaf((L, K, conv), "normal"), "conv_b": Leaf((L, conv), "bias"),
             "A_log": Leaf((L, H), "log_uniform"), "D": Leaf((L, H), "scale"),
             "dt_bias": Leaf((L, H), "bias"), "norm_w": Leaf((L, di), "scale"),
             "out_proj": Leaf((L, di, d), "fanin")}
    embed = {"tok": Leaf((V, d), "normal")}
    if not m["tied"]:
        embed["unembed"] = Leaf((d, V), "fanin")
    return {"embed": embed, "pattern": ({"ln1": Leaf((L, d), "scale"), "mamba": mixer},),
            "remainder": (), "final_norm": Leaf((d,), "scale")}


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def silu(x):
    return x * torch.sigmoid(x)


def ssd_chunked(x, a, Bm, Cm, chunk):
    """x (b, s, h, p) already times dt, a (b, s, h) = dt * A, Bm / Cm (b,
    s, h, n) per head.  Returns y (b, s, h, p) and the final state (b, h,
    p, n)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"{s} tokens do not divide into chunks of {l}")
    c = s // l
    x, Bm, Cm = (t.reshape(b, c, l, h, -1) for t in (x, Bm, Cm))
    a = a.reshape(b, c, l, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    cum = a.cumsum(-1)
    # decay from token j to token i of one chunk, i >= j
    seg = cum[..., :, None] - cum[..., None, :]
    low = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~low, float("-inf")))  # (b, h, c, l, l)
    y_in = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cm, Bm, decay, x)
    to_end = torch.exp(cum[..., -1:] - cum)  # (b, h, c, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bm, to_end, x)
    # carry the chunk states across chunks, in order
    carried = [torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)]
    for i in range(c):
        carried.append(carried[-1] * torch.exp(cum[:, :, i, -1])[..., None, None] + states[:, i])
    entering = torch.stack(carried[:-1], dim=1)  # (b, c, h, p, n)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cm, entering, torch.exp(cum))
    return (y_in + y_off).reshape(b, s, h, p), carried[-1]


def _mixer_prefill(m, w, i, h):
    B, S, _ = h.shape
    di, G, N, H, P, K = m["di"], m["G"], m["N"], m["H"], m["P"], m["K"]
    zxbcdt = h @ w["in_proj"][i]
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * G * N], zxbcdt[..., 2 * di + 2 * G * N:]
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[:, j:j + S] * w["conv_w"][i][j] for j in range(K)) + w["conv_b"][i]
    conv = silu(conv)
    xs = conv[..., :di].reshape(B, S, H, P)
    Bm = conv[..., di:di + G * N].reshape(B, S, G, N).repeat_interleave(H // G, dim=2)
    Cm = conv[..., di + G * N:].reshape(B, S, G, N).repeat_interleave(H // G, dim=2)
    dt = softplus(dt + w["dt_bias"][i])
    A = -torch.exp(w["A_log"][i])
    y, state = ssd_chunked(xs * dt[..., None], dt * A, Bm, Cm, m["chunk"])
    y = y + xs * w["D"][i][:, None]
    y = rmsnorm(y.reshape(B, S, di), w["norm_w"][i], m["eps"]) * silu(z)
    return y @ w["out_proj"][i], {"conv": padded[:, -(K - 1):], "ssm": state}


def _mixer_step(m, w, i, h, cache):
    B = h.shape[0]
    di, G, N, H, P = m["di"], m["G"], m["N"], m["H"], m["P"]
    zxbcdt = h @ w["in_proj"][i]
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * G * N], zxbcdt[:, 2 * di + 2 * G * N:]
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (B, K, C)
    conv = silu((window * w["conv_w"][i]).sum(1) + w["conv_b"][i])
    xs = conv[:, :di].reshape(B, H, P)
    Bm = conv[:, di:di + G * N].reshape(B, G, N).repeat_interleave(H // G, dim=1)
    Cm = conv[:, di + G * N:].reshape(B, G, N).repeat_interleave(H // G, dim=1)
    dt = softplus(dt + w["dt_bias"][i])  # (B, H)
    A = -torch.exp(w["A_log"][i])
    state = cache["ssm"] * torch.exp(dt * A)[..., None, None] \
        + (dt[..., None] * xs)[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Cm) + xs * w["D"][i][:, None]
    y = rmsnorm(y.reshape(B, di), w["norm_w"][i], m["eps"]) * silu(z)
    return y @ w["out_proj"][i], {"conv": window[:, 1:], "ssm": state}


def _head(m, params, x):
    x = rmsnorm(x, params["final_norm"], m["eps"])
    w = params["embed"]["tok"].t() if m["tied"] else params["embed"]["unembed"]
    return x @ w


def served_logits(model: dict, params, prompt, tokens):
    """(B, n, V): the logits from which served token ``tokens[:, j]`` was
    chosen: the prompt's last position for j = 0, then one recurrent step
    fed ``tokens[:, j-1]`` for each later j."""
    m = dims(model)
    dev = params["final_norm"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    tokens = torch.as_tensor(tokens, device=dev).long()
    p = params["pattern"][0]
    x = params["embed"]["tok"][prompt]
    caches = []
    for i in range(m["L"]):
        y, c = _mixer_prefill(m, p["mamba"], i, rmsnorm(x, p["ln1"][i], m["eps"]))
        x = x + y
        caches.append(c)
    out = [_head(m, params, x[:, -1])]
    for j in range(1, tokens.shape[1]):
        x = params["embed"]["tok"][tokens[:, j - 1]]
        for i in range(m["L"]):
            y, caches[i] = _mixer_step(m, p["mamba"], i, rmsnorm(x, p["ln1"][i], m["eps"]),
                                       caches[i])
            x = x + y
        out.append(_head(m, params, x))
    return torch.stack(out, dim=1)
