"""Plain PyTorch reference of Granite 4.0-H (``granitemoehybrid``): a
hybrid of Mamba-2 and attention mixers, each layer followed by a dropless
top-k MoE of routed experts plus one shared expert, with Granite's
multipliers.  Float32 with TF32 off; it imports nothing of the program.

Per layer ``l`` (pre-norm RMSNorm, every epsilon ``rms_norm_eps``)::

    x <- x + r * mixer(rmsnorm(x))
    h  = rmsnorm(x)
    x <- x + r * (sum over j in top-k(h W_r) held here of g_j E_j(h) + S(h))

with ``r`` the residual multiplier, the gates ``g`` the softmax over the
top-k router logits in f32 (Granite's TopKGating), ``E_j(h) = (silu(h
W_g,j) * h W_u,j) W_d,j`` and ``S`` the shared expert of the same form.
The embedding is times ``embedding_multiplier``, the logits are
``rmsnorm(x) E^T / logits_scaling`` (tied).  Attention is q/k/v without
bias or rotation (NoPE), scores times ``attention_multiplier``, causal,
grouped-query.  The Mamba-2 mixer is mamba2's (``coldbench.reference.
mamba2``'s pieces) with the gated norm in the published order,
``rmsnorm(y * silu(z))``.

The chip's share of an expert-parallel deployment: the router keeps its
published width (``deployment.router_experts``) and its experts per token,
and only the ``num_local_experts`` experts held here, from
``deployment.expert_offset`` on, are computed, as a dense loop over them
with masks; what the experts held elsewhere would add is left out.  The
layers are ``layer_types`` (this chip's pipeline stage).

The prompt goes through the chunked SSD form and attention over the whole
sequence, the served tokens one recurrent step each.  One departure, as
the JAX package serves: the **clamped decode slot** (the attention cache
holds the prompt's S slots; each decode step writes its key and value into
slot S - 1 and attends over all S).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from coldbench.reference.mamba2 import rmsnorm, silu, softplus, ssd_chunked
from coldbench.reference.weights import Leaf

MIXER = {"mamba": "mamba", "attention": "attn"}  # layer type -> the layer's mixer leaves


def dims(model: dict) -> dict:
    d, H = model["hidden_size"], model["num_attention_heads"]
    dep = model["deployment"]
    Hm, P = model["mamba_n_heads"], model["mamba_d_head"]
    return {"d": d, "types": model["layer_types"], "H": H, "kvH": model["num_key_value_heads"],
            "hd": d // H, "Hm": Hm, "P": P, "di": Hm * P, "N": model["mamba_d_state"],
            "G": model["mamba_n_groups"], "K": model["mamba_d_conv"],
            "chunk": model["mamba_chunk_size"], "E": dep["router_experts"],
            "lo": dep["expert_offset"], "held": model["num_local_experts"],
            "k": model["num_experts_per_tok"], "f": model["intermediate_size"],
            "fs": model["shared_intermediate_size"], "V": model["vocab_size"],
            "eps": model["rms_norm_eps"], "emb": model["embedding_multiplier"],
            "res": model["residual_multiplier"], "att": model["attention_multiplier"],
            "logits": model["logits_scaling"], "tied": model["tie_word_embeddings"]}


def _layer_specs(m: dict, kind: str) -> dict:
    """One layer's leaves in the program's layout, stacked over 1 rep."""
    d, f, fs, held = m["d"], m["f"], m["fs"], m["held"]
    out = {"ln1": Leaf((1, d), "scale")}
    if MIXER[kind] == "mamba":
        di, G, N, Hm, K = m["di"], m["G"], m["N"], m["Hm"], m["K"]
        conv = di + 2 * G * N
        out["mamba"] = {"in_proj": Leaf((1, d, 2 * di + 2 * G * N + Hm), "fanin"),
                        "conv_w": Leaf((1, K, conv), "normal"), "conv_b": Leaf((1, conv), "bias"),
                        "A_log": Leaf((1, Hm), "log_uniform"), "D": Leaf((1, Hm), "scale"),
                        "dt_bias": Leaf((1, Hm), "bias"), "norm_w": Leaf((1, di), "scale"),
                        "out_proj": Leaf((1, di, d), "fanin")}
    else:
        H, kvH, hd = m["H"], m["kvH"], m["hd"]
        out["attn"] = {"wq": Leaf((1, d, H * hd), "fanin"), "wk": Leaf((1, d, kvH * hd), "fanin"),
                       "wv": Leaf((1, d, kvH * hd), "fanin"), "wo": Leaf((1, H * hd, d), "fanin")}
    out["ln2"] = Leaf((1, d), "scale")
    out["moe"] = {"router": Leaf((1, d, m["E"]), "fanin"),
                  "w_gate": Leaf((1, held, d, f), "fanin"), "w_up": Leaf((1, held, d, f), "fanin"),
                  "w_down": Leaf((1, held, f, d), "fanin")}
    out["shared"] = {"w_gate": Leaf((1, d, fs), "fanin"), "w_up": Leaf((1, d, fs), "fanin"),
                     "w_down": Leaf((1, fs, d), "fanin")}
    return out


def leaf_specs(model: dict):
    """The weights' shapes and distributions, in the program's stacked
    tree: one pattern position a layer, each stacked over one rep."""
    m = dims(model)
    embed = {"tok": Leaf((m["V"], m["d"]), "normal")}
    if not m["tied"]:
        embed["unembed"] = Leaf((m["d"], m["V"]), "fanin")
    return {"embed": embed, "pattern": tuple(_layer_specs(m, t) for t in m["types"]),
            "remainder": (), "final_norm": Leaf((m["d"],), "scale")}


def _gated(m, w, y, z):
    return rmsnorm(y * silu(z), w["norm_w"][0], m["eps"]) @ w["out_proj"][0]


def _split(m, zxbcdt):
    di, GN = m["di"], m["G"] * m["N"]
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * GN], zxbcdt[..., 2 * di + 2 * GN:]


def _bc(m, conv, *lead):
    di, G, N, rep = m["di"], m["G"], m["N"], m["Hm"] // m["G"]
    Bm = conv[..., di:di + G * N].reshape(*lead, G, N).repeat_interleave(rep, dim=-2)
    Cm = conv[..., di + G * N:].reshape(*lead, G, N).repeat_interleave(rep, dim=-2)
    return Bm, Cm


def _mamba_prefill(m, w, h):
    B, S, _ = h.shape
    K = m["K"]
    z, xbc, dt = _split(m, h @ w["in_proj"][0])
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = silu(sum(padded[:, j:j + S] * w["conv_w"][0][j] for j in range(K)) + w["conv_b"][0])
    xs = conv[..., :m["di"]].reshape(B, S, m["Hm"], m["P"])
    Bm, Cm = _bc(m, conv, B, S)
    dt = softplus(dt + w["dt_bias"][0])
    A = -torch.exp(w["A_log"][0])
    y, state = ssd_chunked(xs * dt[..., None], dt * A, Bm, Cm, m["chunk"])
    y = (y + xs * w["D"][0][:, None]).reshape(B, S, m["di"])
    return _gated(m, w, y, z), {"conv": padded[:, -(K - 1):], "ssm": state}


def _mamba_step(m, w, h, cache):
    B = h.shape[0]
    z, xbc, dt = _split(m, h @ w["in_proj"][0])
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (B, K, conv)
    conv = silu((window * w["conv_w"][0]).sum(1) + w["conv_b"][0])
    xs = conv[:, :m["di"]].reshape(B, m["Hm"], m["P"])
    Bm, Cm = _bc(m, conv, B)
    dt = softplus(dt + w["dt_bias"][0])  # (B, Hm)
    A = -torch.exp(w["A_log"][0])
    state = cache["ssm"] * torch.exp(dt * A)[..., None, None] \
        + (dt[..., None] * xs)[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Cm) + xs * w["D"][0][:, None]
    return _gated(m, w, y.reshape(B, m["di"]), z), {"conv": window[:, 1:], "ssm": state}


def _attend(m, q, k, v, mask):
    """q (B, Tq, H, hd), k / v (B, Tk, kvH, hd), mask (Tq, Tk) or None."""
    rep = m["H"] // m["kvH"]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * m["att"]
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    B, Tq = q.shape[:2]
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).reshape(B, Tq, -1)


def _qkv(m, w, h):
    lead = h.shape[:-1]
    return (((h @ w[n][0]).reshape(*lead, heads, m["hd"]))
            for n, heads in (("wq", m["H"]), ("wk", m["kvH"]), ("wv", m["kvH"])))


def _attn_prefill(m, w, h):
    S = h.shape[1]
    q, k, v = _qkv(m, w, h)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    return _attend(m, q, k, v, causal) @ w["wo"][0], {"k": k, "v": v}


def _attn_step(m, w, h, cache):
    q, k, v = _qkv(m, w, h[:, None])
    k = torch.cat([cache["k"][:, :-1], k], dim=1)  # the clamped slot S - 1
    v = torch.cat([cache["v"][:, :-1], v], dim=1)
    return (_attend(m, q, k, v, None) @ w["wo"][0])[:, 0], {"k": k, "v": v}


def _mlp(w, h, j=None):
    pick = (lambda a: a[0]) if j is None else (lambda a: a[0][j])
    return (silu(h @ pick(w["w_gate"])) * (h @ pick(w["w_up"]))) @ pick(w["w_down"])


def _moe(m, w, h):
    """The held experts' part of the routed sum, a dense loop with masks."""
    logits = h @ w["router"][0]
    top, idx = torch.topk(logits, m["k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(h)
    for j in range(m["held"]):
        g = (gates * (idx == m["lo"] + j)).sum(-1, keepdim=True)
        y = y + g * _mlp(w, h, j)
    return y


def _ffn(m, w, x):
    h = rmsnorm(x, w["ln2"][0], m["eps"])
    return x + m["res"] * (_moe(m, w["moe"], h) + _mlp(w["shared"], h))


def _head(m, params, x):
    x = rmsnorm(x, params["final_norm"], m["eps"])
    w = params["embed"]["tok"].t() if m["tied"] else params["embed"]["unembed"]
    return (x @ w) / m["logits"]


def served_logits(model: dict, params, prompt, tokens):
    """(B, n, V): the logits from which served token ``tokens[:, j]`` was
    chosen: the prompt's last position for j = 0, then one step fed
    ``tokens[:, j-1]`` through the caches for each later j."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = dims(model)
    dev = params["final_norm"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    tokens = torch.as_tensor(tokens, device=dev).long()
    table = params["embed"]["tok"]
    layers = params["pattern"]
    x = table[prompt] * m["emb"]
    caches = []
    for kind, w in zip(m["types"], layers):
        h = rmsnorm(x, w["ln1"][0], m["eps"])
        y, c = (_mamba_prefill if kind == "mamba" else _attn_prefill)(m, w[MIXER[kind]], h)
        x = _ffn(m, w, x + m["res"] * y)
        caches.append(c)
    out = [_head(m, params, x[:, -1])]
    for j in range(1, tokens.shape[1]):
        x = table[tokens[:, j - 1]] * m["emb"]
        for i, (kind, w) in enumerate(zip(m["types"], layers)):
            h = rmsnorm(x, w["ln1"][0], m["eps"])
            y, caches[i] = (_mamba_step if kind == "mamba" else _attn_step)(
                m, w[MIXER[kind]], h, caches[i])
            x = _ffn(m, w, x + m["res"] * y)
        out.append(_head(m, params, x))
    return torch.stack(out, dim=1)
