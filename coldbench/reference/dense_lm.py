"""Plain PyTorch reference of a dense decoder LM with QKV bias and tied
embeddings (Qwen1.5 / Qwen2: pre-norm RMSNorm, rotary embeddings with the
half rotation, grouped-query attention, a SwiGLU MLP), in float32 with
TF32 off, written from the published architecture and importing nothing
of the program.

Serving semantics follow the JAX package's, and with them one departure
from the published model, the **clamped decode slot**: a prefill of S
tokens leaves a cache of exactly S slots that never grows, and every
decode step writes its key and value into slot S - 1 (the reference's
``dynamic_update_slice`` clamps the start index), over the last prompt
token and then over each earlier decoded token.  So decode step k, fed
token ``out[k]`` at position S + k, attends to the first S - 1 prompt
tokens and to itself.  :func:`served_logits` computes exactly that, as a
full causal forward over ``prompt[:S-1] + [out[k]]`` at positions
``0..S-2, S+k``: the prompt tokens' keys and values do not depend on
anything after them.
"""
from __future__ import annotations

import torch

from coldbench.reference.weights import Leaf


def dims(model: dict) -> dict:
    d, H = model["hidden_size"], model["num_attention_heads"]
    return {"d": d, "L": model["num_hidden_layers"], "H": H,
            "kvH": model["num_key_value_heads"], "hd": model.get("head_dim") or d // H,
            "f": model["intermediate_size"], "V": model["vocab_size"],
            "eps": model["rms_norm_eps"], "theta": model["rope_theta"],
            "bias": model["qkv_bias"], "tied": model["tie_word_embeddings"]}


def leaf_specs(model: dict):
    """The weights' shapes and distributions, in the program's stacked tree."""
    m = dims(model)
    d, L, H, kvH, hd, f, V = (m[k] for k in ("d", "L", "H", "kvH", "hd", "f", "V"))
    attn = {"wq": Leaf((L, d, H * hd), "fanin"), "wk": Leaf((L, d, kvH * hd), "fanin"),
            "wv": Leaf((L, d, kvH * hd), "fanin"), "wo": Leaf((L, H * hd, d), "fanin")}
    if m["bias"]:
        attn.update(bq=Leaf((L, H * hd), "bias"), bk=Leaf((L, kvH * hd), "bias"),
                    bv=Leaf((L, kvH * hd), "bias"))
    embed = {"tok": Leaf((V, d), "normal")}
    if not m["tied"]:
        embed["unembed"] = Leaf((d, V), "fanin")
    layer = {"ln1": Leaf((L, d), "scale"), "attn": attn, "ln2": Leaf((L, d), "scale"),
             "mlp": {"w_gate": Leaf((L, d, f), "fanin"), "w_up": Leaf((L, d, f), "fanin"),
                     "w_down": Leaf((L, f, d), "fanin")}}
    return {"embed": embed, "pattern": (layer,), "remainder": (),
            "final_norm": Leaf((d,), "scale")}


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate(x, positions, theta):
    """Rotary embedding: x (N, T, H, hd), positions (N, T)."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def last_logits(model: dict, params, tokens, positions):
    """Logits (N, V) at the last position of each causal sequence."""
    m = dims(model)
    N, T = tokens.shape
    H, kvH, hd, eps = m["H"], m["kvH"], m["hd"], m["eps"]
    p = params["pattern"][0]
    x = params["embed"]["tok"][tokens]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for i in range(m["L"]):
        a = p["attn"]
        h = rmsnorm(x, p["ln1"][i], eps)
        q, k, v = h @ a["wq"][i], h @ a["wk"][i], h @ a["wv"][i]
        if m["bias"]:
            q, k, v = q + a["bq"][i], k + a["bk"][i], v + a["bv"][i]
        q = rotate(q.view(N, T, H, hd), positions, m["theta"])
        k = rotate(k.view(N, T, kvH, hd), positions, m["theta"])
        v = v.view(N, T, kvH, hd)
        k = k.repeat_interleave(H // kvH, dim=2)
        v = v.repeat_interleave(H // kvH, dim=2)
        s = torch.einsum("nqhd,nkhd->nhqk", q, k) * hd ** -0.5
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("nhqk,nkhd->nqhd", s.softmax(-1), v).reshape(N, T, H * hd)
        x = x + o @ a["wo"][i]
        h = rmsnorm(x, p["ln2"][i], eps)
        mp = p["mlp"]
        g = h @ mp["w_gate"][i]
        x = x + (g * torch.sigmoid(g) * (h @ mp["w_up"][i])) @ mp["w_down"][i]
    x = rmsnorm(x[:, -1], params["final_norm"], eps)
    w = params["embed"]["tok"].t() if m["tied"] else params["embed"]["unembed"]
    return x @ w


def served_logits(model: dict, params, prompt, tokens):
    """(B, n, V): the logits from which served token ``tokens[:, j]`` was
    chosen, for each j: the prefill's last position for j = 0, decode step
    j - 1 (fed ``tokens[:, j-1]``) after it."""
    B, S = prompt.shape
    n = tokens.shape[1]
    dev = params["final_norm"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.arange(S, device=dev)
    seqs, poss = [prompt], [pos.expand(B, S)]
    for j in range(1, n):
        seqs.append(torch.cat([prompt[:, :S - 1], tokens[:, j - 1:j]], dim=1))
        poss.append(torch.cat([pos[:S - 1], pos.new_tensor([S + j - 1])]).expand(B, S))
    out = last_logits(model, params, torch.cat(seqs), torch.cat(poss))
    return out.view(n, B, -1).transpose(0, 1)
