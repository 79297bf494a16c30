"""Top-k MoE: capacity-based dispatch, and a dropless path.

Two execution paths with a capacity, as in ``repro.models.moe``:

* **local** (no sharding rules active): the reference's ``_moe_local``.
  Route in f32, give each (token, choice) pair a slot in its expert in
  token-major order up to the capacity, scatter into an (E, C, d) buffer,
  run every expert's gated MLP on its buffer, gather and combine by the
  gates.  Pairs past an expert's capacity are dropped, exactly where the
  reference drops them.  Each cast and each order follows the reference,
  so the routing, the drops and (in f32) the tokens match it.
* **expert parallel** (under ``axis_rules`` over a ``DeviceMesh``): the
  reference's ``shard_map`` paths over the ``model`` axis with explicit
  collectives (``sharding.collectives``).
  - ``a2a`` (train / prefill: the sequence divides the model axis): tokens
    sharded over (dp x model); each rank dispatches into an (E, C_rank, d)
    buffer with its own capacity, and two all-to-alls move the buffers to
    the experts' owners and back (GShard).
  - ``replicated`` (decode: one token per sequence): every model rank
    routes the dp-local tokens, computes only its E/m experts, and the
    outputs are summed over the model axis.
  FSDP-sharded expert weights are all-gathered inside the body.

And one without (``capacity_factor=None``, Granite's): **dropless**
(:func:`_moe_dropless`, no sharding rules).  The router runs over all
``routed_experts``; the layer holds ``n_experts`` of them, from
``expert_offset`` on (an expert-parallel deployment's share of a layer,
whose other experts live on other chips).  The gates are the softmax over
the top-k router logits, in f32.  Every (token, choice) pair on a held
expert is kept: the pairs are sorted by expert on the device and the
grouped expert MLP kernel (``repro_torch.kernels.moe_experts``) adds each
one, times its gate, into the output, which starts as the shared expert's
where the layer has one.  The pairs routed to experts held elsewhere add
nothing here; ``moe_experts.PAIRS`` counts both.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_experts import ops as k5
from repro_torch.sharding import collectives
from repro_torch.sharding.partition import as_axes, axis_sizes, current_rules, logical_to_spec

W_LOGICAL = {
    "w_gate": ("expert", "fsdp", "model"),
    "w_up": ("expert", "fsdp", "model"),
    "w_down": ("expert", "model", "fsdp"),
}


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, min(c, n_tokens * cfg.top_k))


def _route(cfg: ModelConfig, router_w, xf):
    """xf: (T, d) -> gates (T, k), idx (T, k), probs (T, E), all but idx f32.
    ``jax.lax.top_k`` takes the lower index on a tie and ``torch.topk``
    promises no order: ties are not expected in f32 and are not broken
    alike."""
    logits = torch.matmul(xf.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, idx, probs


def _one_hot(idx, E: int):
    """``F.one_hot(idx, E)``'s values.  ``F.one_hot`` checks the range of
    ``idx`` with a host sync on the CPU but not on the card, and runs other
    ops again on ``meta``; this runs the same ops on every device, so a
    step counts the same on each (``repro_torch.launch.hlo_analysis``)."""
    return (idx[..., None] == torch.arange(E, device=idx.device)).long()


def _positions(idx, E: int, C: int):
    """Slot positions within each expert for (T, k) routed pairs, in
    token-major order: (flat_e, flat_pos clamped to C - 1, keep)."""
    T, k = idx.shape
    oh = _one_hot(idx.reshape(T * k), E)
    pos = torch.cumsum(oh, dim=0) - oh
    flat_pos = (pos * oh).sum(dim=-1)
    flat_e = idx.reshape(T * k)
    keep = flat_pos < C
    return flat_e, flat_pos.clamp(max=C - 1), keep


def _aux_loss(cfg: ModelConfig, probs, idx):
    """The load-balance loss E * sum_e f_e * P_e / k."""
    return _aux_loss_over(probs, idx, cfg.n_experts, cfg.top_k)


def _aux_loss_over(probs, idx, E: int, k: int):
    oh = _one_hot(idx, E).float()  # (T, k, E)
    f_e = oh.sum(dim=1).mean(dim=0)
    P_e = probs.mean(dim=0)
    return E * torch.sum(f_e * P_e) / k


def _expert_mlp(h_in, wg, wu, wd):
    """Every expert's gated MLP on its (C, d) buffer: (E, C, d) -> (E, C, d)."""
    h = torch.bmm(h_in, wg)
    u = torch.bmm(h_in, wu)
    h = F.silu(h.float()).to(h_in.dtype) * u
    return torch.bmm(h, wd)


def _dispatch(xf, flat_e, flat_pos, keep, n_buf: int, C: int, k: int, compute_dtype):
    """Scatter each kept (token, choice) pair's row into an (n_buf, C, d)
    buffer.  A dropped pair adds zeros at its clamped slot; kept pairs have
    unique slots, so the scatter-add is exact."""
    T, d = xf.shape
    xr = xf[:, None, :].expand(T, k, d).reshape(T * k, d)
    rows = torch.where(keep[:, None], xr, 0.0)
    buf = torch.zeros((n_buf, C, d), dtype=compute_dtype, device=xf.device)
    return buf.index_put((flat_e, flat_pos), rows.to(compute_dtype), accumulate=True)


def _combine(out, flat_e, flat_pos, keep, gates, T: int, k: int, compute_dtype):
    """Gather each pair's expert output and sum a token's pairs by their
    gates (a dropped pair weighs 0)."""
    vals = out[flat_e, flat_pos]
    w = torch.where(keep, gates.reshape(T * k), 0.0).to(compute_dtype)
    return (vals * w[:, None]).reshape(T, k, -1).sum(dim=1)


def _moe_local(cfg: ModelConfig, p: Dict, x, compute_dtype):
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(cfg, T)
    xf = x.reshape(T, d)
    gates, idx, probs = _route(cfg, p["router"], xf)
    flat_e, flat_pos, keep = _positions(idx, E, C)
    buf = _dispatch(xf, flat_e, flat_pos, keep, E, C, k, compute_dtype)
    out = _expert_mlp(
        buf,
        p["w_gate"].to(compute_dtype),
        p["w_up"].to(compute_dtype),
        p["w_down"].to(compute_dtype),
    )
    y = _combine(out, flat_e, flat_pos, keep, gates, T, k, compute_dtype)
    return y.reshape(B, S, d), _aux_loss(cfg, probs, idx)


def _gather_fsdp(w, spec, compute_dtype, mesh):
    """Inside the body: all-gather any FSDP-sharded weight dims, cast."""
    for axis_pos, ax in enumerate(spec):
        if ax is None or axis_pos == 0:  # dim 0 is the expert (EP) dim: keep
            continue
        for name in as_axes(ax):
            w = collectives.all_gather(w, mesh, name, axis_pos)
    return w.to(compute_dtype)


def _sort_pairs(cfg: ModelConfig, idx, gates):
    """The (token, choice) pairs on the held experts, sorted by expert
    (stable, so token-major within one): (token of each pair, its gate,
    offsets (E + 1) of each held expert's pairs), int32 / f32 / int32, on
    the device, with the pairs held elsewhere after ``offsets[E]``."""
    E, k = cfg.n_experts, cfg.top_k
    local = idx.reshape(-1) - cfg.expert_offset
    key = torch.where((local >= 0) & (local < E), local, E)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts[:E], 0, dtype=torch.int32), (1, 0))
    return (order // k).to(torch.int32), gates.reshape(-1)[order].contiguous(), offsets


def _moe_dropless(cfg: ModelConfig, p: Dict, x, compute_dtype, shared=None, layer: int = -1):
    B, S, d = x.shape
    T, k = B * S, cfg.top_k
    xf = x.reshape(T, d)
    logits = torch.matmul(xf.float(), p["router"].float())  # (T, routed_experts)
    top, idx = torch.topk(logits, k, dim=-1, sorted=True)
    gates = torch.softmax(top, dim=-1)
    tok, gate, offsets = _sort_pairs(cfg, idx, gates)
    out = torch.zeros_like(xf) if shared is None else shared.reshape(T, d).contiguous()
    xc = xf.to(compute_dtype).contiguous()
    w = [p[n].to(compute_dtype) for n in ("w_gate", "w_up", "w_down")]
    k5.PAIRS.add_routed(T * k)
    if obs.ON:
        load = offsets.diff().tolist()  # a synchronize, only while recording
        with obs.span("gen.moe", layer=layer, pairs_held=sum(load),
                      max_expert_load=max(load)):
            with obs.span("moe.experts"):
                k5.moe_experts(xc, tok, gate.to(compute_dtype), offsets, *w, out)
    else:
        k5.moe_experts(xc, tok, gate.to(compute_dtype), offsets, *w, out)
    aux = (_aux_loss_over(torch.softmax(logits, dim=-1), idx, cfg.routed_experts, k)
           if torch.is_grad_enabled() else torch.zeros((), dtype=torch.float32, device=x.device))
    return out.reshape(B, S, d), aux


def moe_ffn(cfg: ModelConfig, p: Dict, x, compute_dtype, shared=None,
            layer: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux loss): without rules the dropless path where the
    config has no capacity, else the local path; under rules the
    reference's dispatcher: ``a2a`` iff E and S divide the model axis,
    S > 1 and the axis has more than one rank, otherwise replicated
    routing.  ``shared`` (the shared expert's output, or None) is added to
    y; ``layer`` names the layer in the dropless path's span.  The
    dropless path's load-balance loss is computed only where autograd
    records (it is 0 in serving)."""
    rules = current_rules()
    if cfg.capacity_factor is None:
        if rules is not None:
            raise NotImplementedError(f"{cfg.name}: a dropless MoE runs without sharding rules")
        return _moe_dropless(cfg, p, x, compute_dtype, shared, layer)
    y, aux = _moe_capacity(cfg, p, x, compute_dtype, rules)
    return (y if shared is None else y + shared), aux


def _moe_capacity(cfg: ModelConfig, p: Dict, x, compute_dtype, rules):
    if rules is None:
        return _moe_local(cfg, p, x, compute_dtype)

    mesh = rules.mesh
    sizes = axis_sizes(mesh)
    m_ax = "model"
    m = sizes.get(m_ax, 1)
    E = cfg.n_experts
    B, S, d = x.shape
    dp_axes = as_axes(rules.mapping.get("batch"))
    dp = int(math.prod(sizes[a] for a in dp_axes)) if dp_axes else 1

    batch_shardable = B % dp == 0 and dp > 1
    bspec = dp_axes if batch_shardable else None
    a2a = (E % m == 0) and (S % m == 0) and S > 1 and m > 1

    w_specs = {key: logical_to_spec(W_LOGICAL[key], p[key].shape, rules) for key in W_LOGICAL}
    all_axes = tuple(sizes)
    body = _moe_a2a_local if a2a else _moe_repl_local
    fn = partial(body, cfg, compute_dtype, mesh, m_ax, m, all_axes, w_specs)
    x_spec = (bspec, m_ax, None) if a2a else (bspec, None, None)
    in_specs = (x_spec, (None, None), w_specs["w_gate"], w_specs["w_up"], w_specs["w_down"])
    y, aux = collectives.shard_map(fn, mesh, in_specs, (x_spec, ()))(
        x, p["router"], p["w_gate"], p["w_up"], p["w_down"]
    )
    return y, aux


def _moe_a2a_local(cfg, compute_dtype, mesh, m_ax, m, all_axes, w_specs,
                   xl, router, wg, wu, wd):
    """Per-rank body, tokens sharded (dp x model): dispatch -> a2a ->
    expert mlp -> a2a back -> combine.  Capacity is this rank's: C of its
    own T tokens, as the reference enforces it per shard."""
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // m
    Bl, Sl, d = xl.shape
    T = Bl * Sl
    C = capacity(cfg, T)
    xf = xl.reshape(T, d)

    gates, idx, probs = _route(cfg, router, xf)
    flat_e, flat_pos, keep = _positions(idx, E, C)
    buf = _dispatch(xf, flat_e, flat_pos, keep, E, C, k, compute_dtype)

    send = buf.reshape(m, E_loc, C, d)
    recv = collectives.all_to_all(send, mesh, m_ax)
    x_e = recv.transpose(0, 1).reshape(E_loc, m * C, d)

    wg = _gather_fsdp(wg, w_specs["w_gate"], compute_dtype, mesh)
    wu = _gather_fsdp(wu, w_specs["w_up"], compute_dtype, mesh)
    wd = _gather_fsdp(wd, w_specs["w_down"], compute_dtype, mesh)
    out_e = _expert_mlp(x_e, wg, wu, wd)

    back = out_e.reshape(E_loc, m, C, d).transpose(0, 1)
    got = collectives.all_to_all(back, mesh, m_ax)
    out = got.reshape(E, C, d)

    y = _combine(out, flat_e, flat_pos, keep, gates, T, k, compute_dtype).reshape(Bl, Sl, d)
    aux = collectives.pmean(_aux_loss(cfg, probs, idx), mesh, all_axes)
    return y, aux


def _moe_repl_local(cfg, compute_dtype, mesh, m_ax, m, all_axes, w_specs,
                    xl, router, wg, wu, wd):
    """Per-rank body, tokens replicated over the model axis: each rank
    computes its E/m experts, outputs summed over the axis."""
    E, k = cfg.n_experts, cfg.top_k
    divisible = E % m == 0
    E_loc = E // m if divisible else E
    Bl, Sl, d = xl.shape
    T = Bl * Sl
    C = capacity(cfg, T)
    xf = xl.reshape(T, d)

    gates, idx, probs = _route(cfg, router, xf)
    flat_e, flat_pos, keep = _positions(idx, E, C)

    rank = collectives.axis_index(mesh, m_ax) if m > 1 else 0
    if divisible:
        e_start = rank * E_loc
        mine = keep & (flat_e >= e_start) & (flat_e < e_start + E_loc)
    else:  # experts unshardable: rank 0 computes everything (rare fallback)
        e_start = 0
        mine = keep & (rank == 0) if m > 1 else keep
    e_rel = torch.clamp(flat_e - e_start, 0, E_loc - 1)
    buf = _dispatch(xf, e_rel, flat_pos, mine, E_loc, C, k, compute_dtype)

    wg = _gather_fsdp(wg, w_specs["w_gate"], compute_dtype, mesh)
    wu = _gather_fsdp(wu, w_specs["w_up"], compute_dtype, mesh)
    wd = _gather_fsdp(wd, w_specs["w_down"], compute_dtype, mesh)
    out = _expert_mlp(buf, wg, wu, wd)

    y = _combine(out, e_rel, flat_pos, mine, gates, T, k, compute_dtype)
    if m > 1:
        y = collectives.all_reduce(y, mesh, m_ax)
    y = y.reshape(Bl, Sl, d)
    aux = collectives.pmean(_aux_loss(cfg, probs, idx), mesh, all_axes)
    return y, aux
