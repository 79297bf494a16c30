"""Granite 4.0-H (hybrid Mamba-2 / NoPE attention layers, each with a
dropless MoE of routed experts and a shared expert) in the port, against
the benchmark's plain reference (``coldbench/reference/granite_hybrid.py``)
at a small size on the CPU: d 64, 2 experts held of a router over 6, top
3, 4 layers with attention at index 2, seeded weights from
``coldbench.reference.weights``.  The port serves through
``serve.instance.generate`` (prefill, then decode through its caches);
the MoE's grouped expert MLP runs its plain path here (K5's kernel, which
has no CPU mode, is held against it by the ``gpu`` case on the card)."""
import numpy as np
import pytest
import torch

from coldbench import spec
from coldbench.costs import moe_experts as k5_cost
from coldbench.reference import finetunes, granite_hybrid, weights
from coldbench.tests.small_hybrid import NAME
from coldbench.tests.small_hybrid import config as small
from repro_torch.configs import ModelConfig, get_config
from repro_torch.kernels.moe_experts import ops as k5
from repro_torch.models import mamba2, moe
from repro_torch.models.layers import mlp, rmsnorm
from repro_torch.serve.engine import generate, layerwise_state
from repro_torch.serve import instance

SEED = 2**31 + 11
# f32 on both sides, the same arithmetic summed in other orders (the port's
# chunked SSD at the kernel's chunk, its attention's softmax, its grouped
# expert MLP's index_add): relative to the step's largest logit
LOGITS_TOL = 1e-5


def served(config, params, prompt, new):
    """The port's tokens and every step's last-position logits, recorded
    where generation computes them (``serve.instance.unembed``)."""
    rec = []
    real = instance.unembed

    def unembed(cfg, p, x, dt):
        out = real(cfg, p, x, dt)
        rec.append(out[:, -1].clone())
        return out

    pcfg = spec.program_config(config)
    instance.unembed = unembed
    try:
        toks, _ = generate(pcfg, None, layerwise_state(pcfg, params), prompt, new, device="cpu")
    finally:
        instance.unembed = real
    return toks, torch.stack(rec, 1)


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("function", [None, "fn-esft"])
def test_port_prefill_and_decode_match_the_reference(offset, function):
    config = small(offset=offset)
    base = weights.draw(granite_hybrid.leaf_specs(config), SEED, "cpu")
    params = base if function is None else finetunes.make(base, config,
                                                          config["functions"][function])
    prompt = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int32)
    toks, got = served(config, params, prompt, 8)
    want = granite_hybrid.served_logits(config, params, prompt, torch.as_tensor(toks.astype(np.int64)))
    assert got.shape == want.shape == (2, 8, 256)
    scale = want.abs().amax(dim=(0, 2))
    assert float(((got - want).abs().amax(dim=(0, 2)) / scale).max()) < LOGITS_TOL
    assert (want.argmax(-1).numpy() == toks).all()


def _layer(config, seed=SEED):
    """The reference's dims and one layer's weights (the first, a Mamba-2
    layer), and a normalized input of 3 x 5 tokens."""
    m = granite_hybrid.dims(config)
    w = weights.draw(granite_hybrid.leaf_specs(config), seed, "cpu")["pattern"][0]
    x = torch.randn(3, 5, m["d"], generator=torch.Generator().manual_seed(seed))
    return m, w, x


def _port_moe(config, w_moe, h, shared=None):
    cfg = spec.program_config(config)
    p = {k: v[0] for k, v in w_moe.items()}
    with torch.no_grad():
        return moe.moe_ffn(cfg, p, h, torch.float32, shared=shared)[0]


def test_expert_shares_add_up_to_the_uncut_layer():
    """Three chips of 2 experts each: their routed parts, with the shared
    expert and the residual counted once, add up to the reference's layer
    with all 6 experts held."""
    uncut = small(held=6)
    m, w, x = _layer(uncut)
    want = granite_hybrid._ffn(m, w, x)
    h = rmsnorm(x, w["ln2"][0], m["eps"])
    routed = sum(_port_moe(small(held=2, offset=lo),
                           dict(w["moe"], **{k: w["moe"][k][:, lo:lo + 2]
                                             for k in ("w_gate", "w_up", "w_down")}), h)
                 for lo in (0, 2, 4))
    shared = mlp(None, {k: v[0] for k, v in w["shared"].items()}, h, torch.float32)
    got = x + m["res"] * (routed + shared)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # and one share with the shared expert folded in is the reference's
    # layer with only that share's experts held
    share = small(held=2, offset=2)
    ms = granite_hybrid.dims(share)
    ws = dict(w, moe=dict(w["moe"], **{k: w["moe"][k][:, 2:4]
                                       for k in ("w_gate", "w_up", "w_down")}))
    got = x + ms["res"] * _port_moe(share, ws["moe"], h, shared=shared.clone())
    torch.testing.assert_close(got, granite_hybrid._ffn(ms, ws, x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,S", [(1, 1), (2, 1), (3, 8), (64, 16)])
def test_no_pair_is_dropped(B, S):
    """A router skewed so that every token picks both held experts (a load
    that any capacity would cut): every pair is computed, the output is the
    dense loop's, and the counters see each pair once."""
    config = small()
    m, w, _ = _layer(config)
    router = w["moe"]["router"].clone()
    router[0, :, :2] += 10.0  # held experts 0 and 1 first for every token
    w_moe = dict(w["moe"], router=router)
    h = torch.randn(B, S, m["d"], generator=torch.Generator().manual_seed(B * 100 + S))
    h = h.abs() + 0.1  # positive, so the bias above wins every row
    routed0, held0 = k5.PAIRS.routed, k5.PAIRS.held()
    got = _port_moe(config, w_moe, h)
    want = granite_hybrid._moe(m, w_moe, h)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert k5.PAIRS.routed - routed0 == B * S * m["k"]
    assert k5.PAIRS.held() - held0 == B * S * 2


def test_gate_order_flag_leaves_mamba2_as_it_was():
    """mamba2-780m keeps the JAX package's order, rmsnorm(y) * silu(z), in
    the registry and in the benchmark's program group; Granite takes the
    published rmsnorm(y * silu(z))."""
    assert get_config("mamba2-780m").norm_before_gate
    assert spec.program_config(spec.config("mamba2-780m")).norm_before_gate
    assert not spec.program_config(spec.config(NAME)).norm_before_gate
    g = torch.Generator().manual_seed(5)
    y, z = torch.randn(2, 3, 32, generator=g), torch.randn(2, 3, 32, generator=g)
    p = {"norm_w": 1 + 0.1 * torch.randn(32, generator=g), "out_proj": torch.randn(32, 8, generator=g)}
    cfg = get_config("mamba2-780m")
    old = (rmsnorm(y, p["norm_w"], cfg.norm_eps) * torch.nn.functional.silu(z)) @ p["out_proj"]
    assert torch.equal(mamba2._gated_out(cfg, p, y, z, torch.float32), old)
    pub = cfg.__class__(**{**cfg.__dict__, "norm_before_gate": False})
    new = rmsnorm(y * torch.nn.functional.silu(z), p["norm_w"], cfg.norm_eps) @ p["out_proj"]
    assert torch.equal(mamba2._gated_out(pub, p, y, z, torch.float32), new)


def _routed(T, d, f, E, held, k, seed, device="cpu"):
    """x, the sorted held pairs of a random router over E experts (the first
    ``held`` held), the held experts' weights, and ``out`` started at a
    shared expert's stand-in."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(T, d, generator=g, device=device)
    router = torch.randn(d, E, generator=g, device=device) * d**-0.5
    top, idx = torch.topk(x @ router, k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    cfg = ModelConfig(
        name="k5", family="moe", n_layers=1, d_model=d, n_heads=1, n_kv_heads=1, d_ff=f,
        vocab_size=8, n_experts=held, top_k=k, router_experts=E, capacity_factor=None)
    tok, gate, offsets = moe._sort_pairs(cfg, idx, gates)
    ws = [torch.randn(held, d, f, generator=g, device=device) * d**-0.5,
          torch.randn(held, d, f, generator=g, device=device) * d**-0.5,
          torch.randn(held, f, d, generator=g, device=device) * f**-0.5]
    out = torch.randn(T, d, generator=g, device=device)
    return x, tok, gate, offsets, ws, out, idx, gates


def _dense_loop(x, idx, gates, ws, out):
    y = out.clone()
    for j in range(ws[0].shape[0]):
        gj = (gates * (idx == j)).sum(-1, keepdim=True)
        y += gj * ((torch.nn.functional.silu(x @ ws[0][j]) * (x @ ws[1][j])) @ ws[2][j])
    return y


@pytest.mark.parametrize("T", [1, 2, 37, 300])
def test_k5_plain_path_against_the_dense_loop(T):
    x, tok, gate, offsets, ws, out, idx, gates = _routed(T, 64, 64, 12, 3, 4, T)
    want = _dense_loop(x, idx, gates, ws, out)
    got = k5.moe_experts(x, tok, gate, offsets, *ws, out.clone())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    counts = torch.bincount(idx.reshape(-1), minlength=12)[:3]
    assert offsets.tolist() == [0, *torch.cumsum(counts, 0).tolist()]


def test_frozen_count_is_the_port_cost():
    """The benchmark's frozen count of a K5 call against the port's
    ``cost`` on the same routing, and its expectation under uniform routing
    at the cell's prefill near the routed count."""
    x, tok, gate, offsets, ws, out, idx, _ = _routed(300, 64, 64, 12, 3, 4, 1)
    off = offsets.tolist()
    touched = sum(b > a for a, b in zip(off, off[1:]))
    rows = int(tok[:off[-1]].unique().numel())
    assert k5.cost(x, tok, gate, offsets, *ws, out) == k5_cost.call_work(
        off[-1], touched, rows, 64, 64)
    pairs, touched, rows = k5_cost.expected(2048, 10, 72, 9)
    assert pairs == 2560 and touched == pytest.approx(9) and 1500 < rows < 1600


def test_esft_rewrites_two_held_experts_a_layer():
    """Two experts a layer, a different pair in each of the 10 layers; at
    the published widths that is 754,974,720 private bytes in 30 tensors."""
    config = small(held=9, experts=72, layers=("mamba",) * 5 + ("attention",) + ("mamba",) * 4)
    base = weights.draw(granite_hybrid.leaf_specs(config), SEED, "cpu")
    ft = finetunes.make(base, config, config["functions"]["fn-esft"])
    pairs = []
    for lb, lf in zip(base["pattern"], ft["pattern"]):
        changed = {k for k in lb if k != "moe" and not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(weights.leaves(lb[k]),
                                                        weights.leaves(lf[k])))}
        assert not changed
        diff = [(lb["moe"][k][0] != lf["moe"][k][0]).flatten(1).any(1)
                for k in ("w_gate", "w_up", "w_down")]
        assert all(torch.equal(diff[0], dd) for dd in diff)
        pairs.append(frozenset(torch.nonzero(diff[0]).flatten().tolist()))
        assert torch.equal(lb["moe"]["router"], lf["moe"]["router"])
    assert all(len(p) == 2 for p in pairs) and len(set(pairs)) == 10
    m = granite_hybrid.dims(spec.config(NAME))
    assert 10 * 2 * 3 * m["d"] * m["f"] * 4 == 754_974_720


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [2, 2048])
def test_moe_experts_kernel_on_gpu(cuda, T):
    """K5 against its plain path on the card at the cell's widths (d 4096,
    experts of 768, 9 held of a router over 72, top 10), a decode step's 2
    tokens and a prefill's 2 x 1024."""
    x, tok, gate, offsets, ws, out, idx, gates = _routed(T, 4096, 768, 72, 9, 10, T, cuda)
    launches, held = k5.LAUNCHES.count, k5.PAIRS.held()
    got = k5.moe_experts(x, tok, gate, offsets, *ws, out.clone())
    torch.cuda.synchronize()
    assert k5.LAUNCHES.count == launches + 1
    assert k5.PAIRS.held() - held == offsets[-1].item()
    want = k5.moe_experts_plain(x, tok, gate, offsets, *ws, out.clone())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, _dense_loop(x, idx, gates, ws, out), rtol=1e-5, atol=1e-5)
