"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's local path (``repro.models.moe``), on the CPU.

Weights come from the reference's ``moe_specs`` initializer and cross with
``interop.params_from_jax``; activations are made with numpy from a seed.
Routing is compared exactly (expert indices, slot positions, the kept
mask); gates, probabilities and the aux loss within 1e-6; the FFN's output
within the f32 2e-5 of ``tests/test_kernels.py`` and, in bf16, within a
relative RMS of 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.treeutil import flatten_state
from repro_torch.interop import params_from_jax, to_torch
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_REL_RMS = 2e-2
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)


def _configs(arch, suffix, **replace):
    """The same variant in both packages, under a name of its own (the
    reference's serving caches jitted layers by ``cfg.name``)."""
    def make(base):
        return dataclasses.replace(base, name=f"{base.name}-{suffix}", **replace)

    return make(get_config(arch)), make(t_get_config(arch))


# (a) reduced olmoe (E 4, k 2); (b) olmoe's own E 64 / k 8 at a narrow
# width, prefill (T 32, pairs dropped) and decode (T 2, capacity 4, no
# drop); (c) reduced phi3.5-moe (top-2 of its reduced 4 experts, GQA)
CASES = {
    "olmoe-reduced": (lambda: (get_config("olmoe-1b-7b").reduced(),
                               t_get_config("olmoe-1b-7b").reduced()), (2, 8)),
    "olmoe-e64-prefill": (lambda: _configs("olmoe-1b-7b", "e64", d_model=64, d_ff=32),
                          (2, 16)),
    "olmoe-e64-decode": (lambda: _configs("olmoe-1b-7b", "e64", d_model=64, d_ff=32),
                         (2, 1)),
    "phi3.5-moe-reduced": (lambda: (get_config("phi3.5-moe-42b-a6.6b").reduced(),
                                    t_get_config("phi3.5-moe-42b-a6.6b").reduced()), (2, 8)),
}


def _case(name, seed=9):
    make, (B, S) = CASES[name]
    cfg, tcfg = make()
    specs = jmoe.moe_specs(cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(specs))
    jp = {k: s.initialize(key, jnp.float32) for key, (k, s) in zip(keys, sorted(specs.items()))}
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, tcfg, jp, tp, x


def _routes(name):
    cfg, tcfg, jp, tp, x = _case(name)
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, cfg.d_model)
    want = jmoe._route(cfg, jp["router"], jnp.asarray(xf))
    got = tmoe._route(tcfg, tp["router"], to_torch(xf))
    return cfg, tcfg, T, want, got


@pytest.mark.parametrize("T", [1, 2, 32, 4096])
def test_capacity_matches_reference(T):
    cfg, tcfg = _configs("olmoe-1b-7b", "cap")
    assert tmoe.capacity(tcfg, T) == jmoe.capacity(cfg, T)
    r, tr = get_config("olmoe-1b-7b").reduced(), t_get_config("olmoe-1b-7b").reduced()
    assert tmoe.capacity(tr, T) == jmoe.capacity(r, T)


@pytest.mark.parametrize("name", list(CASES))
def test_route_matches_reference(name):
    _, _, _, (jg, ji, jpr), (tg, ti, tpr) = _routes(name)
    assert ti.dtype == torch.int64 and np.array_equal(ti.numpy(), np.asarray(ji))
    assert tg.dtype == tpr.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **ROUTE_TOL)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), **ROUTE_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_positions_and_aux_loss_match_reference(name):
    cfg, tcfg, T, (_, ji, jpr), (_, ti, tpr) = _routes(name)
    C = jmoe.capacity(cfg, T)
    jfe, jfp, jkeep = jmoe._positions(ji, cfg.n_experts, C)
    tfe, tfp, tkeep = tmoe._positions(ti, tcfg.n_experts, C)
    for got, want in ((tfe, jfe), (tfp, jfp), (tkeep, jkeep)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(tmoe._aux_loss(tcfg, tpr, ti)),
                               float(jmoe._aux_loss(cfg, jpr, ji)), **ROUTE_TOL)


def test_olmoe_prefill_drops_pairs_and_decode_drops_none():
    """At olmoe's 64 experts and top-8, a 32-token prefill has capacity 5
    and drops pairs (the port must drop the same ones); a 2-token decode
    has the floor capacity 4 and cannot drop."""
    for name, C, dropped in (("olmoe-e64-prefill", 5, True), ("olmoe-e64-decode", 4, False)):
        cfg, tcfg, T, _, (_, ti, _) = _routes(name)
        assert tmoe.capacity(tcfg, T) == C
        _, _, keep = tmoe._positions(ti, tcfg.n_experts, C)
        assert bool((~keep).any()) == dropped, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_reference(name, dtype):
    cfg, tcfg, jp, tp, x = _case(name)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jy, jaux = jmoe.moe_ffn(cfg, jp, jnp.asarray(x).astype(jdt), jdt)
    ty, taux = tmoe.moe_ffn(tcfg, tp, to_torch(x).to(tdt), tdt)
    assert ty.dtype == tdt and ty.shape == x.shape and taux.dtype == torch.float32
    got, want = ty.float().numpy(), np.asarray(jy.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        rel_rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        assert rel_rms <= BF16_REL_RMS, rel_rms
    np.testing.assert_allclose(float(taux), float(jaux), **ROUTE_TOL)


def test_moe_ffn_gradients_match_reference():
    """The train mode's backward through dispatch, the dropped pairs and
    the gates: every weight's gradient and the input's, f32."""
    cfg, tcfg, jp, tp, x = _case("olmoe-e64-prefill")

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(cfg, p, xx, jnp.float32)
        return jnp.sum(y * y) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = to_torch(x).clone().requires_grad_()
    y, aux = tmoe.moe_ffn(tcfg, leaves, tx, torch.float32)
    (torch.sum(y * y) + aux).backward()
    for k in jg:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)


def test_moe_param_shapes_match_reference():
    """``lm.param_specs`` gives an MoE layer the reference's ``moe``
    subtree (router in f32, stacked over the pattern's reps), and
    ``init_params`` scales it by fan-in."""
    cfg, tcfg = get_config("olmoe-1b-7b").reduced(), t_get_config("olmoe-1b-7b").reduced()
    jparams = jlm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    mine = tlm.init_params(tcfg, seed=0, device="cpu")
    want = {n: (a.shape, str(a.dtype)) for n, a in flatten_state(jparams)[0]}
    got = {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in flatten_state(mine)[0]}
    assert got == want and any("moe" in n for n in got)
    moe = mine["pattern"][0]["moe"]
    assert moe["router"].shape == (tcfg.pattern_reps, tcfg.d_model, tcfg.n_experts)
    assert abs(moe["w_down"].std().item() - tcfg.d_ff ** -0.5) < 0.02
    bf16 = tlm.init_params(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    assert bf16["pattern"][0]["moe"]["router"].dtype == torch.float32
    assert bf16["pattern"][0]["moe"]["w_gate"].dtype == torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["olmoe-e64-prefill", "olmoe-e64-decode"])
def test_moe_ffn_on_gpu_matches_cpu(name):
    """The MoE FFN on the card (no CPU fallback) against the CPU path on the
    same inputs: the same routing and drops, the output within f32 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from repro_torch.device import resolve_device

    dev = resolve_device(None)
    cfg, tcfg, _, tp, x = _case(name)
    T = x.shape[0] * x.shape[1]
    C = tmoe.capacity(tcfg, T)
    out = {}
    for d in ("cpu", dev):
        p = {k: v.to(d) for k, v in tp.items()}
        xx = to_torch(x, d)
        _, idx, _ = tmoe._route(tcfg, p["router"], xx.reshape(T, -1))
        _, _, keep = tmoe._positions(idx, tcfg.n_experts, C)
        y, aux = tmoe.moe_ffn(tcfg, p, xx, torch.float32)
        assert y.device.type == torch.device(d).type
        out[torch.device(d).type] = (idx.cpu(), keep.cpu(), y.cpu(), float(aux))
    (ci, ck, cy, ca), (gi, gk, gy, ga) = out["cpu"], out["cuda"]
    assert torch.equal(gi, ci) and torch.equal(gk, ck)
    np.testing.assert_allclose(gy.numpy(), cy.numpy(), **F32_TOL)
    np.testing.assert_allclose(ga, ca, **ROUTE_TOL)
