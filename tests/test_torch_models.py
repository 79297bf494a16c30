"""The port's model code against ``repro.models`` on the same weights.

Weights come from the JAX package's initializer and cross with
``params_from_jax``; activations are made with numpy from a seed.  The
tolerance is rtol/atol 1e-5 in f32: the only difference is the order of
summation.  The MoE architectures (reduced olmoe-1b-7b; reduced
jamba-v0.1-52b, whose layers mix attention, Mamba2 and MoE) also generate
greedy tokens equal to the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve.instance import generate as jgenerate
from repro.serve.instance import layerwise_state as jlayerwise
from repro_torch.configs import get_config as t_get_config
from repro_torch.interop import params_from_jax, to_torch, tree_leaves, tree_map
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import generate, layerwise_state

ARCH = "qwen1.5-0.5b"
MOE_ARCH = "olmoe-1b-7b"
HYBRID_ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _model(arch):
    cfg = get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    params = jlm.init_params(cfg, jax.random.PRNGKey(7), jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    # the layer params of layer 0, in both packages
    jp0 = jax.tree.map(lambda a: a[0], params["pattern"][0])
    tp0 = tree_map(lambda a: to_torch(a[0]), np_params["pattern"][0])
    return cfg, tcfg, params, params_from_jax(np_params, "cpu"), jp0, tp0


@pytest.fixture(scope="module")
def model():
    return _model(ARCH)


@pytest.fixture(scope="module")
def moe_model():
    return _model(MOE_ARCH)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_params_from_jax_keeps_nesting_shapes_and_dtypes(model):
    cfg, tcfg, params, tparams, _, _ = model
    jleaves = jax.tree.leaves(params)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype)[6:]
    assert set(tparams) == {"embed", "pattern", "remainder", "final_norm"}
    assert isinstance(tparams["pattern"], tuple) and tparams["remainder"] == ()


def test_init_params_matches_reference_shapes(model):
    cfg, tcfg, params, _, _, _ = model
    from repro_torch.core.treeutil import flatten_state

    mine = tlm.init_params(tcfg, seed=0, device="cpu")
    want = {n: (a.shape, str(a.dtype)) for n, a in flatten_state(params)[0]}
    got = {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in flatten_state(mine)[0]}
    assert got == want
    tleaves = tree_leaves(mine)
    # fan-in scaling: wq rows ~ N(0, 1/d_model); norms are ones, biases zeros
    wq = mine["pattern"][0]["attn"]["wq"]
    assert abs(wq.std().item() - tcfg.d_model ** -0.5) < 0.02
    assert torch.all(mine["final_norm"] == 1) and torch.all(mine["pattern"][0]["attn"]["bq"] == 0)
    again = tlm.init_params(tcfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tleaves, tree_leaves(again)))


def test_rmsnorm(model):
    x, w = _x(0, 2, 5, 64), _x(1, 64)
    _close(tlayers.rmsnorm(to_torch(x), to_torch(w), 1e-6),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_apply_rope(model):
    x = _x(2, 2, 6, 4, 16)
    pos = np.broadcast_to(np.arange(3, 9, dtype=np.int32), (2, 6))
    _close(tlayers.apply_rope(to_torch(x), to_torch(pos.copy()), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    # M-RoPE: (3, B, S) t/h/w positions, and (B, S) broadcast to all three
    pos3 = np.stack([np.zeros((2, 6), np.int32), pos // 2, pos % 3])
    for p in (pos3, pos.copy()):
        _close(tlayers.apply_rope(to_torch(x), to_torch(p), 1e4, mrope=True),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e4, mrope=True))


def test_mlp(model):
    cfg, tcfg, _, _, jp0, tp0 = model
    x = _x(3, 2, 5, cfg.d_model)
    _close(tlayers.mlp(tcfg, tp0["mlp"], to_torch(x), torch.float32),
           jlayers.mlp(cfg, jp0["mlp"], jnp.asarray(x), F32))


def test_embed_and_tied_unembed(model):
    cfg, tcfg, params, tparams, _, _ = model
    assert tcfg.tie_embeddings
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    _close(tlayers.embed(tcfg, tparams["embed"], to_torch(toks), torch.float32),
           jlayers.embed(cfg, params["embed"], jnp.asarray(toks), F32))
    x = _x(5, 2, 3, cfg.d_model)
    _close(tlayers.unembed(tcfg, tparams["embed"], to_torch(x), torch.float32),
           jlayers.unembed(cfg, params["embed"], jnp.asarray(x), F32))


def _prefill_pair(cfg, tcfg, jp, tp, spec, S, kv_dtype=None, seed=6):
    x = _x(seed, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jy, jc = jattn.attn_full(cfg, spec, jp["attn"], jnp.asarray(x), jnp.asarray(pos), F32,
                             return_cache=True, kv_dtype=kv_dtype)
    tkv = None if kv_dtype is None else torch.int8
    ty, tc = tattn.attn_full(tcfg, spec, tp["attn"], to_torch(x), to_torch(pos), torch.float32,
                             return_cache=True, kv_dtype=tkv)
    return jy, jc, ty, tc


@pytest.mark.parametrize("window,S", [(None, 8), (None, 5), (4, 9)])
def test_attn_full_with_cache(model, window, S):
    cfg, tcfg, _, _, jp0, tp0 = model
    spec = dataclasses.replace(cfg.pattern[0], window=window)
    jy, jc, ty, tc = _prefill_pair(cfg, tcfg, jp0, tp0, spec, S)
    _close(ty, jy)
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:  # a windowed cache keeps slot p % W for position p
        _close(tc[key], jc[key])


def test_attn_full_int8_cache(model):
    cfg, tcfg, _, _, jp0, tp0 = model
    jy, jc, ty, tc = _prefill_pair(cfg, tcfg, jp0, tp0, cfg.pattern[0], 6, jnp.int8)
    for key in ("k", "v"):
        assert tc[key].dtype == torch.int8
        assert np.abs(tc[key].numpy().astype(int) - np.asarray(jc[key]).astype(int)).max() <= 1
    for key in ("k_scale", "v_scale"):
        _close(tc[key], jc[key])


@pytest.mark.parametrize("pos", [4, 6])
def test_attn_decode_clamps_slot_like_reference(model, pos):
    """A prefill cache has exactly S slots and never grows: the reference's
    dynamic_update_slice clamps every later write to slot S-1, and the port
    mirrors that (otherwise its tokens would differ)."""
    cfg, tcfg, _, _, jp0, tp0 = model
    spec = cfg.pattern[0]
    S = 4
    _, jc, _, tc = _prefill_pair(cfg, tcfg, jp0, tp0, spec, S)
    x = _x(8, 2, 1, cfg.d_model)
    jy, jc2 = jattn.attn_decode(cfg, spec, jp0["attn"], jnp.asarray(x), jc, jnp.int32(pos), F32)
    before = tc["k"].clone()
    ty, tc2 = tattn.attn_decode(tcfg, spec, tp0["attn"], to_torch(x), tc, pos, torch.float32)
    _close(ty, jy)
    for key in ("k", "v"):
        _close(tc2[key], jc2[key])
    changed = (tc2["k"] != before).any(dim=(0, 1, 3))
    assert changed.tolist() == [False] * (S - 1) + [True]  # only slot S-1


def test_attn_decode_int8_cache(model):
    cfg, tcfg, _, _, jp0, tp0 = model
    spec = cfg.pattern[0]
    _, jc, _, tc = _prefill_pair(cfg, tcfg, jp0, tp0, spec, 6, jnp.int8)
    tc = {k: to_torch(np.asarray(v)) for k, v in jc.items()}  # identical start
    x = _x(9, 2, 1, cfg.d_model)
    jy, jc2 = jattn.attn_decode(cfg, spec, jp0["attn"], jnp.asarray(x), jc, jnp.int32(3), F32)
    ty, tc2 = tattn.attn_decode(tcfg, spec, tp0["attn"], to_torch(x), tc, 3, torch.float32)
    _close(ty, jy, dict(rtol=2e-4, atol=2e-4))
    for key in ("k_scale", "v_scale"):
        _close(tc2[key], jc2[key])


def test_apply_layer_prefill_then_decode(model):
    cfg, tcfg, _, _, jp0, tp0 = model
    spec = cfg.pattern[0]
    S = 6
    x = _x(10, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jx, jc, _ = jblocks.apply_layer(cfg, spec, jp0, jnp.asarray(x), positions=jnp.asarray(pos),
                                    mode="prefill", cache=None, pos=None, compute_dtype=F32)
    tx, tc, _ = tblocks.apply_layer(tcfg, spec, tp0, to_torch(x), positions=to_torch(pos),
                                 mode="prefill", cache=None, pos=None,
                                 compute_dtype=torch.float32)
    _close(tx, jx)
    x1 = _x(11, 2, 1, cfg.d_model)
    dpos = np.full((2, 1), S, np.int32)
    jx1, _, _ = jblocks.apply_layer(cfg, spec, jp0, jnp.asarray(x1), positions=jnp.asarray(dpos),
                                    mode="decode", cache=jc, pos=jnp.int32(S), compute_dtype=F32)
    tx1, _, _ = tblocks.apply_layer(tcfg, spec, tp0, to_torch(x1), positions=None, mode="decode",
                                 cache=tc, pos=S, compute_dtype=torch.float32)
    _close(tx1, jx1)


@pytest.mark.parametrize("S", [6, 32])
def test_apply_layer_moe_prefill_then_decode(moe_model, S):
    """An attention layer with an MoE FFN, prefill then one decode step,
    against ``repro.models.blocks``: the output and the aux loss (the
    reference returns the FFN's aux in every mode).  At S 32 the reduced
    config's capacity drops pairs."""
    cfg, tcfg, _, _, jp0, tp0 = moe_model
    spec = cfg.pattern[0]
    assert spec.moe and "moe" in tp0 and "mlp" not in tp0
    x = _x(12, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jx, jc, jaux = jblocks.apply_layer(cfg, spec, jp0, jnp.asarray(x),
                                       positions=jnp.asarray(pos), mode="prefill", cache=None,
                                       pos=None, compute_dtype=F32)
    tx, tc, taux = tblocks.apply_layer(tcfg, spec, tp0, to_torch(x), positions=to_torch(pos),
                                       mode="prefill", cache=None, pos=None,
                                       compute_dtype=torch.float32)
    _close(tx, jx)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    x1 = _x(13, 2, 1, cfg.d_model)
    jx1, _, jaux1 = jblocks.apply_layer(cfg, spec, jp0, jnp.asarray(x1),
                                        positions=jnp.full((2, 1), S, jnp.int32), mode="decode",
                                        cache=jc, pos=jnp.int32(S), compute_dtype=F32)
    tx1, _, taux1 = tblocks.apply_layer(tcfg, spec, tp0, to_torch(x1), positions=None,
                                        mode="decode", cache=tc, pos=S,
                                        compute_dtype=torch.float32)
    _close(tx1, jx1)
    np.testing.assert_allclose(float(taux1), float(jaux1), rtol=1e-6)


@pytest.mark.parametrize("arch,S", [(MOE_ARCH, 8), (MOE_ARCH, 16), (HYBRID_ARCH, 8),
                                    (HYBRID_ARCH, 16)])
def test_moe_generate_matches_jax(arch, S):
    """Greedy tokens, f32, over the same weights: olmoe (attention + MoE)
    and jamba (attention, Mamba2 and MoE layers in one pattern)."""
    cfg, tcfg, params, tparams, _, _ = _model(arch)
    assert any(s.moe for s in tcfg.pattern)
    prompt = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jgenerate(cfg, None, jlayerwise(cfg, params), prompt, 4)
    got, _ = generate(tcfg, None, layerwise_state(tcfg, tparams), prompt, 4, device="cpu")
    np.testing.assert_array_equal(got, want)

