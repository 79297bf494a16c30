"""Twin of ``tests/test_attention_opts.py`` for the port: the optimization
levers change only how attention is computed, never its values.  Staged
causal / window-aware key slicing (``attn_stages``, in the train path's
query chunks) and the prefill path (the flash-attention kernel's plain
version on the CPU, with its cache) give the unstaged output; heads padded
with zero ``wq`` / ``wo`` columns act as the identity.  Each case is also
held to the JAX package's ``attn_full`` on the same weights (its
``lm.init_params`` carried over by ``interop.params_from_jax``) and inputs
(numpy, seeded).

Tolerances: rtol / atol 1e-5, the reference test's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_twins import CPU, jax_params

from repro.configs import get_config as j_get_config
from repro.models.attention import attn_full as j_attn_full
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models.attention import attn_full

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = torch.float32


def _close(got, want):
    """``got`` (a port tensor) within TOL of ``want`` (a port tensor or a
    JAX array)."""
    if isinstance(want, torch.Tensor):
        want = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _layer_attn(cfg, pidx, key=0):
    """Layer ``pidx``'s first rep of attention weights, as numpy arrays."""
    np_params = jax_params(cfg, key)
    return {k: a[0] for k, a in np_params["pattern"][pidx]["attn"].items()}


def _x(seed, B, S, d):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return x, pos


@pytest.mark.parametrize("arch,pidx", [("starcoder2-7b", 0), ("gemma3-27b", 0), ("gemma3-27b", 5)])
@pytest.mark.parametrize("stages", [2, 4, 8])
def test_staged_attention_invariant(arch, pidx, stages):
    cfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    spec = tcfg.pattern[pidx]
    p0 = _layer_attn(cfg, pidx)
    tp0 = params_from_jax(p0, CPU)
    x, pos = _x(1, 2, 64, cfg.d_model)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    y1, _ = attn_full(tcfg, spec, tp0, tx, tpos, F32, q_chunk=8, attn_stages=1)
    y_staged, _ = attn_full(tcfg, spec, tp0, tx, tpos, F32, q_chunk=8, attn_stages=stages)
    ys, cs = attn_full(tcfg, spec, tp0, tx, tpos, F32, q_chunk=8, attn_stages=stages,
                       return_cache=True)
    _close(y_staged, y1)
    _close(ys, y1)
    assert cs["k"].shape[2] == min(spec.window or 64, 64)

    jp0 = jax.tree.map(jnp.asarray, p0)
    jy1, _ = j_attn_full(cfg, cfg.pattern[pidx], jp0, jnp.asarray(x), jnp.asarray(pos),
                         jnp.float32, q_chunk=8, attn_stages=1)
    jys, jcs = j_attn_full(cfg, cfg.pattern[pidx], jp0, jnp.asarray(x), jnp.asarray(pos),
                           jnp.float32, q_chunk=8, attn_stages=stages, return_cache=True)
    _close(y1, jy1)
    _close(ys, jys)
    for key in ("k", "v"):
        _close(cs[key], jcs[key])


def test_padded_heads_zero_weights_are_identity():
    """Extending n_heads with zero wq / wo columns does not change outputs,
    in the train path and in the prefill path."""
    cfg = dataclasses.replace(j_get_config("starcoder2-7b").reduced(), n_kv_heads=1)
    tcfg = dataclasses.replace(get_config("starcoder2-7b").reduced(), n_kv_heads=1)
    p0 = _layer_attn(cfg, 0)
    spec = tcfg.pattern[0]
    x, pos = _x(1, 1, 16, cfg.d_model)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    y_base, _ = attn_full(tcfg, spec, params_from_jax(p0, CPU), tx, tpos, F32)

    tcfg_pad = dataclasses.replace(tcfg, n_heads=8, head_dim=tcfg.hd)
    extra = (tcfg_pad.n_heads - tcfg.n_heads) * tcfg.hd
    p_pad = dict(p0)
    p_pad["wq"] = np.concatenate([p0["wq"], np.zeros((cfg.d_model, extra), np.float32)], axis=1)
    p_pad["wo"] = np.concatenate([p0["wo"], np.zeros((extra, cfg.d_model), np.float32)], axis=0)
    tp_pad = params_from_jax(p_pad, CPU)
    y_pad, _ = attn_full(tcfg_pad, spec, tp_pad, tx, tpos, F32)
    y_pad_prefill, _ = attn_full(tcfg_pad, spec, tp_pad, tx, tpos, F32, return_cache=True)
    _close(y_pad, y_base)
    _close(y_pad_prefill, y_base)

    cfg_pad = dataclasses.replace(cfg, n_heads=8, head_dim=cfg.hd)
    jy_base, _ = j_attn_full(cfg, cfg.pattern[0], jax.tree.map(jnp.asarray, p0),
                             jnp.asarray(x), jnp.asarray(pos), jnp.float32)
    jy_pad, _ = j_attn_full(cfg_pad, cfg.pattern[0], jax.tree.map(jnp.asarray, p_pad),
                            jnp.asarray(x), jnp.asarray(pos), jnp.float32)
    _close(y_base, jy_base)
    _close(y_pad, jy_pad)
