"""Twin of ``tests/test_smoke_archs.py`` for the port, case for case over
every architecture of ``ARCHS``: a reduced config of each family, the train
forward, a train step's loss and gradients, prefill then one decode step,
incremental decode against the full forward (attention and SSD), and the
param counts.  Each case is held to the JAX package's values, not only to
shapes and NaNs: both packages run the same weights (the JAX package's
``lm.init_params``, carried over by ``interop.params_from_jax``) on the
same inputs (numpy, seeded), in f32.

Then shape-faithful variants that the reduced configs (4 heads, at most 2
KV heads, H * hd == d_model, qk-norm weights of 1) cannot show, each under
a name of its own in both packages (the JAX package's serving path caches
its jitted functions by ``cfg.name``): qwen3-32b at G 8 with H * hd !=
d_model and its ``q_norm`` / ``k_norm`` drawn off 1, starcoder2-7b at G 9,
phi3.5-moe-42b at G 4.  Their greedy tokens over 4 new tokens equal the JAX
package's, and their forward logits agree within 1e-5.

Tolerances: logits rtol / atol 2e-5 (``LOGITS_TOL`` of
``tests/test_torch_train.py``); every cache leaf rtol 2e-5 with an atol of
2e-5 of that leaf's largest magnitude; the loss rtol 1e-4; every gradient
leaf rtol 1e-4 with an atol of 1e-5 of that leaf's largest magnitude (a
leaf's f32 noise scales with it); the MoE aux loss rtol 1e-6;
incremental decode against the full forward at the reference's own bounds
(2e-4 attention, 5e-4 SSD).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_twins import CPU, jax_params, jax_tokens

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import frontends as jfrontends
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.treeutil import flatten_state
from repro_torch.interop import params_from_jax
from repro_torch.models import lm
from repro_torch.serve.engine import generate, layerwise_state
from repro_torch.train import steps

B, S = 2, 32
F32 = jnp.float32
LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
# (rtol, atol as a share of the leaf's largest magnitude) for the trees: a
# leaf's f32 noise scales with it (reduced jamba's embedding gradient
# reaches 5.9 and its elements move by up to 2.8e-5 between the packages;
# its conv cache reaches 2 and moves by 2.4e-5)
GRAD_TREE_TOL = (1e-4, 1e-5)
CACHE_TREE_TOL = (2e-5, 2e-5)
FAITHFUL_TOL = dict(rtol=1e-5, atol=1e-5)
QK_NORM_SPREAD = 0.1  # q_norm / k_norm drawn as 1 + N(0, this)


def _inputs(cfg, seed, seq=S, decode=False):
    """A numpy batch: frame embeddings for the audio frontend, else tokens;
    the vision frontend's prefill also takes patch embeddings over its
    first ``frontend_tokens`` positions and M-RoPE positions (a 2 x 2
    grid), as the reference's smoke tests make them."""
    rng = np.random.default_rng(seed)
    s = 1 if decode else seq
    if cfg.frontend == "audio":
        return {"frame_embeds": (0.02 * rng.standard_normal((B, s, cfg.d_model))).astype(
            np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.frontend == "vision" and not decode:
        out["patch_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
        out["positions"] = jfrontends.mrope_positions(B, s, cfg.frontend_tokens, grid=2)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _named(tree):
    return {n: a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for n, a in flatten_state(tree)[0]}


def _close_trees(got, want, tol):
    """Leaf by leaf, by name: ``tol`` = (rtol, atol as a share of the
    leaf's largest magnitude)."""
    g, w = _named(got), _named(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w) and g
    rtol, share = tol
    for name in w:
        atol = share * max(float(np.abs(w[name]).max(initial=0.0)), 1e-30)
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol, err_msg=name)


def _layout(tree):
    """Every leaf's name, shape and dtype."""
    return [(n, tuple(a.shape), a.dtype) for n, a in flatten_state(tree)[0]]


def _model(arch, key=0):
    cfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    np_params = jax_params(cfg, key)
    return cfg, tcfg, jax.tree.map(jnp.asarray, np_params), params_from_jax(np_params, CPU)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch_setup(request):
    return _model(request.param)


def test_train_forward(arch_setup):
    cfg, tcfg, jparams, tparams = arch_setup
    b = _inputs(cfg, 1)
    want, jcaches, jaux = jlm.forward(cfg, jparams, _jb(b), mode="train", compute_dtype=F32)
    got, aux = lm.forward(tcfg, tparams, _tb(b), compute_dtype=torch.float32)
    assert got.shape == (B, S, tcfg.vocab_size) and jcaches is None
    assert torch.isfinite(got).all() and np.isfinite(float(aux))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOGITS_TOL)
    if any(s.moe for s in tcfg.pattern + tcfg.remainder):
        assert float(jaux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    else:
        assert float(aux) == float(jaux) == 0.0


def test_train_step_no_nan(arch_setup):
    """The reference's loss (cross-entropy plus 0.01 of the aux loss) under
    ``remat="dots"``: the loss and every gradient leaf against
    ``jax.value_and_grad``."""
    cfg, tcfg, jparams, tparams = arch_setup
    b = _inputs(cfg, 2)
    targets = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    def jloss(p):
        logits, _, aux = jlm.forward(cfg, p, _jb(b), mode="train", remat="dots",
                                     compute_dtype=F32)
        lse = jax.nn.logsumexp(logits, axis=-1)
        tgt = jnp.take_along_axis(logits, jnp.asarray(targets)[..., None], axis=-1)[..., 0]
        return jnp.mean(lse - tgt) + 0.01 * aux

    def tloss(p, batch):
        logits, aux = lm.forward(tcfg, p, batch, compute_dtype=torch.float32, remat="dots")
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, torch.from_numpy(targets).long()[..., None])[..., 0]
        return (lse - tgt).mean() + 0.01 * aux, {}

    jl, jg = jax.value_and_grad(jloss)(jparams)
    (loss, _), g = steps._value_and_grad(tloss, tparams, _tb(b))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    assert all(np.isfinite(a).all() for a in _named(g).values())
    _close_trees(g, jg, GRAD_TREE_TOL)


def test_prefill_then_decode(arch_setup):
    """Prefill's last logits and caches, then one decode step's logits and
    caches; the caches keep their layout across the step."""
    cfg, tcfg, jparams, tparams = arch_setup
    b = _inputs(cfg, 4)
    want, jc, _ = jlm.prefill(cfg, jparams, _jb(b), compute_dtype=F32)
    got, tc, _ = lm.prefill(tcfg, tparams, _tb(b), compute_dtype=torch.float32)
    assert got.shape == (B, 1, tcfg.vocab_size) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _close_trees(tc, jc, CACHE_TREE_TOL)
    layout = _layout(tc)  # decode writes the caches in place
    dec = _inputs(cfg, 5, decode=True)
    want2, jc2, _ = jlm.decode_step(cfg, jparams, _jb(dec), jc, jnp.int32(S), compute_dtype=F32)
    got2, tc2, _ = lm.decode_step(tcfg, tparams, _tb(dec), tc, S, compute_dtype=torch.float32)
    assert got2.shape == (B, 1, tcfg.vocab_size) and torch.isfinite(got2).all()
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **LOGITS_TOL)
    assert _layout(tc2) == layout
    _close_trees(tc2, jc2, CACHE_TREE_TOL)


def _decode_against_forward(arch, tol):
    """Teacher-forced decode from an empty cache, token by token, against
    the port's full forward (the reference's own bound ``tol``) and against
    the JAX package's decode of the same tokens."""
    cfg, tcfg, jparams, tparams = _model(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    full, _ = lm.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                         compute_dtype=torch.float32)
    caches = lm.init_cache(tcfg, 1, 8, kv_dtype=torch.float32, compute_dtype=torch.float32,
                           device=CPU)
    jcaches = jlm.init_cache(cfg, 1, 8, kv_dtype=F32, compute_dtype=F32)
    outs, jouts = [], []
    for t in range(8):
        logits, caches, _ = lm.decode_step(tcfg, tparams, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, caches, t, compute_dtype=torch.float32)
        jlogits, jcaches, _ = jlm.decode_step(cfg, jparams, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, jcaches, jnp.int32(t), compute_dtype=F32)
        outs.append(logits[:, 0])
        jouts.append(np.asarray(jlogits[:, 0]))
    dec = torch.stack(outs, dim=1).numpy()
    np.testing.assert_allclose(dec, full.detach().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(dec, np.stack(jouts, axis=1), **LOGITS_TOL)


def test_decode_matches_full_forward():
    """Incremental decode agrees with the teacher-forced full forward."""
    _decode_against_forward("qwen1.5-0.5b", 2e-4)


def test_decode_matches_full_forward_ssm():
    """The same for the attention-free SSD architecture (its state
    recurrence against the chunked scan)."""
    _decode_against_forward("mamba2-780m", 5e-4)


def _specs(module, cfg):
    return [(n, tuple(s.shape)) for n, s in flatten_state(module.param_specs(cfg))[0]]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_sane(arch):
    """The counts equal the reference's, and the full-size parameter trees
    (by their specs, nothing allocated) hold the same leaves and shapes."""
    cfg, tcfg = J_ARCHS[arch], ARCHS[arch]
    n, na = tcfg.param_count(), tcfg.active_param_count()
    assert (n, na) == (cfg.param_count(), cfg.active_param_count())
    assert na <= n
    assert n > 1e8, f"{arch}: {n}"
    assert _specs(lm, tcfg) == _specs(jlm, cfg)


# --------------------------------------------------- shape-faithful cases
# the widths that the reduced configs cannot show, on a narrow model
FAITHFUL = {
    "qwen3-32b": dict(d_model=64, n_heads=8, n_kv_heads=1, head_dim=16),  # G 8, H * hd 128
    "starcoder2-7b": dict(d_model=72, n_heads=9, n_kv_heads=1, head_dim=16),  # G 9, 144
    "phi3.5-moe-42b-a6.6b": dict(n_heads=8, n_kv_heads=2),  # G 4, 128 on d_model 64
}


@functools.lru_cache(maxsize=None)
def _faithful(arch):
    """The variant in both packages under the name ``<arch>-faithful``, the
    JAX package's weights (qk-norm weights drawn off 1 from a seed) as
    numpy arrays and as the port's params."""
    kw = FAITHFUL[arch]
    cfg, tcfg = (dataclasses.replace(c.reduced(), name=f"{arch}-faithful", **kw)
                 for c in (j_get_config(arch), get_config(arch)))
    np_params = jax_params(cfg, 1)
    if cfg.qk_norm:
        rng = np.random.default_rng(7)
        for layer in np_params["pattern"]:
            for key in ("q_norm", "k_norm"):
                shape = layer["attn"][key].shape
                layer["attn"][key] = (1.0 + QK_NORM_SPREAD * rng.standard_normal(shape)).astype(
                    np.float32)
    return cfg, tcfg, np_params, params_from_jax(np_params, CPU)


@pytest.mark.parametrize("arch", sorted(FAITHFUL))
def test_shape_faithful_generate_matches_reference(arch):
    cfg, tcfg, np_params, tparams = _faithful(arch)
    G = tcfg.n_heads // tcfg.n_kv_heads
    assert G == {"qwen3-32b": 8, "starcoder2-7b": 9, "phi3.5-moe-42b-a6.6b": 4}[arch]
    assert tcfg.n_heads * tcfg.hd != tcfg.d_model
    if tcfg.qk_norm:
        assert all(np.abs(layer["attn"]["q_norm"] - 1).max() > 0.05
                   for layer in np_params["pattern"])
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = jax_tokens(cfg, np_params, prompt, 4)
    got, _ = generate(tcfg, None, layerwise_state(tcfg, tparams), prompt, 4, device=CPU)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", sorted(FAITHFUL))
def test_shape_faithful_forward_matches_reference(arch):
    cfg, tcfg, np_params, tparams = _faithful(arch)
    b = _inputs(cfg, 12, seq=16)
    want, _, _ = jlm.forward(cfg, jax.tree.map(jnp.asarray, np_params), _jb(b), mode="train",
                             compute_dtype=F32)
    got, _ = lm.forward(tcfg, tparams, _tb(b), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FAITHFUL_TOL)
