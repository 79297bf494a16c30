"""The port's frontends (``repro_torch.models.frontends``), M-RoPE and the
stacked forward's audio and vision inputs against ``repro.models``, on the
CPU.

Weights come from the JAX package's initializer and cross with
``interop.train_state_from_jax``; tokens, patch and frame embeddings are
made with numpy from a seed, so both packages see the same values.
Tolerances: M-RoPE f32 2e-6; logits and caches rtol/atol 2e-5; loss rtol
1e-4 and every gradient leaf rtol 1e-4, atol 1e-6 (those of
``tests/test_torch_train.py``).  qwen2-vl-7b (reduced) takes patches
overlaid on the sequence front with M-RoPE positions; musicgen-large
(reduced) takes frame embeddings in place of the token embedding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve.instance import generate as jgenerate
from repro.serve.instance import layerwise_state as jlayerwise
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.core.treeutil import flatten_state
from repro_torch.interop import train_state_from_jax
from repro_torch.models import frontends, layers, lm
from repro_torch.serve.engine import generate, layerwise_state
from repro_torch.train import steps

VL, AUDIO = "qwen2-vl-7b", "musicgen-large"
CPU = "cpu"
ROPE_TOL = dict(rtol=2e-6, atol=2e-6)
LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
F32 = dict(compute_dtype=jnp.float32)


def _model(arch, seed=3):
    cfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jlm.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    np_opt = jax.tree.map(np.asarray, joptim.adamw_init(jparams))
    tparams, _ = train_state_from_jax(np_params, np_opt, CPU)
    return cfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def by_arch():
    return {VL: _model(VL), AUDIO: _model(AUDIO)}


def _inputs(cfg, batch=2, seq=16, seed=0):
    """A numpy batch: qwen2-vl's tokens, patches over its first
    ``frontend_tokens`` positions and their (3, B, S) M-RoPE positions
    (a 2 x 2 grid); musicgen's frame embeddings.  Targets for the loss."""
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.frontend == "audio":
        out["frame_embeds"] = rng.standard_normal((batch, seq, cfg.d_model), np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model), np.float32)
        out["positions"] = jfrontends.mrope_positions(batch, seq, cfg.frontend_tokens, grid=2)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _close_trees(got, want, **tol):
    g = {n: a.detach().numpy() for n, a in flatten_state(got)[0]}
    w = {n: np.asarray(a) for n, a in flatten_state(jax.tree.map(np.asarray, want))[0]}
    assert sorted(g) == sorted(w) and g
    for name in w:
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **tol)


# ---------------------------------------------------------- the frontends
@pytest.mark.parametrize("batch,seq,n_patches,grid", [
    (2, 32, 4, 2),      # the smoke tests' reduced qwen2-vl
    (2, 288, 256, 16),  # the card's qwen2-vl phase: a 16 x 16 grid, 32 text tokens
    (1, 8, 16, 4),      # more patches than positions
    (3, 10, 0, 16),     # text only
])
def test_mrope_positions_match_reference(batch, seq, n_patches, grid):
    got = frontends.mrope_positions(batch, seq, n_patches, grid)
    want = jfrontends.mrope_positions(batch, seq, n_patches, grid)
    assert got.dtype == want.dtype and got.shape == (3, batch, seq)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_patches", [1, 4, 8])
def test_overlay_patches_matches_reference(n_patches):
    rng = np.random.default_rng(n_patches)
    x = rng.standard_normal((2, 8, 16), np.float32)
    p = rng.standard_normal((2, n_patches, 16), np.float32)
    got = frontends.overlay_patches(torch.from_numpy(x), torch.from_numpy(p))
    want = jfrontends.overlay_patches(jnp.asarray(x), jnp.asarray(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_embeds_are_seeded_and_scaled():
    for make, n in ((frontends.make_patch_embeds, 256), (frontends.make_frame_embeds, 16)):
        a = make(torch.Generator().manual_seed(5), 2, n, 64, device=CPU)
        b = make(torch.Generator().manual_seed(5), 2, n, 64, device=CPU)
        c = make(torch.Generator().manual_seed(6), 2, n, 64, dtype=torch.float32, device=CPU)
        assert a.shape == (2, n, 64) and a.dtype == torch.bfloat16 and c.dtype == torch.float32
        assert torch.equal(a, b) and not torch.equal(a.float(), c)
        assert abs(c.std().item() - 0.02) < 0.002


# --------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("streams", ["thw", "text"])
def test_apply_mrope_matches_reference(hd, streams):
    """(3, B, S) positions pick one stream per frequency (t for the first
    half of the rotary half-dim, then h, then w); (B, S) positions drive
    all three, which is plain RoPE."""
    B, S, H = 2, 300, 3
    x = np.random.default_rng(hd).standard_normal((B, S, H, hd), np.float32)
    if streams == "thw":
        pos = frontends.mrope_positions(B, S, 256, grid=16)
    else:
        pos = np.broadcast_to(np.arange(5, 5 + S, dtype=np.int32), (B, S)).copy()
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, mrope=True)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, mrope=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)
    if streams == "text":
        plain = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
        assert torch.equal(got, plain)


# --------------------------------------------------------- train forward
@pytest.mark.parametrize("arch", [VL, AUDIO])
def test_forward_train_logits_aux_and_grads_match_reference(arch, by_arch):
    cfg, tcfg, jparams, tparams = by_arch[arch]
    b = _inputs(cfg)
    want, _, jaux = jlm.forward(cfg, jparams, _jb(b), mode="train", remat="dots", **F32)
    got, aux = lm.forward(tcfg, tparams, _tb(b), compute_dtype=torch.float32, remat="dots")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOGITS_TOL)
    assert float(aux) == float(jaux) == 0.0

    tc = dict(remat="dots", compute_dtype="float32")
    jloss = jsteps.make_loss_fn(cfg, jsteps.TrainStepConfig(**tc))
    (jtotal, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams, _jb(b))
    tloss = steps.make_loss_fn(tcfg, steps.TrainStepConfig(**tc))
    (total, m), g = steps._value_and_grad(tloss, tparams, _tb(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    _close_trees(g, jg, **GRAD_TOL)
    if arch == AUDIO:  # frames replace the token embedding: no gradient reaches it
        assert not g["embed"]["tok"].any()
    else:  # the patches' positions get the gradient of their token rows too
        assert g["embed"]["tok"].any()


# ------------------------------------------------------- prefill / decode
def _decode_inputs(cfg, logits, step):
    """The next step's input: the greedy token, or a seeded (B, 1, d) frame."""
    if cfg.frontend == "audio":
        rng = np.random.default_rng(100 + step)
        return {"frame_embeds": rng.standard_normal((logits.shape[0], 1, cfg.d_model),
                                                    np.float32)}
    return {"tokens": np.argmax(np.asarray(logits)[:, -1], axis=-1).astype(np.int32)[:, None]}


@pytest.mark.parametrize("arch", [VL, AUDIO])
def test_prefill_and_decode_steps_match_reference(arch, by_arch):
    cfg, tcfg, jparams, tparams = by_arch[arch]
    b = _inputs(cfg, seq=8)
    del b["targets"]
    want, jc, _ = jlm.prefill(cfg, jparams, _jb(b), **F32)
    got, tc, _ = lm.prefill(tcfg, tparams, _tb(b), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _close_trees(tc, jc, **LOGITS_TOL)
    for step, pos in enumerate((8, 9, 10)):
        d = _decode_inputs(cfg, want, step)
        want, jc, _ = jlm.decode_step(cfg, jparams, _jb(d), jc, jnp.int32(pos), **F32)
        got, tc, _ = lm.decode_step(tcfg, tparams, _tb(d), tc, pos,
                                    compute_dtype=torch.float32)
        assert got.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
        _close_trees(tc, jc, **LOGITS_TOL)


@pytest.mark.parametrize("S", [4, 8])
def test_vl_generate_text_only_matches_reference(S, by_arch):
    """Serving's ``generate`` takes text tokens: M-RoPE over (B, S)
    positions, greedy tokens equal to the JAX package's."""
    cfg, tcfg, jparams, tparams = by_arch[VL]
    prompt = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = jgenerate(cfg, None, jlayerwise(cfg, jparams), prompt, 4)
    got, _ = generate(tcfg, None, layerwise_state(tcfg, tparams), prompt, 4, device=CPU)
    np.testing.assert_array_equal(got, want)
