"""Head dims above 128 in the attention kernels K2 (``flash_attention``)
and K3 (``decode_attention``).

The kernels are compiled for hd 64, 128, 192 and 256; the wrappers zero-pad
any other head dim up to the next of them, and run one above 256 on a
generic instance that refuses only a head dim whose accumulator passes a
block's shared memory.  On the CPU the plain versions at hd 136, 168
(gemma3-27b's 5376 / 32), 256 and 320 are held against the JAX package's
Pallas kernels in interpret mode, at the f32 tolerance of
``tests/test_kernels.py`` (2e-5), and so are both at the query groups of
the configurations' own heads at hd 128 (qwen3-32b's 64 / 8, G 8;
starcoder2-7b's 36 / 4, G 9, which K3 runs on its 16-head instance); the
head dim each kernel runs at is a pure function, checked for every head dim
up to 256 and past it.  The ``gpu`` cases hold the CUDA kernels against
their plain versions at hd 168 and 256, at those two configurations' heads
(f32 and bf16, and K3 over an int8 cache), and the generic instances at hd
257, 320 and 512, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.attention import quantize_kv as j_quantize_kv
from repro_torch.configs import get_config
from repro_torch.interop import to_torch
from repro_torch.kernels import native
from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

WIDE = [136, 168, 256, 320]
# (H, kvH, hd) of qwen3-32b (G 8) and starcoder2-7b (G 9)
MODEL_HEADS = {"qwen3-32b": (64, 8, 128), "starcoder2-7b": (36, 4, 128)}


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("hd", WIDE)
@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_wide_matches_pallas(hd, window):
    B, H, kvH, S = 1, 4, 2, 64
    q, k, v = _rand(hd, (B, H, S, hd), (B, kvH, S, hd), (B, kvH, S, hd))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                   block_q=32, block_k=32, interpret=True)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", WIDE)
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_decode_attention_wide_matches_pallas(hd, kv):
    B, H, kvH, Sc, pos = 2, 8, 2, 48, 40
    q, k, v = _rand(hd + 1, (B, H, hd), (B, kvH, Sc, hd), (B, kvH, Sc, hd))
    ks = vs = None
    k, v = jnp.asarray(k), jnp.asarray(v)
    tol = 2e-5
    if kv == "int8":
        (k, ks), (v, vs) = j_quantize_kv(k), j_quantize_kv(v)
        tol = 2e-4
    want = j_decode(jnp.asarray(q), k, v, jnp.int32(pos), ks, vs, block_k=16, interpret=True)
    t = (lambda a: None if a is None else to_torch(np.asarray(a)))
    got = decode_attention(to_torch(q), t(k), t(v), pos, t(ks), t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", sorted(MODEL_HEADS))
def test_model_groups_match_pallas(arch):
    """K2 (causal) and K3 (over f32 and int8 caches) at the configuration's
    own heads, against the JAX package's Pallas kernels in interpret mode."""
    H, kvH, hd = MODEL_HEADS[arch]
    assert (get_config(arch).n_heads, get_config(arch).n_kv_heads, get_config(arch).hd) == (
        H, kvH, hd)
    B, S = 1, 32
    q, k, v = _rand(H, (B, H, S, hd), (B, kvH, S, hd), (B, kvH, S, hd))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_k=32,
                   interpret=True)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    q1 = np.ascontiguousarray(q[:, :, -1])
    for kv, tol in (("float32", 2e-5), ("int8", 2e-4)):
        kk, vv, ks, vs = jnp.asarray(k), jnp.asarray(v), None, None
        if kv == "int8":
            (kk, ks), (vv, vs) = j_quantize_kv(kk), j_quantize_kv(vv)
        want = j_decode(jnp.asarray(q1), kk, vv, jnp.int32(S - 3), ks, vs, block_k=16,
                        interpret=True)
        t = (lambda a: None if a is None else to_torch(np.asarray(a)))
        got = decode_attention(to_torch(q1), t(kk), t(vv), S - 3, t(ks), t(vs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_pad_target_for_every_head_dim():
    """Every hd in 1..256 runs at the least compiled head dim not below it;
    above 256 each kernel runs hd itself on its generic instance, up to the
    widest whose shared memory fits one block (K2 2828, K3 29023); past
    that, and at 0 or below, the wrapper refuses with the limit named."""
    assert native.ATTENTION_HEAD_DIMS == (64, 128, 192, 256)
    for what, widest in (("flash_attention", 2828), ("decode_attention", 29023)):
        for hd in range(1, 257):
            want = 64 if hd <= 64 else 128 if hd <= 128 else 192 if hd <= 192 else 256
            assert native.padded_head_dim(what, hd) == want, (what, hd)
        for hd in (257, 320, 512, widest):
            assert native.padded_head_dim(what, hd) == hd, (what, hd)
        assert native.GENERIC_SMEM_BYTES[what](widest) <= native.SMEM_MAX
        with pytest.raises(ValueError, match="227 KB"):
            native.padded_head_dim(what, widest + 1)
        for hd in (0, -1):
            with pytest.raises(ValueError, match="not positive"):
                native.padded_head_dim(what, hd)


def test_every_config_head_dim_is_served():
    """No configuration of the port with attention heads has a head dim
    above the compiled ones; gemma3-27b's 168 is the widest."""
    from repro_torch.configs import ARCHS

    hds = {a: get_config(a).hd for a in ARCHS if get_config(a).n_heads}
    assert hds["gemma3-27b"] == 168 == max(hds.values())
    for arch, hd in hds.items():
        assert native.padded_head_dim("flash_attention", hd) >= hd
        assert native.padded_head_dim("decode_attention", hd) <= 256


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [168, 256])
@pytest.mark.parametrize("dtype,window", [(torch.float32, None), (torch.float32, 100),
                                          (torch.bfloat16, None)])
def test_flash_attention_wide_on_gpu(cuda, hd, dtype, window):
    B, H, kvH, S = 1, 32, 16, 300
    q, k, v = (to_torch(a).to(cuda, dtype) for a in
               _rand(hd, (B, H, S, hd), (B, kvH, S, hd), (B, kvH, S, hd)))
    got = flash_attention(q, k, v, window=window)
    want = flash_attention_plain(q, k, v, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,H,kvH", [(168, 32, 16), (256, 16, 1), (256, 12, 1)])
@pytest.mark.parametrize("q_dtype,kv", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                        ("float32", "int8")])
def test_decode_attention_wide_on_gpu(cuda, hd, H, kvH, q_dtype, kv):
    from repro_torch.models.attention import quantize_kv

    B, Sc, pos = 1, 4096, 4000
    q, k, v = (to_torch(a).to(cuda) for a in
               _rand(hd + H, (B, H, hd), (B, kvH, Sc, hd), (B, kvH, Sc, hd)))
    q = q.to(getattr(torch, q_dtype))
    ks = vs = None
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
    got = decode_attention(q, k, v, pos, ks, vs)
    want = decode_attention_plain(q, k, v, pos, ks, vs)
    tol = 2e-2 if kv == "bfloat16" else 2e-4 if kv == "int8" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [257, 320, 512])
def test_generic_head_dim_on_gpu(cuda, hd):
    """Past 256 nothing is refused any more: K2 and K3 run their generic
    instances, held to the plain versions within ``tests/test_kernels.py``'s
    tolerances (f32 and bf16 K2 with a window and ragged S, K3 over f32,
    bf16 and int8 caches with GQA)."""
    from repro_torch.models.attention import quantize_kv

    B, H, kvH, S = 1, 4, 2, 77
    for dtype, window in ((torch.float32, None), (torch.float32, 40), (torch.bfloat16, None)):
        q, k, v = (to_torch(a).to(cuda, dtype) for a in
                   _rand(hd, (B, H, S, hd), (B, kvH, S, hd), (B, kvH, S, hd)))
        got = flash_attention(q, k, v, window=window)
        want = flash_attention_plain(q, k, v, window=window)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    Sc, pos = 300, 250
    q, k, v = (to_torch(a).to(cuda) for a in
               _rand(hd + 1, (B, 2 * H, hd), (B, kvH, Sc, hd), (B, kvH, Sc, hd)))
    for q_dtype, kv in (("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "int8")):
        qq = q.to(getattr(torch, q_dtype))
        ks = vs = None
        if kv == "int8":
            (kk, ks), (vv, vs) = quantize_kv(k), quantize_kv(v)
        else:
            kk, vv = k.to(getattr(torch, kv)), v.to(getattr(torch, kv))
        got = decode_attention(qq, kk, vv, pos, ks, vs)
        want = decode_attention_plain(qq, kk, vv, pos, ks, vs)
        tol = 2e-2 if kv == "bfloat16" else 2e-4 if kv == "int8" else 2e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(MODEL_HEADS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_groups_on_gpu(cuda, arch, dtype):
    """K2 and K3 at qwen3-32b's G 8 and starcoder2-7b's G 9: K2 over strided
    (B, S, H, hd) projections as ``attn_full`` passes them, at the serving
    path's prompt and a long one; K3 over a cache of the path's 16 slots and
    a long one, and in f32 over an int8 cache as well."""
    from repro_torch.models.attention import quantize_kv

    H, kvH, hd = MODEL_HEADS[arch]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    B = 2
    for S in (16, 300):
        q, k, v = (to_torch(a).to(cuda, dtype).transpose(1, 2) for a in
                   _rand(S + H, (B, S, H, hd), (B, S, kvH, hd), (B, S, kvH, hd)))
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    kvs = [dtype] + (["int8"] if dtype == torch.float32 else [])
    for Sc, pos in ((16, 19), (4096, 4000)):
        q, k, v = (to_torch(a).to(cuda) for a in
                   _rand(Sc + H, (B, H, hd), (B, kvH, Sc, hd), (B, kvH, Sc, hd)))
        for kv in kvs:
            ks = vs = None
            if kv == "int8":
                (kk, ks), (vv, vs) = quantize_kv(k), quantize_kv(v)
            else:
                kk, vv = k.to(kv), v.to(kv)
            got = decode_attention(q.to(dtype), kk, vv, pos, ks, vs)
            want = decode_attention_plain(q.to(dtype), kk, vv, pos, ks, vs)
            t = 2e-4 if kv == "int8" else tol
            torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
