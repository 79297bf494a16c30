"""Head dims above 128 in the attention kernels K2 (``flash_attention``)
and K3 (``decode_attention``).

The kernels are compiled for hd 64, 128, 192 and 256; the wrappers zero-pad
any other head dim up to the next of them and refuse one above 256.  On the
CPU the plain versions at hd 136, 168 (gemma3-27b's 5376 / 32) and 256 are
held against the JAX package's Pallas kernels in interpret mode, at the f32
tolerance of ``tests/test_kernels.py`` (2e-5); the pad target is a pure
function, checked for every head dim.  The ``gpu`` cases hold the CUDA
kernels against their plain versions at hd 168 and 256 on the card.
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

WIDE = [136, 168, 256]


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


def test_pad_target_for_every_head_dim():
    """Every hd in 1..256 runs at the least compiled head dim not below it;
    0 and anything above 256 are refused with the limit named."""
    assert native.ATTENTION_HEAD_DIMS == (64, 128, 192, 256)
    for hd in range(1, 257):
        want = 64 if hd <= 64 else 128 if hd <= 128 else 192 if hd <= 192 else 256
        assert native.padded_head_dim("k", hd) == want, hd
    for hd in (0, -1, 257, 320, 512):
        with pytest.raises(ValueError, match="1..256"):
            native.padded_head_dim("k", hd)


def test_every_config_head_dim_is_served():
    """No configuration of the port with attention heads has a head dim
    the kernels refuse; gemma3-27b's 168 is the widest."""
    from repro_torch.configs import ARCHS

    hds = {a: get_config(a).hd for a in ARCHS if get_config(a).n_heads}
    assert hds["gemma3-27b"] == 168 == max(hds.values())
    for arch, hd in hds.items():
        assert native.padded_head_dim(arch, hd) >= hd


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
def test_wider_than_256_is_refused_on_gpu(cuda):
    q = torch.zeros(1, 2, 8, 264, device=cuda)
    with pytest.raises(ValueError, match="1..256"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="1..256"):
        decode_attention(q[:, :, 0], q, q, 7)
