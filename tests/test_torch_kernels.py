"""The port's kernels against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; the same numpy
inputs (made from a seed) go through the Pallas kernel in interpret mode
(or its ``ref.py`` where noted) and through the port.  Tolerances are those
of ``tests/test_kernels.py``: overlay patching is bit-exact, attention is
within 2e-5 in f32 and 2e-2 in bf16, int8 decode within 2e-4.  The tests
marked ``gpu`` hold each CUDA kernel against its plain version on the card.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import overlay as joverlay
from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.overlay_patch.ops import compact_plan_from_itable as j_compact
from repro.kernels.overlay_patch.ops import overlay_patch as j_overlay
from repro.kernels.overlay_patch.ref import overlay_patch_ref
from repro.models.attention import quantize_kv as j_quantize_kv
from repro_torch.interop import to_torch
from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.kernels.overlay_patch.ops import (
    compact_plan_from_itable,
    overlay_patch,
    overlay_patch_plain,
    plan_from_itable,
)

_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16, "int8": np.int8}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _t(a):
    return to_torch(np.asarray(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(x):
    a = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    return a.numpy()


# ---------------------------------------------------------- overlay_patch
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_pages,page", [(4, 128), (16, 256), (33, 512)])
def test_overlay_patch_matches_pallas(dtype, n_pages, page):
    rng = np.random.default_rng(n_pages)
    base = (rng.standard_normal((n_pages, page)) * 10).astype(_NP[dtype])
    kinds = rng.integers(0, 3, n_pages).astype(np.int32)
    n_priv = int((kinds == joverlay.KIND_PRIVATE).sum())
    priv = (rng.standard_normal((max(n_priv, 1), page)) * 10).astype(_NP[dtype])
    src = (np.cumsum(kinds == joverlay.KIND_PRIVATE) - 1).astype(np.int32)
    want = np.asarray(j_overlay(jnp.asarray(base), jnp.asarray(priv),
                                jnp.asarray(kinds), jnp.asarray(src), interpret=True))
    got = overlay_patch(_t(base), _t(priv), _t(kinds), _t(src))
    np.testing.assert_array_equal(_bits(got), _bits(_t(want)))


@pytest.mark.parametrize("kind", [joverlay.KIND_BASE, joverlay.KIND_ZERO])
def test_overlay_patch_no_private_pages(kind):
    """n_priv == 0, both as the reference's (1, page) dummy slot and as an
    empty private array: nothing is gathered out of bounds."""
    n_pages, page = 6, 128
    base = np.random.default_rng(3).standard_normal((n_pages, page)).astype(np.float32)
    kinds = np.full((n_pages,), kind, np.int32)
    src = np.zeros((n_pages,), np.int32)
    dummy = np.zeros((1, page), np.float32)
    want = np.asarray(j_overlay(jnp.asarray(base), jnp.asarray(dummy),
                                jnp.asarray(kinds), jnp.asarray(src), interpret=True))
    for priv in (dummy, np.zeros((0, page), np.float32)):
        got = overlay_patch(_t(base), _t(priv), _t(kinds), _t(src))
        np.testing.assert_array_equal(got.numpy(), want)
    expect = base if kind == joverlay.KIND_BASE else np.zeros_like(base)
    np.testing.assert_array_equal(want, expect)


@pytest.mark.parametrize(
    "kind", [joverlay.KIND_BASE, joverlay.KIND_ZERO, joverlay.KIND_PRIVATE]
)
def test_overlay_patch_single_page(kind):
    page = 256
    base = np.full((1, page), 2.0, np.float32)
    priv = np.full((1, page), 7.0, np.float32)
    kinds = np.asarray([kind], np.int32)
    src = np.zeros((1,), np.int32)
    want = np.asarray(j_overlay(jnp.asarray(base), jnp.asarray(priv),
                                jnp.asarray(kinds), jnp.asarray(src), interpret=True))
    got = overlay_patch(_t(base), _t(priv), _t(kinds), _t(src))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plans_match_reference_on_real_itable(tmp_path):
    """Both plan flavors equal the JAX package's on a real delta itable
    (with a non-page-multiple tail), and the compact plan + patch rebuilds
    the snapshotted bytes exactly."""
    from repro.core import snapshot
    from repro.core.jif import JifReader

    ps = 512
    pe = ps // 4
    rng = np.random.default_rng(11)
    base_st = {
        "w_tail": rng.standard_normal(3 * pe + pe // 2).astype(np.float32),
        "w_even": rng.standard_normal(4 * pe).astype(np.float32),
    }
    ft = {k: v.copy() for k, v in base_st.items()}
    ft["w_tail"][:pe] += 1.0
    ft["w_tail"][-pe // 2:] = 0.0
    ft["w_even"][pe: 2 * pe] += 1.0
    parent, delta = str(tmp_path / "p.jif"), str(tmp_path / "d.jif")
    snapshot(base_st, parent, page_size=ps)
    snapshot(ft, delta, parent=parent, page_size=ps)
    with JifReader(delta) as r:
        for t in r.tensors:
            it = r.itable(t.name)
            kinds, src, runs, n_priv = compact_plan_from_itable(it)
            jk, js, jruns, jn = j_compact(it)
            np.testing.assert_array_equal(kinds, jk)
            np.testing.assert_array_equal(src, js)
            assert runs == jruns and n_priv == jn
            from repro.kernels.overlay_patch.ops import plan_from_itable as j_plan

            for a, b in zip(plan_from_itable(it), j_plan(it)):
                np.testing.assert_array_equal(a, b)
            compact = np.zeros(n_priv * ps, np.uint8)
            for slot, chunk, count in runs:
                raw = r.pread_chunks(chunk, count)
                compact[slot * ps: slot * ps + len(raw)] = np.frombuffer(raw, np.uint8)
            base2d = np.zeros(it.n_pages * ps, np.uint8)
            raw_base = base_st[t.name].view(np.uint8)
            base2d[: raw_base.size] = raw_base
            base2d = base2d.view(np.float32).reshape(it.n_pages, pe)
            priv2d = compact.view(np.float32).reshape(n_priv, pe)
            got = overlay_patch(_t(base2d), _t(priv2d), _t(kinds), _t(src))
            want = overlay_patch_ref(jnp.asarray(base2d), jnp.asarray(priv2d),
                                     jnp.asarray(kinds), jnp.asarray(src))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(
                got.numpy().reshape(-1)[: t.nbytes // 4], ft[t.name]
            )


# --------------------------------------------------------- flash_attention
def _qkv(seed, B, H, kvH, S, hd, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(_NP[dtype])
            for s in ((B, H, S, hd), (B, kvH, S, hd), (B, kvH, S, hd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,kvH,S,hd,window",
    [
        (1, 4, 4, 64, 32, None),
        (2, 4, 2, 64, 16, None),   # GQA
        (1, 4, 2, 64, 16, 16),     # GQA + sliding window
    ],
)
def test_flash_attention_matches_pallas(dtype, B, H, kvH, S, hd, window):
    q, k, v = _qkv(S + H + hd, B, H, kvH, S, hd, dtype)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                   block_q=32, block_k=32, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("S", [5, 12])
@pytest.mark.parametrize("kvH,window", [(4, None), (2, None), (2, 4)])
def test_flash_attention_ragged_prompt(S, kvH, window):
    """Serving prompts do not divide into blocks: the port masks ragged
    tails, so it is held against the dense reference."""
    q, k, v = _qkv(S, 2, 4, kvH, S, 16, "float32")
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    got = flash_attention(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


# -------------------------------------------------------- decode_attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,kvH,Sc,hd,pos",
    [(2, 8, 2, 64, 16, 37), (1, 4, 4, 32, 32, 31), (2, 4, 2, 16, 16, 20)],
)
def test_decode_attention_matches_pallas(dtype, B, H, kvH, Sc, hd, pos):
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((B, H, hd)).astype(np.float32).astype(_NP[dtype])
    k = rng.standard_normal((B, kvH, Sc, hd)).astype(np.float32).astype(_NP[dtype])
    v = rng.standard_normal((B, kvH, Sc, hd)).astype(np.float32).astype(_NP[dtype])
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
                    block_k=16, interpret=True)
    got = decode_attention(_t(q), _t(k), _t(v), pos)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=_TOL[dtype], atol=_TOL[dtype])


def test_decode_attention_int8_kv():
    B, H, kvH, Sc, hd, pos = 2, 8, 2, 64, 16, 40
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, hd), (B, kvH, Sc, hd), (B, kvH, Sc, hd)))
    kq, ks = j_quantize_kv(jnp.asarray(k))
    vq, vs = j_quantize_kv(jnp.asarray(v))
    want = j_decode(jnp.asarray(q), kq, vq, jnp.int32(pos), ks, vs, block_k=16,
                    interpret=True)
    got = decode_attention(_t(q), _t(kq), _t(vq), pos, _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    exact = decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(exact), rtol=0.1, atol=0.05)


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_overlay_patch_kernel_on_gpu(cuda, dtype):
    from repro_torch.kernels.overlay_patch import ops

    g = torch.Generator().manual_seed(0)
    n_pages, elems = 33, (4096 // torch.empty((), dtype=dtype).element_size())
    base = torch.randint(-100, 100, (n_pages, elems), generator=g).to(dtype)
    kinds = torch.randint(0, 3, (n_pages,), generator=g, dtype=torch.int32)
    priv = torch.randint(-100, 100, (7, elems), generator=g).to(dtype)
    src = torch.randint(-1, 9, (n_pages,), generator=g, dtype=torch.int32)
    before = ops.LAUNCHES.count
    got = overlay_patch(*(t.to(cuda) for t in (base, priv, kinds, src)))
    assert ops.LAUNCHES.count == before + 1
    want = overlay_patch_plain(base, priv, kinds, src)
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("S,kvH,window", [(16, 16, None), (5, 16, None), (12, 4, None), (40, 16, 8)])
def test_flash_attention_kernel_on_gpu(cuda, S, kvH, window):
    q, k, v = (_t(a).to(cuda) for a in _qkv(S, 2, 16, kvH, S, 64, "float32"))
    got = flash_attention(q, k, v, window=window)
    want = flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kvH,pos,kv", [(16, 19, "float32"), (4, 9, "float32"), (16, 16, "int8")])
def test_decode_attention_kernel_on_gpu(cuda, kvH, pos, kv):
    from repro_torch.models.attention import quantize_kv

    rng = np.random.default_rng(pos)
    q = _t(rng.standard_normal((2, 16, 64)).astype(np.float32)).to(cuda)
    k = _t(rng.standard_normal((2, kvH, 16, 64)).astype(np.float32)).to(cuda)
    v = _t(rng.standard_normal((2, kvH, 16, 64)).astype(np.float32)).to(cuda)
    ks = vs = None
    if kv == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    got = decode_attention(q, k, v, pos, ks, vs)
    want = decode_attention_plain(q, k, v, pos, ks, vs)
    tol = 2e-4 if kv == "int8" else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
