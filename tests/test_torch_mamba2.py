"""The port's Mamba2 path against ``repro.models.mamba2`` and the Pallas
SSD-scan kernel, on the same inputs.

Weights come from the JAX package's initializer and cross with
``params_from_jax``; activations are made with numpy from a seed.
Tolerances: f32 1e-4 for the scan and the layers (the chunked form sums in
another order), bf16 5e-2, as ``tests/test_kernels.py`` holds the Pallas
kernel to its reference.  The test marked ``gpu`` holds the CUDA kernel
against its plain version on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import mamba2 as jm
from repro_torch.configs import get_config as t_get_config
from repro_torch.interop import params_from_jax, to_torch, tree_map
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tm

ARCH = "mamba2-780m"
F32 = jnp.float32
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
# (B, S, H, G, P, N, chunk) of tests/test_kernels.py::test_ssd_scan
SCAN_SHAPES = [(1, 256, 4, 1, 64, 32, 64), (2, 128, 8, 2, 32, 16, 32), (1, 512, 2, 1, 64, 64, 128)]


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """On some CPUs the first vectorized ``torch.exp`` of a fresh process
    was seen off in the fourth significant digit; every later call was
    exact to f32.  One warm-up call keeps the comparisons below about the
    algorithm."""
    torch.exp(torch.full((1 << 15,), -0.3))


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL["float32"]):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _scan_inputs(seed, B, S, H, G, P, N, dtype="float32"):
    """The distributions of tests/test_kernels.py: x, B, C ~ 0.5 N(0, 1),
    a = -0.3 softplus(N(0, 1)) (negative, moderate decay)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    a = (-np.logaddexp(rng.standard_normal((B, H, S)), 0) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    cast = _NP[dtype]
    return x.astype(cast), a, Bm.astype(cast), Cm.astype(cast)


def _t(a):
    return to_torch(np.asarray(a))


# ------------------------------------------------------------ scan pieces
def test_segsum():
    x = _x(0, 2, 3, 8)
    _close(tm.segsum(_t(x)), jm.segsum(jnp.asarray(x)))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_matches_reference(with_state):
    B, S, H, G, P, N, chunk = 2, 32, 4, 2, 8, 16, 8
    x, a, Bm, Cm = _scan_inputs(1, B, S, H, G, P, N)
    a_bsh = np.ascontiguousarray(a.transpose(0, 2, 1))
    init = _x(2, B, H, P, N, scale=0.5) if with_state else None
    jy, jst = jm.ssd(jnp.asarray(x), jnp.asarray(a_bsh), jnp.asarray(Bm), jnp.asarray(Cm),
                     chunk, None if init is None else jnp.asarray(init))
    ty, tst = tm.ssd(_t(x), _t(a_bsh), _t(Bm), _t(Cm), chunk,
                     None if init is None else _t(init))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,G,P,N,chunk", SCAN_SHAPES)
def test_ssd_scan_plain_matches_pallas(dtype, B, S, H, G, P, N, chunk):
    x, a, Bm, Cm = _scan_inputs(S + H, B, S, H, G, P, N, dtype)
    jy, jst = j_ssd_scan(jnp.asarray(x), jnp.asarray(a), jnp.asarray(Bm), jnp.asarray(Cm),
                         chunk=chunk, interpret=True)
    ty, tst = ssd_ops.ssd_scan(_t(x), _t(a), _t(Bm), _t(Cm), chunk=chunk)
    assert ty.dtype == _t(x).dtype and tst.dtype == torch.float32
    assert tuple(tst.shape) == (B, H, P, N)
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])


# (B, S, H, G, P, N, chunk, l): the Pallas kernel at ``chunk`` against the
# CUDA kernel's chunking at ``l`` (64 is the kernel's; 32 shows that the
# result does not hang on it): each scan shape, S 96 (a short last chunk:
# 64 + 32) and a long prompt of mamba2's head shape
CHUNKED_CASES = [(*shape, l) for shape in SCAN_SHAPES for l in (64, 32)] + [
    (2, 96, 4, 2, 32, 64, 256, 64),
    (1, 1024, 8, 1, 64, 128, 256, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,G,P,N,chunk,l", CHUNKED_CASES)
def test_ssd_scan_chunked_plain_matches_pallas(dtype, B, S, H, G, P, N, chunk, l):
    """The arithmetic of the CUDA kernel, which cannot run here: its chunk
    ``l`` in place of the caller's, the last chunk zero-padded."""
    x, a, Bm, Cm = _scan_inputs(S + H + l, B, S, H, G, P, N, dtype)
    jy, jst = j_ssd_scan(jnp.asarray(x), jnp.asarray(a), jnp.asarray(Bm), jnp.asarray(Cm),
                         chunk=chunk, interpret=True)
    ty, tst = ssd_ops.ssd_scan_chunked_plain(_t(x), _t(a), _t(Bm), _t(Cm), l)
    assert ty.dtype == _t(x).dtype and tuple(ty.shape) == (B, S, H, P)
    assert tst.dtype == torch.float32 and tuple(tst.shape) == (B, H, P, N)
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])


@pytest.mark.parametrize("extra", [16, 32, 96])
def test_zero_tokens_change_nothing(extra):
    """Zero tokens (a = 0, x = B = C = 0) after the prompt leave y and the
    final state bit-identical, inside the last chunk, filling it, and as a
    whole chunk more: the kernel's padding of a short last chunk is exact."""
    B, S, H, G, P, N, l = 2, 96, 4, 2, 16, 32, 64
    x, a, Bm, Cm = (_t(v) for v in _scan_inputs(5, B, S, H, G, P, N))
    y, st = ssd_ops.ssd_scan_chunked_plain(x, a, Bm, Cm, l)
    zeros = lambda t: torch.cat([t, t.new_zeros((B, extra, *t.shape[2:]))], dim=1)  # noqa: E731
    ya, sta = ssd_ops.ssd_scan_chunked_plain(
        zeros(x), torch.cat([a, a.new_zeros((B, H, extra))], dim=2), zeros(Bm), zeros(Cm), l)
    assert torch.equal(ya[:, :S], y)
    assert torch.equal(ya[:, S:], torch.zeros_like(ya[:, S:]))
    assert torch.equal(sta, st)


def test_ssd_scan_refuses_indivisible_seq():
    x, a, Bm, Cm = (_t(v) for v in _scan_inputs(3, 1, 12, 2, 1, 4, 8))
    with pytest.raises(ValueError, match="not divisible by chunk 8"):
        ssd_ops.ssd_scan(x, a, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="not divisible by chunk 8"):
        tm.ssd(x, a.transpose(1, 2), Bm, Cm, 8)


# ------------------------------------------------------------ the layers
@pytest.fixture(scope="module", params=[False, True], ids=["fused_proj", "split_proj"])
def layer(request):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), mamba_split_proj=request.param)
    tcfg = dataclasses.replace(t_get_config(ARCH).reduced(), mamba_split_proj=request.param)
    params = jlm.init_params(cfg, jax.random.PRNGKey(11), jnp.float32)
    # dt_bias and the conv biases start at zero: move them, so the test
    # sees them added where the reference adds them
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(12)
    mp = dict(np_params["pattern"][0]["mamba"])
    for k in mp:
        if k == "dt_bias" or k.startswith("conv") and k.endswith("_b"):
            mp[k] = mp[k] + rng.standard_normal(mp[k].shape).astype(np.float32) * 0.1
    layer0 = dict(np_params["pattern"][0], mamba=mp)
    jp0 = jax.tree.map(lambda a: jnp.asarray(a[0]), layer0)
    tp0 = tree_map(lambda a: to_torch(a[0]), layer0)
    return cfg, tcfg, jp0, tp0


@pytest.mark.parametrize("S", [8, 2])  # 2 < K - 1: the cache keeps pad zeros
def test_mamba_full_and_cache(layer, S):
    cfg, tcfg, jp0, tp0 = layer
    x = _x(20 + S, 2, S, cfg.d_model)
    jy, jc = jm.mamba_full(cfg, jp0["mamba"], jnp.asarray(x), F32, return_cache=True)
    ty, tc = tm.mamba_full(tcfg, tp0["mamba"], _t(x), torch.float32, return_cache=True)
    _close(ty, jy)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape) and tc[k].dtype == torch.float32
        _close(tc[k], jc[k])
    if S < cfg.conv_kernel - 1:
        for k in tc:
            if k.startswith("conv"):
                assert torch.all(tc[k][:, : cfg.conv_kernel - 1 - S] == 0)


@pytest.mark.parametrize("S", [8, 2])
def test_mamba_decode_and_new_cache(layer, S):
    cfg, tcfg, jp0, tp0 = layer
    x = _x(30 + S, 2, S, cfg.d_model)
    _, jc = jm.mamba_full(cfg, jp0["mamba"], jnp.asarray(x), F32, return_cache=True)
    tc = {k: _t(v) for k, v in jc.items()}  # an identical start
    x1 = _x(40 + S, 2, 1, cfg.d_model)
    jy, jc2 = jm.mamba_decode(cfg, jp0["mamba"], jnp.asarray(x1), jc, F32)
    ty, tc2 = tm.mamba_decode(tcfg, tp0["mamba"], _t(x1), tc, torch.float32)
    _close(ty, jy)
    assert set(tc2) == set(jc2)
    for k in jc2:
        _close(tc2[k], jc2[k])


def test_apply_layer_prefill_then_decode(layer):
    cfg, tcfg, jp0, tp0 = layer
    spec = cfg.pattern[0]
    assert spec.kind == "mamba" and not spec.ffn
    S = 8
    x = _x(50, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    jx, jc, _ = jblocks.apply_layer(cfg, spec, jp0, jnp.asarray(x), positions=jnp.asarray(pos),
                                    mode="prefill", cache=None, pos=None, compute_dtype=F32)
    tx, tc, _ = tblocks.apply_layer(tcfg, spec, tp0, _t(x), positions=_t(pos), mode="prefill",
                                 cache=None, pos=None, compute_dtype=torch.float32)
    _close(tx, jx)
    for step in range(2):
        x1 = _x(51 + step, 2, 1, cfg.d_model)
        dpos = np.full((2, 1), S + step, np.int32)
        jx, jc, _ = jblocks.apply_layer(cfg, spec, jp0, jnp.asarray(x1),
                                        positions=jnp.asarray(dpos), mode="decode", cache=jc,
                                        pos=jnp.int32(S + step), compute_dtype=F32)
        tx, tc, _ = tblocks.apply_layer(tcfg, spec, tp0, _t(x1), positions=None, mode="decode",
                                     cache=tc, pos=S + step, compute_dtype=torch.float32)
        _close(tx, jx)
        _close(tc["ssm"], jc["ssm"])


def test_mamba_full_refuses_indivisible_prompt(layer):
    """The reference asserts S % min(chunk, S) == 0 and does not pad: a
    12-token prompt at chunk 8 is refused by both packages."""
    cfg, tcfg, jp0, tp0 = layer
    x = _x(60, 1, 12, cfg.d_model)
    with pytest.raises(AssertionError, match="not divisible by chunk 8"):
        jm.mamba_full(cfg, jp0["mamba"], jnp.asarray(x), F32)
    with pytest.raises(ValueError, match="not divisible by chunk 8"):
        tm.mamba_full(tcfg, tp0["mamba"], _t(x), torch.float32)


def test_softplus_is_logaddexp():
    x = np.linspace(-40, 40, 161).astype(np.float32)
    _close(tm.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)), dict(rtol=1e-6, atol=1e-6))


# ------------------------------------------------------------ parameters
def _named(tree, path=()):
    """{slash path: (shape, dtype name)} over dict/tuple trees, keys sorted,
    for the port's ``Shape`` leaves and JAX's ``ShapeDtypeStruct`` alike."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], path + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_named(v, path + (str(i),)))
        return out
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else str(np.dtype(dt))
    return {"/".join(path): (tuple(tree.shape), name)}


@pytest.mark.parametrize("split", [False, True])
def test_param_shapes_match_reference_tree(split):
    """Full width, without materializing 3.4 GB: the port's shape tree
    against the reference's abstract parameters."""
    cfg = dataclasses.replace(get_config(ARCH), mamba_split_proj=split)
    tcfg = dataclasses.replace(t_get_config(ARCH), mamba_split_proj=split)
    want = _named(jlm.abstract_params(cfg, jnp.float32))
    shapes = tree_map(lambda s: dataclasses.replace(s, dtype=s.dtype or torch.float32),
                      tlm.param_specs(tcfg))
    assert _named(shapes) == want
    if not split:
        assert want["pattern/0/mamba/in_proj"] == ((48, 1536, 2 * 3072 + 2 * 128 + 48), "float32")
        assert sum(int(np.prod(s)) for s, _ in want.values()) == 857_379_072


def test_init_params_matches_reference_and_pins_f32():
    from repro_torch.core.treeutil import flatten_state

    cfg = get_config(ARCH).reduced()
    tcfg = t_get_config(ARCH).reduced()
    params = jlm.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    mine = tlm.init_params(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    want = {n: (a.shape, str(a.dtype)) for n, a in flatten_state(params)[0]}
    got = {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in flatten_state(mine)[0]}
    assert got == want
    m = mine["pattern"][0]["mamba"]
    for k in ("A_log", "D", "dt_bias", "norm_w"):
        assert m[k].dtype == torch.float32
    assert m["in_proj"].dtype == torch.bfloat16
    a = torch.exp(m["A_log"])
    assert torch.all(a >= 1.0) and torch.all(a < 16.0) and a.std() > 1.0
    assert torch.all(m["D"] == 1) and torch.all(m["dt_bias"] == 0)
    again = tlm.init_params(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(again["pattern"][0]["mamba"]["A_log"], m["A_log"])


# ------------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,G,P,N,chunk",
                         SCAN_SHAPES + [(2, 16, 48, 1, 64, 128, 256), (1, 512, 48, 1, 64, 128, 256),
                                        (2, 96, 8, 2, 64, 64, 256), (1, 2048, 48, 1, 64, 128, 256),
                                        (2, 1024, 48, 1, 64, 128, 256),
                                        (1, 512, 8, 1, 64, 256, 256), (2, 96, 8, 2, 61, 63, 256),
                                        (2, 16, 8, 2, 64, 256, 256), (1, 64, 8, 1, 61, 63, 64),
                                        (2, 1, 8, 1, 64, 128, 256)])
def test_ssd_scan_kernel_on_gpu(cuda, dtype, B, S, H, G, P, N, chunk):
    x, a, Bm, Cm = (_t(v).to(cuda) for v in _scan_inputs(S + H, B, S, H, G, P, N, dtype))
    before = ssd_ops.LAUNCHES.count
    y, st = ssd_ops.ssd_scan(x, a, Bm, Cm, chunk=chunk)
    assert ssd_ops.LAUNCHES.count == before + 1
    # the plain version on the same values in f32, as the kernel widens
    # bf16 (the plain version in bf16 rounds its intermediates and alone
    # strays past 5e-2 at N 256)
    wy, wst = ssd_ops.ssd_scan_plain(x.float(), a, Bm.float(), Cm.float(), chunk)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), wy.to(y.dtype).float(), rtol=tol["rtol"],
                               atol=tol["atol"])
    torch.testing.assert_close(st, wst, rtol=tol["rtol"], atol=tol["atol"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_reads_strided_views_on_gpu(cuda, dtype):
    """B and C as slices of one conv output and ``a`` transposed, as
    ``mamba_full`` passes them: no copies, the contiguous call's result."""
    B, S, H, G, P, N = 2, 96, 8, 2, 32, 64
    x, a, Bm, Cm = (_t(v).to(cuda) for v in _scan_inputs(7, B, S, H, G, P, N, dtype))
    conv = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, G * N), Cm.reshape(B, S, G * N)],
                     dim=-1)
    Bv = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cv = conv[..., H * P + G * N:].reshape(B, S, G, N)
    av = a.transpose(1, 2).contiguous().transpose(1, 2)
    assert not (Bv.is_contiguous() or Cv.is_contiguous() or av.is_contiguous())
    y, st = ssd_ops.ssd_scan(x, av, Bv, Cv, chunk=256)
    wy, wst = ssd_ops.ssd_scan(x, a, Bm, Cm, chunk=256)
    torch.testing.assert_close(y, wy, rtol=0, atol=0)
    torch.testing.assert_close(st, wst, rtol=0, atol=0)
