"""The port's twin of ``tests/test_properties.py``, case for case: hypothesis
property tests on system invariants, against ``repro_torch``.  The
round-trip and delta properties also run over trees of torch tensors (bf16
leaves, transposed views that are not contiguous, 0-d leaves, int64,
all-zero leaves), whose JIFs must equal the JAX package's ``snapshot`` of
the same values as numpy / ``ml_dtypes`` arrays apart from ``created_at``.
The model properties hold the port's functions to the JAX package's on the
same seeded inputs, within the reference test's tolerances or tighter."""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.core import snapshot as jsnapshot
from repro.models.attention import dequantize_kv as jdequantize_kv
from repro.models.attention import quantize_kv as jquantize_kv
from repro.train.steps import softmax_xent as jsoftmax_xent
from repro_torch.core import SpiceRestorer, snapshot
from repro_torch.core import overlay
from repro_torch.core.treeutil import flatten_state, leaf_names, unflatten_state
from repro_torch.models.attention import dequantize_kv, quantize_kv
from repro_torch.train.steps import softmax_xent
from torch_twins import assert_trees_equal, jif_bytes_but_created_at, torch_leaf

PAGE = 1024
KINDS = ["numpy", "torch"]

# ---------------------------------------------------------- state strategies
dtypes = st.sampled_from([np.float32, np.int32, np.uint8, np.float16])


@st.composite
def arrays(draw):
    dt = draw(dtypes)
    shape = tuple(draw(st.lists(st.integers(1, 5), min_size=0, max_size=3)))
    seed = draw(st.integers(0, 2**31 - 1))
    r = np.random.RandomState(seed)
    a = (np.asarray(r.randn(*shape)) * 100).astype(dt)  # 0-d safe
    return a


@st.composite
def state_trees(draw, depth=2):
    if depth == 0:
        return draw(arrays())
    kind = draw(st.sampled_from(["leaf", "dict", "list"]))
    if kind == "leaf":
        return draw(arrays())
    n = draw(st.integers(1, 3))
    if kind == "dict":
        keys = draw(
            st.lists(st.text("abcdef", min_size=1, max_size=4), min_size=n,
                     max_size=n, unique=True)
        )
        return {k: draw(state_trees(depth=depth - 1)) for k in keys}
    return [draw(state_trees(depth=depth - 1)) for _ in range(n)]


def as_kind(kind, tree, seed):
    """``(tree the port snapshots, the same values as numpy arrays)``.  For
    ``"torch"`` every leaf becomes a tensor, and by the seed's coin a float
    leaf bf16, an int32 leaf int64, a leaf all zero, a leaf of 2 or more
    dims a transposed view (``torch_twins.torch_leaf``)."""
    if kind == "numpy":
        return tree, tree
    r = np.random.RandomState(seed)
    leaves, desc = flatten_state(tree)
    pairs = {}
    for name, a in leaves:
        form = ("bf16", "int64", "zero", "transposed")[r.randint(4)]
        if ((form == "bf16" and a.dtype.kind != "f") or (form == "int64" and a.dtype != np.int32)
                or (form == "transposed" and a.ndim < 2)):
            form = "transposed" if a.ndim >= 2 else "plain"
        pairs[name] = torch_leaf(a, form)
    return (unflatten_state(desc, {n: t for n, (t, _) in pairs.items()}),
            unflatten_state(desc, {n: v for n, (_, v) in pairs.items()}))


def assert_jif_like_jax(kind, path, values, **kw):
    if kind == "torch":
        jsnapshot(values, path + ".jax", page_size=PAGE, **kw)
        assert jif_bytes_but_created_at(path) == jif_bytes_but_created_at(path + ".jax")


@pytest.mark.parametrize("kind", KINDS)
@given(state_trees(), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_jif_roundtrip_any_tree(tmp_path_factory, kind, tree, form_seed):
    d = tmp_path_factory.mktemp("prop")
    path = str(d / "t.jif")
    tree, values = as_kind(kind, tree, form_seed)
    snapshot(tree, path, page_size=PAGE)
    got, _, _, _ = SpiceRestorer().restore(path)
    assert_trees_equal(values, got)
    assert_jif_like_jax(kind, path, values)


@pytest.mark.parametrize("kind", KINDS)
@given(state_trees(), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_tree_flatten_names_stable(kind, tree, form_seed):
    tree, _ = as_kind(kind, tree, form_seed)
    leaves, desc = flatten_state(tree)
    assert [n for n, _ in leaves] == leaf_names(desc)
    rebuilt = unflatten_state(desc, dict(leaves))
    leaves2, desc2 = flatten_state(rebuilt)
    assert [n for n, _ in leaves] == [n for n, _ in leaves2]


@pytest.mark.parametrize("kind", KINDS)
@given(state_trees(), st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_delta_chain_roundtrip_any_tree(tmp_path_factory, kind, tree, seed):
    """Parent → child delta → restore through the chain is byte-identical,
    for arbitrary trees and arbitrary leaf perturbations."""
    from repro_torch.core import NodeImageCache

    d = tmp_path_factory.mktemp("delta")
    parent_path = str(d / "parent.jif")
    snapshot(as_kind(kind, tree, seed)[0], parent_path, page_size=PAGE)

    r = np.random.RandomState(seed)
    leaves, desc = flatten_state(tree)
    child_leaves = {}
    for n, a in leaves:
        a = np.asarray(a)
        if a.size and r.rand() < 0.5:  # dirty a subset of leaves
            b = a.copy().reshape(-1)
            b[r.randint(0, b.size)] = b[r.randint(0, b.size)] + 1
            a = b.reshape(a.shape)
        child_leaves[n] = a
    child, values = as_kind(kind, unflatten_state(desc, child_leaves), seed)

    child_path = str(d / "child.jif")
    stats = snapshot(child, child_path, parent=parent_path, page_size=PAGE)
    assert stats.private_bytes <= stats.total_bytes
    # fresh cache: the parent is bootstrapped from disk during restore
    got, _, _, _ = SpiceRestorer(node_cache=NodeImageCache()).restore(child_path)
    assert_trees_equal(values, got)
    assert_jif_like_jax(kind, child_path, values, parent=parent_path)


# --------------------------------------------------------- overlay invariants
@given(st.binary(min_size=1, max_size=PAGE * 9), st.booleans())
@settings(max_examples=40, deadline=None)
def test_classification_accounting(data, with_base):
    buf = np.frombuffer(data, np.uint8)
    base = None
    if with_base:
        b = buf.copy()
        if len(b) > PAGE:
            b[:PAGE] = ~b[:PAGE]  # first page always differs
        base = overlay.chunk_digests(memoryview(b.tobytes()), PAGE)
    kinds = overlay.classify(memoryview(buf), PAGE, base)
    table = overlay.IntervalTable(overlay.intervals_from_kinds(kinds))
    counts = table.counts()
    assert sum(counts.values()) == overlay.n_chunks(len(buf), PAGE)
    # intervals are sorted, non-overlapping, alternating kinds
    t = table.table
    for i in range(1, len(t)):
        assert t[i, 0] == t[i - 1, 0] + t[i - 1, 1]
        assert t[i, 2] != t[i - 1, 2]


@given(st.integers(0, 2**31 - 1), st.integers(1, 64))
@settings(max_examples=30, deadline=None)
def test_kv_quantization_error_bound(seed, sc):
    r = np.random.RandomState(seed)
    xn = r.randn(2, 3, sc, 16).astype(np.float32) * np.float32(r.uniform(0.01, 10))
    x = torch.from_numpy(xn)
    q, scale = quantize_kv(x)
    deq = dequantize_kv(q, scale, torch.float32)
    # max per-vector error <= scale/2 + eps (symmetric rounding)
    err = np.abs((deq - x).numpy())
    bound = scale.numpy()[..., None] * 0.51 + 1e-6
    assert (err <= bound).all()
    # the JAX package's quantization of the same values, level for level
    jq, jscale = jquantize_kv(jnp.asarray(xn))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jdequantize_kv(jq, jscale, jnp.float32)))


# ------------------------------------------------------------- loss identity
@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_masked_xent_equals_gather_xent(seed):
    r = np.random.RandomState(seed)
    ln = r.randn(2, 5, 17).astype(np.float32)
    tn = r.randint(0, 17, size=(2, 5))
    logits, targets = torch.from_numpy(ln), torch.from_numpy(tn)
    got = softmax_xent(logits, targets)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    want = torch.mean(lse - tgt)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the JAX package's masked sum over the same logits
    np.testing.assert_allclose(float(got), float(jsoftmax_xent(jnp.asarray(ln), jnp.asarray(tn))),
                               rtol=1e-6)


# -------------------------------------------------------------- ssd property
@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_ssd_chunking_invariance(seed):
    """SSD output must not depend on the chunk size."""
    from repro.models.mamba2 import ssd as jssd
    from repro_torch.models.mamba2 import ssd

    r = np.random.RandomState(seed)
    B, S, H, P, N = 1, 32, 2, 8, 4
    xn = r.randn(B, S, H, P).astype(np.float32) * 0.5
    an = -np.abs(r.randn(B, S, H)).astype(np.float32) * 0.3
    bn = r.randn(B, S, 1, N).astype(np.float32) * 0.5
    cn = r.randn(B, S, 1, N).astype(np.float32) * 0.5
    x, a, Bm, Cm = (torch.from_numpy(v) for v in (xn, an, bn, cn))
    y8, st8 = ssd(x, a, Bm, Cm, 8)
    y16, st16 = ssd(x, a, Bm, Cm, 16)
    y32, st32 = ssd(x, a, Bm, Cm, 32)
    np.testing.assert_allclose(y8.numpy(), y16.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st8.numpy(), st32.numpy(), rtol=1e-4, atol=1e-4)
    # each chunking against the JAX package's at the same chunk
    for chunk, y, state in ((8, y8, st8), (16, y16, st16), (32, y32, st32)):
        jy, jst = jssd(*(jnp.asarray(v) for v in (xn, an, bn, cn)), chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(state.numpy(), np.asarray(jst), rtol=1e-4, atol=1e-4)
