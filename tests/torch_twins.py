"""Shared by the port's twins of the JAX package's data-plane tests
(``tests/test_torch_{upload,node,invocation,cluster,engine}.py``): the JAX
initializer's weights carried into the port, the JAX package's tokens on
them, the device a ``gpu``-marked case asks for, numpy forms of the port's
tensors (bf16 as ``ml_dtypes``), and a JIF's bytes without its timestamp."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.serve.instance import generate as jgenerate
from repro.serve.instance import layerwise_state as jlayerwise
from repro_torch.core.treeutil import flatten_state, leaf_bytes, unflatten_state
from repro_torch.interop import dtype_name, params_from_jax, to_host

_CREATED_AT = b"\xaacreated_at\xcb"  # msgpack: the key, then a float64

CPU = "cpu"
# a case per device: the CPU always, the card where there is one
DEVICES = [CPU, pytest.param("cuda", marks=pytest.mark.gpu)]


def need_device(device: str) -> str:
    """``device``, or a skip when it is the card and there is none."""
    if device != CPU and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return device


def jax_params(cfg, key: int, dtype=jnp.float32):
    """The JAX package's ``lm.init_params`` at ``PRNGKey(key)`` in ``dtype``
    (f32 unless asked), as numpy arrays (``ml_dtypes`` arrays for bf16)."""
    return jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(key), dtype))


def port_params(np_params, device=CPU):
    """The same weights as the port's params (torch tensors on ``device``)."""
    return params_from_jax(np_params, device)


def jax_tokens(cfg, np_params, prompt, max_new: int) -> np.ndarray:
    """The JAX package's greedy tokens over ``np_params``: its own
    layer-gated ``generate``, as its node serves them."""
    return jgenerate(cfg, None, jlayerwise(cfg, np_params), prompt, max_new)[0]


def torch_leaf(a: np.ndarray, form: str):
    """``(tensor, numpy value)``: ``a`` as a torch leaf of ``form`` and the
    same values as the array the JAX package takes.  ``"bf16"`` (the same
    bits on both sides, ``ml_dtypes`` on the numpy side), ``"int64"``,
    ``"zero"`` (every byte zero), ``"transposed"`` (2 or more dims: a view
    of the first two dims swapped, not contiguous unless one has size 1)
    or ``"plain"``."""
    if form == "bf16":
        a = a.astype(ml_dtypes.bfloat16)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16), a
    if form == "int64":
        a = a.astype(np.int64)
    elif form == "zero":
        a = np.zeros_like(a)
    elif form == "transposed":
        t = np.ascontiguousarray(np.swapaxes(a, 0, 1))
        return torch.from_numpy(t).transpose(0, 1), a
    return torch.from_numpy(np.array(a)), a


def torch_twin(state, bf16=("embed/tok",)):
    """``(torch_state, numpy_state)``: one numpy state's values as the
    leaves the port's torch touchpoints take, and as the numpy (or
    ``ml_dtypes``) arrays the JAX package takes.  The leaves named in
    ``bf16`` become bf16, every other 2-D leaf a transposed view, and the
    rest plain tensors: a 0-d leaf stays 0-d, int64 stays int64, an
    all-zero leaf all zero."""
    leaves, desc = flatten_state(state)
    pairs = {n: torch_leaf(a, "bf16" if n in bf16 else "transposed" if a.ndim == 2 else "plain")
             for n, a in leaves}
    assert any(not t.is_contiguous() for t, _ in pairs.values())  # a view is in
    return (unflatten_state(desc, {n: t for n, (t, _) in pairs.items()}),
            unflatten_state(desc, {n: a for n, (_, a) in pairs.items()}))


def twin(kind: str, state):
    """``(state the port snapshots, the same values as numpy arrays)``:
    ``state`` itself for ``"numpy"``, its ``torch_twin`` for ``"torch"``."""
    return (state, state) if kind == "numpy" else torch_twin(state)


def leaf_key(x):
    """A leaf's dtype name, shape and bytes: two leaves with equal keys hold
    the same values, whether numpy arrays or torch tensors."""
    return dtype_name(x.dtype), tuple(x.shape), leaf_bytes(x).tobytes()


def assert_trees_equal(a, b):
    """The same leaf names, each leaf the same dtype, shape and bytes."""
    la, lb = flatten_state(a)[0], flatten_state(b)[0]
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert leaf_key(x) == leaf_key(y), n


def to_numpy(x) -> np.ndarray:
    """torch tensor (any device) or array-like -> numpy array, a bf16
    tensor as an ``ml_dtypes.bfloat16`` array (the type the JAX package's
    values have; the port itself never needs it)."""
    h = to_host(x)
    if isinstance(h, torch.Tensor):  # bf16
        return h.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return h


def jif_bytes_but_created_at(path) -> bytes:
    """A JIF's bytes with its header's ``created_at`` timestamp zeroed: two
    writers of the same state give the same bytes apart from it."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    at = raw.index(_CREATED_AT) + len(_CREATED_AT)
    raw[at:at + 8] = bytes(8)
    return bytes(raw)
