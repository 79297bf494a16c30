"""numpy <-> torch conversion, dtype names, and small tree helpers.

JIFs name a tensor's dtype by ``str(arr.dtype)`` (numpy's spelling), so a
bf16 leaf is stored as ``"bfloat16"``.  numpy itself has no bf16: only the
``ml_dtypes`` extension type does, ``torch.from_numpy`` rejects that type,
and ``np.asarray`` rejects a torch bf16 tensor.  Everything here goes
through a 16-bit integer view instead, and the host form of a bf16 leaf is
a CPU torch tensor (``to_host``, ``host_view``), so publishing, restoring
and checkpointing a bf16 state never need ``ml_dtypes``, and the port
never imports it.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name) -> torch.dtype:
    """JIF dtype name (or numpy/torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _TORCH_DTYPES[dtype_name(name)]


def dtype_name(dtype) -> str:
    """numpy's spelling of a dtype (``"float32"``, ``"bfloat16"``), for a
    numpy dtype, a torch dtype, or a name."""
    if isinstance(dtype, torch.dtype):
        return _NAMES.get(dtype, str(dtype).removeprefix("torch."))
    if isinstance(dtype, str):
        return dtype
    return str(np.dtype(dtype))


def itemsize(name) -> int:
    return torch.empty((), dtype=torch_dtype(name)).element_size()


def storage_dtype(name) -> np.dtype:
    """A numpy dtype of the same width that numpy can always represent:
    ``bfloat16`` is carried as ``int16``, every other name as itself."""
    name = dtype_name(name)
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def host_view(raw: np.ndarray, name: str, shape) -> Any:
    """View the bytes ``raw`` (uint8) as a host tensor of dtype ``name``.
    numpy-native dtypes give a numpy view; ``bfloat16`` gives a CPU torch
    tensor over the same memory.  Either way nothing is copied."""
    arr = raw.view(storage_dtype(name))
    arr = arr.reshape(shape) if shape else arr.reshape(())
    if dtype_name(name) == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def to_torch(x, device=None, copy: bool = False) -> torch.Tensor:
    """numpy array (ml_dtypes bf16 included), torch tensor, or anything
    with ``__array__`` -> torch tensor on ``device``.  ``copy=True``
    guarantees the result shares no memory with ``x``: a CPU tensor made by
    ``torch.from_numpy`` aliases the numpy buffer."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        bf16 = a.dtype.name == "bfloat16"  # the ml_dtypes type
        if bf16:
            a = a.view(np.int16)
        if not a.flags.writeable:  # torch.from_numpy warns on these
            a = a.copy()
            copy = False
        t = torch.from_numpy(np.ascontiguousarray(a))
        if bf16:
            t = t.view(torch.bfloat16)
    out = t if device is None else t.to(device)
    if copy and out.data_ptr() == t.data_ptr():  # .to() kept the memory
        out = out.clone()
    return out


def to_host(x):
    """torch tensor (any device) or array-like -> its host form: a numpy
    array for every dtype numpy has, a CPU torch tensor for bf16 (the form
    ``host_view`` and the restore give).  A CPU tensor is not copied.  A
    dtype with no numpy form other than bf16 raises, as ``Tensor.numpy``
    does."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def wait_landed(x) -> None:
    """Block until the copy that produced ``x`` finished on its device, so
    the host buffer it was copied from may be reused."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


# ------------------------------------------------------------------ trees
def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """Map ``fn`` over the leaves of a dict/list/tuple tree (``None`` is an
    empty subtree, as in ``jax.tree.map``).  With ``rest``, ``fn`` takes the
    matching leaf of each of those trees too: dict entries by key, list and
    tuple entries by position, so their dicts may list keys in any order."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs, is_leaf=is_leaf) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def params_from_jax(np_params, device=None):
    """The JAX package's stacked params, as numpy arrays (the tree from
    ``jax.tree.map(np.asarray, params)``), -> the port's params: the same
    nesting (``{"embed": {"tok"}, "pattern": (stacked,), "remainder": (),
    "final_norm"}``) with torch tensors on ``device``."""
    return tree_map(lambda a: to_torch(a, device, copy=True), np_params)


def train_state_from_jax(np_params, np_opt, device=None):
    """The JAX package's training state as numpy arrays (its params, and
    its AdamW state ``{"m", "v", "count"}`` from ``adamw_init`` /
    ``adamw_update``) -> the port's ``(params, opt)``: the same trees of
    torch tensors on ``device``, ``count`` an int32 0-d tensor."""
    opt = {
        "m": params_from_jax(np_opt["m"], device),
        "v": params_from_jax(np_opt["v"], device),
        "count": to_torch(np.asarray(np_opt["count"], dtype=np.int32), device, copy=True),
    }
    return params_from_jax(np_params, device), opt
