"""Logical-axis sharding: models annotate *logical* axes; the launch layer
binds them to mesh axes via rules (the counterpart of
``repro.sharding.partition``).

A rule set holds a mesh (a ``torch.distributed.device_mesh.DeviceMesh``,
or an :class:`AbstractMesh` of axis names and sizes where no process group
exists) and the logical -> mesh-axis mapping.  Outside a rules context
every annotation is a no-op.  Divisibility is checked at binding time: a
logical axis whose dimension does not divide the mesh-axis extent falls
back to a prefix of its axes that divides, else to replication (e.g.
mamba2's vocab of 50280 on a 16-way ``model`` axis), and no mesh axis is
used twice in one spec.

A spec is a tuple with one entry per tensor dim, each a mesh-axis name, a
tuple of names, or None: element for element the reference's
``PartitionSpec``.  :func:`to_placements` turns it into DTensor placements
(one ``Shard(dim)`` or ``Replicate()`` per mesh dim).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only, like ``jax.sharding.AbstractMesh``: enough
    to bind logical axes (specs, placements, cost models) without ranks."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """name -> size of every axis of a ``DeviceMesh`` or :class:`AbstractMesh`,
    in mesh order (the reference's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class _Rules:
    mesh: Any
    mapping: Dict[str, MeshAxes]


def current_rules() -> Optional[_Rules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(mesh, mapping: Dict[str, MeshAxes]):
    prev = current_rules()
    _STATE.rules = _Rules(mesh, dict(mapping))
    try:
        yield
    finally:
        _STATE.rules = prev


def as_axes(axes: MeshAxes) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh-axis names (None -> ())."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh, axes: MeshAxes) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in as_axes(axes)))


def logical_to_spec(
    logical: Sequence[Optional[str]],
    shape: Optional[Sequence[int]] = None,
    rules: Optional[_Rules] = None,
) -> Spec:
    """Map a tuple of logical axis names to a spec under the rules.

    If ``shape`` is given, any axis whose dim is not divisible by the bound
    mesh extent is replicated instead (with no error), and mesh axes are never
    used twice in one spec (first logical axis wins).
    """
    rules = rules or current_rules()
    if rules is None:
        return (None,) * len(logical)
    used: set = set()
    out = []
    for i, name in enumerate(logical):
        axes = rules.mapping.get(name) if name else None
        if axes is None:
            out.append(None)
            continue
        ax_tuple = tuple(a for a in as_axes(axes) if a not in used)
        if not ax_tuple:
            out.append(None)
            continue
        if shape is not None and shape[i] % _axis_size(rules.mesh, ax_tuple) != 0:
            # try a prefix of the axes that divides
            while ax_tuple and shape[i] % _axis_size(rules.mesh, ax_tuple) != 0:
                ax_tuple = ax_tuple[:-1]
            if not ax_tuple:
                out.append(None)
                continue
        used.update(ax_tuple)
        out.append(ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple)
    return tuple(out)


def to_placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d's entry names it, else ``Replicate()``.
    A dim sharded over several mesh axes is split by them in mesh order,
    as ``PartitionSpec`` splits it (first axis major)."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {a: d for d, axes in enumerate(spec) for a in as_axes(axes)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in axis_sizes(mesh))


def named_sharding(logical: Sequence[Optional[str]], shape=None) -> Optional[Tuple[Any, ...]]:
    """The placements of a tensor with these logical axes under the current
    rules (None without rules)."""
    rules = current_rules()
    if rules is None:
        return None
    return to_placements(logical_to_spec(logical, shape, rules), rules.mesh)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the spec of ``logical`` under the active
    rules.  A no-op without rules and on a plain tensor: the port runs
    plain tensors replicated on every rank (global views), and only the
    explicit-collective regions (``sharding.collectives.shard_map``) split
    work between ranks."""
    from torch.distributed.tensor import DTensor

    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(logical, x.shape, rules)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


@dataclasses.dataclass
class ParamSpec:
    """Single source of truth for one parameter tensor: its shape, logical
    axes, initializer (``normal`` | ``zeros`` | ``ones`` | ``fanin`` |
    ``log_uniform``) and a dtype that overrides the model's (norms stay
    f32).  ``lm.init_params`` draws the values."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"
    dtype: Optional[torch.dtype] = None


def map_specs(specs, fn):
    """Apply fn to every ParamSpec leaf of a nested structure."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(v, fn) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(v, fn) for v in specs)
    return specs


def abstract_from_specs(specs, dtype):
    """Tensors on the ``meta`` device (shape and dtype, no storage): the
    reference's ``ShapeDtypeStruct`` stand-ins."""
    return map_specs(specs, lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                                  device="meta"))


def shardings_from_specs(specs):
    """Placements tree for the current rules (None tree without rules)."""
    return map_specs(specs, lambda s: named_sharding(s.logical, s.shape))
