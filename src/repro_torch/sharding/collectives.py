"""Explicit collectives over a ``DeviceMesh``'s named axes, and
:func:`shard_map`: the counterparts of ``jax.shard_map`` and
``jax.lax.{psum, pmean, all_gather, all_to_all, axis_index}`` that the
reference's MoE and embedding use.

The port runs plain tensors replicated on every rank (global views).
:func:`shard_map` cuts each input to this rank's block of its spec, runs
the body on plain local tensors (so the kernels and ``bmm``s see plain
tensors), and gathers each output's blocks back into the global view.
Gradients follow the same global view, as the reference's transposes do:
an input's gradient is the sum over ranks of each rank's block gradient;
an output's cotangent is cut to this rank's block; ``all_reduce``'s
backward is the identity (its output is replicated, so is the cotangent);
``all_gather``'s is a sum over the group, then this rank's slice;
``all_to_all``'s is the same exchange.

Every collective runs over ``torch.distributed`` process groups: one per
mesh axis (the ``DeviceMesh``'s own) and, for several axes together, one
made on first use from the ranks that share the other axes' coordinates
(``new_group(..., use_local_synchronization=True)``: only its members
call it).  A mesh's ranks must increase along each axis, as
``torch.arange(n).reshape(shape)`` lays them out.

Under a recorder of ``repro_torch.launch.hlo_analysis`` every collective
reports its kind, dtype, buffer shape and group size; the edges of
:func:`shard_map` report theirs as ``view`` records, and the body's ops are
tagged as a region's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import hlo_analysis
from repro_torch.sharding.partition import MeshAxes, Spec, as_axes, axis_sizes

_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[object, object]] = {}


def axis_group(mesh, axes: MeshAxes):
    """The process group over mesh axes ``axes`` that holds this rank, its
    ranks in row-major order of those axes."""
    axes = as_axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    hit = _GROUPS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    names = list(mesh.mesh_dim_names)
    rest = [names.index(a) for a in names if a not in axes]
    grid = mesh.mesh.permute(*rest, *(names.index(a) for a in axes))
    rows = grid.reshape(-1, math.prod(axis_sizes(mesh)[a] for a in axes)).tolist()
    me = dist.get_rank()
    row = next(r for r in rows if me in r)
    if row != sorted(row):
        raise ValueError(f"mesh ranks must increase along {axes}: {row}")
    group = dist.new_group(row, use_local_synchronization=True)
    _GROUPS[key] = (mesh, group)
    return group


def axis_index(mesh, axes: MeshAxes) -> int:
    """This rank's index along ``axes`` (row-major over several), as
    ``jax.lax.axis_index`` folds them."""
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    idx = 0
    for a in as_axes(axes):
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


def _gather(x: torch.Tensor, group, dim: int, view: bool = False) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    shape = list(x.shape)
    shape[dim] *= n
    hlo_analysis.collective("all-gather", x.dtype, shape, n, view)
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, group, view: bool = False) -> None:
    """In place, as ``dist.all_reduce``."""
    hlo_analysis.collective("all-reduce", x.dtype, x.shape, dist.get_world_size(group), view)
    dist.all_reduce(x, group=group)


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return _block(g, ctx.dim, n, i).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    x = x.contiguous()
    y = torch.empty_like(x)
    hlo_analysis.collective("all-to-all", x.dtype, x.shape, dist.get_world_size(group))
    dist.all_to_all_single(y, x, group=group)
    return y


def all_reduce(x: torch.Tensor, mesh, axes: MeshAxes) -> torch.Tensor:
    """``jax.lax.psum`` over ``axes``."""
    return _AllReduce.apply(x, axis_group(mesh, axes))


def pmean(x: torch.Tensor, mesh, axes: MeshAxes) -> torch.Tensor:
    """``jax.lax.pmean`` over ``axes``."""
    n = math.prod(axis_sizes(mesh)[a] for a in as_axes(axes))
    return all_reduce(x, mesh, axes) / n


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    return _AllGather.apply(x, axis_group(mesh, axis), dim)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)``: block i of dim 0 goes to rank i, which keeps it as
    block (this rank)."""
    return _AllToAll.apply(x, axis_group(mesh, axis))


def _sharded_dims(spec: Spec):
    return [(d, as_axes(ax)) for d, ax in enumerate(spec) if as_axes(ax)]


class _Enter(torch.autograd.Function):
    """Global view -> this rank's block of ``spec``; the gradient of the
    global view is the sum over every rank of its block's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec, ctx.shape = mesh, spec, x.shape
        sizes = axis_sizes(mesh)
        x = x.view_as(x)  # a view, never the input itself
        for d, axes in _sharded_dims(spec):
            n = math.prod(sizes[a] for a in axes)
            x = _block(x, d, n, axis_index(mesh, axes))
            hlo_analysis.collective("slice", x.dtype, x.shape, n, view=True)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, sizes = ctx.mesh, axis_sizes(ctx.mesh)
        with hlo_analysis.scope("edge"):
            full = g.new_zeros(ctx.shape)
            view = full
            for d, axes in _sharded_dims(ctx.spec):
                view = _block(view, d, math.prod(sizes[a] for a in axes), axis_index(mesh, axes))
            view.copy_(g)
            _all_reduce(full, axis_group(mesh, tuple(sizes)), view=True)
        return full, None, None


class _Exit(torch.autograd.Function):
    """This rank's block of ``spec`` -> the global view (gathered over each
    sharded dim's axes); the cotangent is cut back to the block."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        x = x.view_as(x)
        for d, axes in _sharded_dims(spec):
            x = _gather(x, axis_group(mesh, axes), d, view=True)
        return x

    @staticmethod
    def backward(ctx, g):
        sizes = axis_sizes(ctx.mesh)
        with hlo_analysis.scope("edge"):
            for d, axes in _sharded_dims(ctx.spec):
                g = _block(g, d, math.prod(sizes[a] for a in axes), axis_index(ctx.mesh, axes))
            return g.contiguous(), None, None


def shard_map(fn: Callable, mesh, in_specs: Sequence[Spec], out_specs: Sequence[Spec]):
    """``jax.shard_map(fn, mesh, in_specs, out_specs)`` over global views:
    ``fn`` gets each argument's local block and returns a tuple of local
    outputs, one per entry of ``out_specs``."""

    def run(*args):
        with hlo_analysis.scope("edge"):
            local = [_Enter.apply(a, mesh, s) for a, s in zip(args, in_specs)]
        with hlo_analysis.scope("region"):
            outs = fn(*local)
        with hlo_analysis.scope("edge"):
            return tuple(_Exit.apply(o, mesh, s) for o, s in zip(outs, out_specs))

    return run
