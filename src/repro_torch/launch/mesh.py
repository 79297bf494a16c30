"""Mesh construction over ``torch.distributed`` (the counterpart of
``repro.launch.mesh``).

FUNCTIONS, not module-level constants: importing this module never touches
``torch.distributed``.  Each mesh is a ``DeviceMesh`` over ranks
``0..n-1`` of the initialized default process group, laid out row-major
(``torch.arange(n).reshape(shape)``).  The reference's ``make_mesh_compat``
has no counterpart: it only bridges jax versions with and without
``jax.sharding.AxisType``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.partition import axis_sizes


def make_mesh(shape, axes, device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks, on ``device``'s type (None: the GPU).  Every rank
    of the default group must call it; ranks past the mesh hold no
    coordinate in it.  Raises without an initialized process group or with
    too few ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: init_process_group first "
                           "(init_single_process for one rank)")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None):
    """Degenerate 1x1 mesh over this rank's one device (smoke/bench paths)."""
    return make_mesh((1, 1), ("data", "model"), device)


def init_single_process(device: DeviceLike = None) -> None:
    """A process group of world size 1 over an in-memory store (nothing
    listens on a socket): NCCL on the GPU, gloo on the CPU.  A no-op when
    one is initialized already."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def data_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)
