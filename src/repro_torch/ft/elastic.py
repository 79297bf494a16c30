"""Elastic scaling: rebuild the mesh from the live ranks and re-shard the
training state (the counterpart of ``repro.ft.elastic``).

JIF checkpoints record *logical* axes, not placements, so a restore can
materialize the same state under ANY mesh: scale-down after failures and
scale-up after recovery are both "restore under the new rules".  A JIF
written by either package reshards alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.device import DeviceLike
from repro_torch.interop import to_torch, tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.partition import axis_rules, shardings_from_specs


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]


def plan_mesh(n_devices: int, model_parallel: int = 16, pods: int = 1) -> MeshPlan:
    """Largest (pod, data, model) grid that fits the live device count,
    holding TP fixed (weights layouts survive) and shrinking DP."""
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    data = max(n_devices // (mp * pods), 1)
    if pods > 1:
        return MeshPlan((pods, data, mp), ("pod", "data", "model"))
    return MeshPlan((data, mp), ("data", "model"))


def make_mesh_from_plan(plan: MeshPlan, world: Optional[int] = None,
                        device: DeviceLike = None):
    """A ``DeviceMesh`` of the plan over the first ``prod(plan.shape)`` ranks
    (the rest stay idle), on ``device``'s type (None: the GPU).  ``world``,
    when given, must be the default group's size."""
    import torch.distributed as dist

    if world is not None and world != dist.get_world_size():
        raise ValueError(f"world {world} != the process group's {dist.get_world_size()}")
    return make_mesh(plan.shape, plan.axes, device)


def reshard_state(state_np, specs_tree, mesh, rules: Dict):
    """Place a host-resident (restored) state onto a mesh: every leaf of
    ``state_np`` (numpy arrays or CPU tensors) becomes a DTensor with the
    placements its spec's logical axes take under ``rules`` (a plain tensor
    on the mesh's device where no rules bind).  Leaves are matched by name,
    so a restored tree's sorted keys need not follow the specs' order.
    The model's steps take plain tensors (``full_tensor()`` of these); the
    placements record the rules' layout (``repro_torch.sharding``)."""
    from torch.distributed.tensor import distribute_tensor

    with axis_rules(mesh, rules):
        sh = shardings_from_specs(specs_tree)

    def put(arr, placements):
        t = to_torch(arr, mesh.device_type, copy=True)
        if placements is None:
            return t
        return distribute_tensor(t, mesh, list(placements))

    return tree_map(put, state_np, sh)
