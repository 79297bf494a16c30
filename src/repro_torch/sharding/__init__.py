"""Logical-axis sharding rules over a ``DeviceMesh`` (``partition``) and
explicit collectives over its axes (``collectives``).

Two representations live side by side and do not meet.  The model runs
on plain tensors, whole on every rank (global views); only the MoE's and
the embedding's ``shard_map`` regions split work between ranks.  The
placements the rules give (``constrain``, ``shardings_from_specs``,
``launch.specs.CellPlan.in_shardings``, ``ft.elastic.reshard_state``)
describe the reference's layout, and no model path consumes them:
``constrain`` is a no-op on every path that runs.  So a rank's memory and
FLOPs on this path are those of the whole model, not the placements'
share, until a tensor-parallel plan for the dense layers exists.
"""
from repro_torch.sharding.partition import (
    AbstractMesh,
    ParamSpec,
    axis_rules,
    axis_sizes,
    constrain,
    current_rules,
    logical_to_spec,
    named_sharding,
    to_placements,
)

__all__ = [
    "AbstractMesh",
    "ParamSpec",
    "axis_rules",
    "axis_sizes",
    "constrain",
    "current_rules",
    "logical_to_spec",
    "named_sharding",
    "to_placements",
]
