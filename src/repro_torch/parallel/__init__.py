"""Parallelism of the port: logical-dim sharding rules, their placements
on a bound mesh, and the process-group collectives."""
from . import collectives
from .sharding import (
    Axis,
    Sharding,
    ShardingRules,
    constrain,
    make_rules,
    mesh_axis_size,
    param_shardings,
    param_specs,
    placements,
    shard_shape,
    validate_divisibility,
)

__all__ = ["Axis", "Sharding", "ShardingRules", "collectives", "constrain",
           "make_rules", "mesh_axis_size", "param_shardings", "param_specs",
           "placements", "shard_shape", "validate_divisibility"]
