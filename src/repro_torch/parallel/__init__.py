"""Parallelism of the port: logical-dim sharding rules and their checks."""
from .sharding import (
    Axis,
    ShardingRules,
    make_rules,
    mesh_axis_size,
    param_specs,
    shard_shape,
    validate_divisibility,
)

__all__ = ["Axis", "ShardingRules", "make_rules", "mesh_axis_size",
           "param_specs", "shard_shape", "validate_divisibility"]
