"""Logical-dim → mesh-axis sharding rules (from ``repro.parallel.sharding``).

Every parameter and cache dim carries a logical name (``Param.dims``,
``lm.cache_dims_tree``); the rules map names to mesh axes per run mode, so
one model runs on one card, a 16 x 16 ``data x model`` mesh or the
2 x 16 x 16 ``pod x data x model`` mesh by swapping rules:

* batch → ``('pod', 'data')``: data parallelism;
* heads, d_ff, vocab, experts → ``'model'``: tensor and expert parallelism;
* weight d_model (``fsdp``, ``fsdp_mlp``) → ``'data'`` (and ``'pod'``)
  when the config shards weights fully (ZeRO-3 style);
* cache seq → ``'model'`` for decoding (each device streams its share of
  the KV cache); long context (batch below the data axis) shards it over
  every axis.

A spec is a tuple with one axis entry per dim: ``None``, an axis name or a
tuple of names; there is no ``PartitionSpec``.  A mesh here is anything
with ``.shape``, a name → size mapping (``launch.mesh.Mesh``).
:func:`shard_shape` is the per-device block of a sharded dim set, as
``NamedSharding.shard_shape`` gives it.

Left out until the port has a device mesh (ROADMAP A9): ``constrain``
(``with_sharding_constraint`` by logical names) and ``param_shardings``
(the rules bound to devices).  For A9: the fsdp rule is ``('data',
'pod')``, the reverse of the mesh's ``('pod', 'data', 'model')``.  Shard
shapes do not depend on the order, but which block lands on which device
does, and a DTensor ``Shard`` over two mesh dims follows mesh order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ..models.common import map_tree, tree_paths

__all__ = [
    "Axis",
    "ShardingRules",
    "make_rules",
    "mesh_axis_size",
    "param_specs",
    "shard_shape",
    "validate_divisibility",
]

Axis = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical dim name → mesh axis (or axes); ``mesh`` optional."""

    rules: Dict[str, Axis]
    mesh: Optional[Any] = None

    def axis(self, name: Optional[str]) -> Axis:
        if name is None:
            return None
        return self.rules.get(name)

    def spec(self, dims: Sequence[Optional[str]]) -> Tuple[Axis, ...]:
        return tuple(self.axis(d) for d in dims)

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return mesh_axis_size(self.mesh, self.axis(name))


def make_rules(
    *,
    fsdp: bool = False,
    fsdp_mlp: Optional[bool] = None,  # None: follow fsdp
    shard_kv_heads: bool = False,
    batch_axes: Axis = ("pod", "data"),
    cache_seq_axes: Axis = "model",
    cache_batch_axes: Axis = "data",
    with_pod: bool = True,
    mesh: Optional[Any] = None,
) -> ShardingRules:
    """The reference's rules, keyword for keyword."""
    if batch_axes is None:
        batch = None
    elif with_pod:
        batch = batch_axes
    else:
        axes = (batch_axes,) if isinstance(batch_axes, str) else batch_axes
        batch = tuple(a for a in axes if a != "pod") or None
    fsdp_axes = ("data", "pod") if with_pod else "data"
    rules: Dict[str, Axis] = {
        "batch": batch,
        "act_batch": batch,
        "seq": None,
        "d_model": None,
        "heads": "model",
        "kv_heads": "model" if shard_kv_heads else None,
        # the weights' kv dim shards over 'model' even while a serving
        # cache shards its sequence there
        "kv_heads_w": "model",
        "head_dim": None,
        "d_ff": "model",
        "vocab": "model",
        "experts": "model",
        "capacity": "data",
        "layers": None,
        "fsdp": fsdp_axes if fsdp else None,
        # MLP weights can keep the data-axis shard while attention's go
        # model-only (serving)
        "fsdp_mlp": fsdp_axes if (fsdp if fsdp_mlp is None else fsdp_mlp)
        else None,
        "cache_batch": cache_batch_axes,
        "cache_seq": cache_seq_axes,
        "ssm_state": None,
        "frontend": None,
    }
    return ShardingRules(rules, mesh=mesh)


def param_specs(defs: Any, rules: ShardingRules) -> Any:
    """Param-def tree → spec tree (same structure)."""
    return map_tree(lambda p: rules.spec(p.dims), defs)


def mesh_axis_size(mesh: Any, axis: Axis) -> int:
    """Devices along ``axis``: 1 for ``None``, the product for a tuple."""
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis]
    return math.prod(mesh.shape[a] for a in axis)


def shard_shape(shape: Sequence[int], spec: Sequence[Axis],
                mesh: Any) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` sharded by ``spec``:
    each dim divided by the devices along its axis entry (a spec shorter
    than the shape leaves the trailing dims whole).  A dim that does not
    divide raises."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} is longer than shape "
                         f"{tuple(shape)}")
    out = []
    for i, size in enumerate(shape):
        n = mesh_axis_size(mesh, spec[i]) if i < len(spec) else 1
        if size % n:
            raise ValueError(f"dim {i} of shape {tuple(shape)} ({size}) is "
                             f"not divisible by {spec[i]} ({n} devices)")
        out.append(size // n)
    return tuple(out)


def validate_divisibility(defs: Any, rules: ShardingRules, mesh: Any
                          ) -> None:
    """Raise if any sharded param dim does not divide its mesh axes."""
    problems = []
    for _, p in tree_paths(defs):  # the reference's (sorted) leaf order
        for size, dim in zip(p.shape, p.dims):
            ax = rules.axis(dim)
            n = mesh_axis_size(mesh, ax)
            if size % n:
                problems.append(f"dim {dim}={size} not divisible by "
                                f"{ax}({n})")
    if problems:
        raise ValueError("sharding divisibility violations:\n"
                         + "\n".join(problems))
