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

On a mesh bound to a process group (``launch.mesh.bind_mesh``) a spec
becomes DTensor placements (:func:`placements`, :class:`Sharding`,
:func:`param_shardings`), and :func:`constrain` redistributes a DTensor
to the rules' placements (the reference's ``with_sharding_constraint``).
A dim sharded over a tuple of axes is split with the tuple's first axis
outermost, as ``NamedSharding`` splits it.  The fsdp rule ``('data',
'pod')`` is the reverse of the mesh's ``('pod', 'data', 'model')``, and a
DTensor ``Shard`` over two mesh dims follows mesh order, so such a pair
is placed with ``_StridedShard`` on the mesh's earlier axis: each device
holds the block the reference's ``NamedSharding`` gives it.  These
placements lay out checkpoints, the elastic reshard
(``runtime.reshard_state``) and the dry run's DTensor arguments; the
model's mesh paths (``mlp._ep_moe_fwd``, ``lm._embed_lookup``) take their
parameters whole as plain tensors or as such DTensors.  A step on
DTensors runs the models' ``constrain`` calls, whose gradients are laid
out by the same constraint, and their ``local_call`` regions (the
counterpart of ``shard_map``) where an op has no sharding of its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..models.common import map_tree, tree_paths

__all__ = [
    "Axis",
    "Sharding",
    "ShardingRules",
    "constrain",
    "gather_fsdp",
    "is_dtensor",
    "local_call",
    "make_rules",
    "mesh_axis_size",
    "param_shardings",
    "param_specs",
    "partial_on",
    "placements",
    "reduce_partials",
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

    @property
    def bound(self) -> bool:
        """Whether the mesh is bound to a process group (the mesh paths
        run only there; an abstract mesh lays out specs alone)."""
        return getattr(self.mesh, "device_mesh", None) is not None


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


def placements(spec: Sequence[Axis], mesh: Any) -> tuple:
    """DTensor placements (one per mesh axis) of ``spec`` on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes]
        if pos == sorted(pos):
            for p in pos:
                out[p] = Shard(dim)
        elif len(pos) == 2:
            # (outer, inner) with the inner axis first in the mesh: the
            # mesh's earlier axis splits each of the outer axis' blocks.
            outer, inner = pos
            out[inner] = _StridedShard(dim, split_factor=mesh.shape[
                names[outer]])
            out[outer] = Shard(dim)
        else:
            raise NotImplementedError(f"spec entry {axes} on mesh {names}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a bound mesh: the counterpart of ``NamedSharding``."""

    mesh: Any
    spec: Tuple[Axis, ...]

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, tensor: torch.Tensor):
        """A DTensor of the full ``tensor`` (the same on every rank), each
        rank keeping its own block; no communication."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh.device_mesh,
                                 self.placements, src_data_rank=None)


def param_shardings(defs: Any, rules: ShardingRules, mesh: Any) -> Any:
    """Param-def tree → :class:`Sharding` tree on the bound ``mesh``."""
    return map_tree(lambda p: Sharding(mesh, rules.spec(p.dims)), defs)


def constrain(x, rules: ShardingRules, dims: Sequence[Optional[str]]):
    """``x`` laid out by the rules' spec of ``dims``: a DTensor is
    redistributed to its placements; a plain tensor, ``rules=None`` or
    rules without a mesh pass through, as the reference outside a jit
    mesh."""
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    want = placements(rules.spec(dims), rules.mesh)
    if not x.requires_grad:
        return x if tuple(x.placements) == want else x.redistribute(
            rules.mesh.device_mesh, want)
    return _Constrain.apply(x, want)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient laid out as
    ``want`` first, then as the input: the transpose of the reference's
    ``with_sharding_constraint`` is the same constraint on the cotangent,
    so a partial gradient is summed where the reference sums it.  (Plain
    ``redistribute`` passes the gradient on as it comes, and a partial
    sum would flow on through the products behind it.)  A ``Partial``
    input's gradient stays replicated there, as DTensor keeps it."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Partial, Replicate

        ctx.want, ctx.mesh = want, x.device_mesh
        ctx.back = tuple(Replicate() if isinstance(p, Partial) else p
                         for p in x.placements)
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        if tuple(g.placements) != ctx.back:
            g = g.redistribute(ctx.mesh, ctx.back)
        return g, None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor where no
    process group is in use)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def reduce_partials(x):
    """A DTensor whose partial sums span several mesh axes (a gradient
    over ``('pod', 'data')``) with them summed by one all-reduce over the
    flattened group of those axes, as XLA reduces over a tuple of axes;
    DTensor would reduce axis by axis, moving the bytes twice.  Any other
    tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not is_dtensor(x):
        return x
    dims = [i for i, p in enumerate(x.placements)
            if isinstance(p, Partial) and p.reduce_op == "sum"]
    if len(dims) < 2:
        return x
    import types

    import torch.distributed._functional_collectives as funcol

    from . import collectives

    dm = x.device_mesh
    names = tuple(dm.mesh_dim_names)
    mesh = types.SimpleNamespace(axis_names=names, device_mesh=dm,
                                 shape=dict(zip(names, dm.shape)))
    group = collectives.axis_group(mesh, tuple(names[i] for i in dims))
    local = funcol.wait_tensor(funcol.all_reduce(x.to_local(), "sum",
                                                 group))
    pl = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
    return DTensor.from_local(local, dm, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def gather_fsdp(tree: Any, rules: Optional[ShardingRules]) -> Any:
    """A parameter tree with every DTensor leaf's fsdp shard gathered (its
    placements on the ``fsdp`` / ``fsdp_mlp`` axes made ``Replicate``;
    the model axis keeps its shard): the weights a ZeRO-3 step gathers
    before it uses them, as XLA gathers the reference's, and their
    gradients come back as a reduce-scatter.  The caller gathers the
    stacked layers before it slices one: a slice of a ``_StridedShard``
    leaf cannot be laid out again in every torch release.  Plain tensors,
    and rules without fsdp, pass through."""
    if rules is None or not rules.bound:
        return tree
    axes = set()
    for name in ("fsdp", "fsdp_mlp"):
        ax = rules.axis(name)
        axes.update((ax,) if isinstance(ax, str) else tuple(ax or ()))
    if not axes:
        return tree
    from torch.distributed.tensor import Replicate

    names = rules.mesh.axis_names

    def one(t):
        if not is_dtensor(t):
            return t
        want = tuple(Replicate() if names[i] in axes else p
                     for i, p in enumerate(t.placements))
        return t if want == tuple(t.placements) else t.redistribute(
            t.device_mesh, want)

    return map_tree(one, tree)


def partial_on(spec: Sequence[Axis], axes: Axis, mesh: Any) -> tuple:
    """The placements of ``spec`` with ``Partial`` on the mesh axes
    ``axes`` (an axis name, a tuple, or ``None`` for none): the layout of
    a gradient that each rank there holds only its share of."""
    from torch.distributed.tensor import Partial

    out = list(placements(spec, mesh))
    for a in (axes,) if isinstance(axes, str) else tuple(axes or ()):
        out[mesh.axis_names.index(a)] = Partial()
    return tuple(out)


def local_call(fn, mesh: Any, args: Sequence, in_specs: Sequence,
               out_specs: Any, grad_specs: Optional[Sequence] = None):
    """``fn`` on one rank's blocks, the counterpart of a ``shard_map``:
    each DTensor of ``args`` is laid out by its entry of ``in_specs`` (a
    spec tuple, or placements) and its local block passed to ``fn``; any
    other argument passes as it is.  ``fn``'s outputs (a tensor or a
    tuple) become DTensors laid out by ``out_specs`` (one entry, or one an
    output).  ``grad_specs`` gives an input's gradient placements where
    they are not its layout (a replicated input that each rank uses for
    its own share: ``Partial`` on those axes)."""
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh

    def pl(spec):
        if spec is None:
            return None
        if spec and not isinstance(spec[0], (str, tuple, type(None))):
            return tuple(spec)
        return placements(spec, mesh)

    local = []
    for i, (a, spec) in enumerate(zip(args, in_specs)):
        if not is_dtensor(a):
            local.append(a)
            continue
        want = pl(spec)
        if tuple(a.placements) != want:
            a = a.redistribute(dm, want)
        grad = pl(grad_specs[i]) if grad_specs is not None else None
        local.append(a.to_local(grad_placements=grad))
    out = fn(*local)

    def wrap(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, dm, pl(spec), run_check=False)

    if isinstance(out, tuple):
        specs = out_specs if isinstance(out_specs, list) else \
            [out_specs] * len(out)
        return tuple(wrap(t, sp) for t, sp in zip(out, specs))
    return wrap(out, out_specs)


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
