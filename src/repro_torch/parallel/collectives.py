"""The process-group layer of the port: the counterpart of ``shard_map``'s
manual axes (``jax.lax.psum`` / ``all_to_all`` / ``all_gather`` /
``axis_index`` over named mesh axes).

A process group is initialized from a ``file://`` store in a directory the
caller gives (:func:`init_group`), never from a fixed TCP port, so that
several groups on one host cannot collide.  The backend follows the
tensors' device and is named explicitly: ``gloo`` for CPU tensors,
``nccl`` on the card; nothing falls back from one to the other.

The group of one mesh axis, or of a tuple of axes such as ``('pod',
'data')``, comes from the mesh's ``DeviceMesh`` (``launch.mesh.bind_mesh``).
A tuple's group lists its ranks in row-major order over the axes as
given, the order of the reference's ``axis_index`` over that tuple; the
axes must be in mesh order.  Every collective here is called by every
rank of its group at the same point of the program.

:func:`sum_forward` and :func:`sum_backward` are the two halves of a
``shard_map`` region for autograd: the partial results summed over the
group on the way out (their gradient passes unchanged), and the
replicated inputs' gradients summed over the group on the way back.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Any, Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "all_gather", "all_to_all", "axis_group",
           "axis_index", "axis_size", "destroy_group", "init_group", "psum",
           "sum_backward", "sum_forward"]

#: The backend of each device type.
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}
#: How long a collective waits for the other ranks before it fails.
TIMEOUT = datetime.timedelta(seconds=300)

Axes = Union[str, Sequence[str]]
#: Groups of a tuple of axes, keyed by the mesh's shape, its ranks and the
#: axes' positions (a mesh's layout, not its object: a mesh made anew may
#: reuse a freed one's address).
_GROUPS: Dict[Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]],
              Any] = {}


def init_group(store_dir: str, rank: int, world_size: int,
               device_type: str = "cuda") -> str:
    """Join the default process group of ``world_size`` ranks through a
    file store in ``store_dir`` (which every rank names alike and which
    must hold no store of an earlier group).  Returns the backend."""
    backend = BACKENDS[device_type]
    kwargs = {}
    if device_type == "cuda":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(
            os.path.abspath(store_dir), "store"),
        rank=rank, world_size=world_size,
        timeout=TIMEOUT, **kwargs)
    return backend


def destroy_group() -> None:
    """Leave the default process group (and every group made from it)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _device_mesh(mesh):
    if getattr(mesh, "device_mesh", None) is None:
        raise ValueError(f"mesh {mesh.axis_names} is not bound to a process "
                         f"group (launch.mesh.bind_mesh)")
    return mesh.device_mesh


def axis_size(mesh, axes: Axes) -> int:
    """Devices along ``axes`` (the product for a tuple)."""
    return math.prod(mesh.shape[a] for a in _axes(axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index along ``axes``: row-major over a tuple, the first
    axis outermost, as ``jax.lax.axis_index`` counts."""
    coord = dict(zip(mesh.axis_names, _device_mesh(mesh).get_coordinate()))
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.shape[a] + coord[a]
    return idx


def axis_group(mesh, axes: Axes):
    """The process group of this rank's line (or plane) along ``axes``."""
    axes = _axes(axes)
    dm = _device_mesh(mesh)
    if len(axes) == 1:
        return dm.get_group(axes[0])
    pos = [mesh.axis_names.index(a) for a in axes]
    if pos != sorted(pos):
        raise NotImplementedError(f"axes {axes} out of the mesh's order "
                                  f"{mesh.axis_names}")
    ranks = dm.mesh  # (sizes...) tensor of global ranks
    key = (tuple(ranks.shape), tuple(ranks.flatten().tolist()), tuple(pos))
    if key not in _GROUPS:
        rest = [i for i in range(ranks.dim()) if i not in pos]
        lines = ranks.permute(rest + pos).reshape(-1, math.prod(
            ranks.shape[i] for i in pos))
        me = dist.get_rank()
        for line in lines.tolist():  # every rank makes every group
            group = dist.new_group(line)
            if me in line:
                _GROUPS[key] = group
    return _GROUPS[key]


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n, ...) with n the group's size: row j goes to rank j, and
    row j of the result came from rank j (``jax.lax.all_to_all`` with
    ``split_axis = concat_axis = 0``, untiled)."""
    n = dist.get_world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all of {tuple(x.shape)} over {n} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (n, *x.shape)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if x.device.type == "cpu":  # gloo gathers into a list
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group; the gradient passes to each rank as it
    comes (every rank's loss is the same one)."""
    return _SumForward.apply(x, group)


def sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the group (the ranks used
    it for different shares of one result)."""
    return _SumBackward.apply(x, group)
