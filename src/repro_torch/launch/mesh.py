"""Mesh builders (from ``repro.launch.mesh``).

A :class:`Mesh` is abstract: axis names and sizes, with ``.shape`` as a
name → size mapping and ``.axis_names``, which is all the sharding rules
and the dry run read.  Building one creates no process group and touches
no card, so the production meshes (256 and 512 devices) can be reasoned
about on any host.  ``devices`` names the cards of a host mesh.

:func:`bind_mesh` binds a mesh to a ``torch.distributed`` ``DeviceMesh``
with the same axis names, over the process group of
:mod:`repro_torch.parallel.collectives`: rank *r* sits at the row-major
coordinates of *r*, as device *r* does in the reference's
``Mesh(np.array(jax.devices()).reshape(sizes), names)``.

:func:`fake_group` starts a fake process group of a mesh's size in this
process (rank 0; its collectives move nothing) and binds the mesh to it
on ``cpu``, where ``meta`` DTensors live: the dry run's per-device
analysis runs a 256- or 512-rank step on one host that way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import torch

__all__ = ["Mesh", "bind_mesh", "fake_group", "has_pod_axis",
           "make_host_mesh", "make_production_mesh", "mesh_axes"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes; ``devices`` (in row-major order) where
    the mesh names this host's cards, else empty; ``device_mesh`` the
    ``DeviceMesh`` it is bound to (:func:`bind_mesh`), else ``None``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[str, ...] = ()
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """``pod16x16`` / ``pod2x16x16``, the reference's artifact names."""
        return "pod" + "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ``data x model`` (256 devices) or 2 x 16 x 16 ``pod x data
    x model`` (512 devices)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``data x model`` mesh over this host's first ``data * model``
    cards; raises if fewer are visible."""
    n = torch.cuda.device_count()
    if data * model > n:
        raise RuntimeError(f"need {data * model} GPUs, have {n}")
    return Mesh(("data", "model"), (data, model),
                tuple(f"cuda:{i}" for i in range(data * model)))


def bind_mesh(mesh: Mesh, device_type: str = "cuda") -> Mesh:
    """``mesh`` bound to a ``DeviceMesh`` of ``device_type`` over the
    initialized process group, whose world size must be ``mesh.size``."""
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, mesh.axis_sizes,
                          mesh_dim_names=mesh.axis_names)
    return dataclasses.replace(mesh, device_mesh=dm)


@contextlib.contextmanager
def fake_group(mesh: Mesh) -> Iterator[Mesh]:
    """``mesh`` bound on ``cpu`` to a fake process group of ``mesh.size``
    ranks, this process rank 0 (``torch.distributed``'s ``fake`` backend:
    every collective returns at once and moves nothing), for the span of
    the ``with``; the group is destroyed on exit.  Raises if this process
    already has a process group: a fake one must run in a process of its
    own."""
    import torch.distributed as dist
    # Registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..parallel import collectives

    if dist.is_initialized():
        raise RuntimeError("a process group exists in this process: run "
                           "the fake group in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield bind_mesh(mesh, "cpu")
    finally:
        collectives.destroy_group()


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def has_pod_axis(mesh: Mesh) -> bool:
    return "pod" in mesh.axis_names
