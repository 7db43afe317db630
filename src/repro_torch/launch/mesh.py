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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

__all__ = ["Mesh", "bind_mesh", "has_pod_axis", "make_host_mesh",
           "make_production_mesh", "mesh_axes"]


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


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def has_pod_axis(mesh: Mesh) -> bool:
    return "pod" in mesh.axis_names
