"""Production meshes (a port of the JAX package's ``launch/mesh.py``).

The reference builds a ``jax`` mesh of 256 or 512 devices; one card has
none.  Here a mesh is the layout only: its axis names and sizes, which
the sharding plan and the dry run read (``mesh.shape[axis]``).  Nothing in
this module touches a device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["Mesh", "make_production_mesh", "dp_axes", "dp_size",
           "DP_SINGLE", "DP_MULTI"]

DP_SINGLE = ("data",)
DP_MULTI = ("pod", "data")


@dataclass(frozen=True)
class Mesh:
    """A device mesh's logical layout: ordered axis names and their
    sizes."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 two-pod (512 devices)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a production mesh ('pod' included)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.shape[a]
    return out
