"""Production mesh builders: port of ``repro.launch.mesh``.

The reference builds ``jax.sharding.Mesh`` objects over (forced host or
real) devices.  The port's mesh is plain data: the axis names and their
sizes, with ``shape`` a mapping from axis name to size as a jax mesh's
is, so the sharding rules read ``mesh.shape[axis]`` unchanged.  No
device is touched: the port runs on one card, and the meshes describe
the deployments the sharding rules and the dry-run's per-device bytes
are computed for.  The single-pod production mesh is a 16x16 = 256 chip
pod ("data", "model"); the multi-pod mesh is 2 pods = 512 chips ("pod",
"data", "model") where the "pod" axis crosses the (slow) DCN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``axis_names[i]`` has ``axis_sizes[i]``
    devices, the devices numbered row-major over the axes (the first axis
    major), as ``jax.make_mesh`` lays them out."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def chips(self) -> int:
        """The device count (the reference's ``mesh.devices.size``)."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ("data", "model") mesh, as the reference's tests use."""
    return Mesh(("data", "model"), (data, model))
