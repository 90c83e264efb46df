"""Production mesh shapes, without devices.

The counterpart of ``repro/launch/mesh.py``.  The dry-run
(``launch/dryrun.py``) needs only a mesh's axis names and sizes to size one
device's share of a step, so a :class:`MeshShape` holds just those: an
ordered ``shape`` mapping of axis name to size, as ``jax.sharding.Mesh.shape``
gives, and its ``size``.  No process group or ``DeviceMesh`` is made.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axes: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axes} and sizes {self.sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")``."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A ``("data", "model")`` mesh of ``data`` x ``model`` devices."""
    return MeshShape(("data", "model"), (data, model))
