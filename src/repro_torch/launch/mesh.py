"""Meshes for the dry run — the twin of the JAX package's ``launch/mesh.py``.

A dry-run mesh is abstract: the shape and the axis names of a deployment,
with no process group and no device behind it (``backend/mesh.py`` ``Mesh``
builds process groups when it is made, so the dry run never constructs
one). ``launch/dryrun.py`` reads which axes split the batch and how many
devices share each collective from it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named axes of the given sizes, first axis major."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} and axes {self.axis_names} differ "
                             "in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be positive, got {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def devices(self) -> np.ndarray:
        """Device ordinals laid out in the mesh's shape (nothing is opened)."""
        return np.arange(self.size).reshape(self.axis_sizes)

    def axes_size(self, axes: Sequence[str]) -> int:
        """The devices spanned by ``axes`` (those the mesh has)."""
        return int(np.prod([self.shape[a] for a in axes if a in self.shape], dtype=np.int64))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16×16 = 256 devices ("data", "model"); 2 pods = 512 ("pod", "data", "model")."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(shape, axes) -> AbstractMesh:
    """Any mesh (tests, one host)."""
    return AbstractMesh(tuple(int(n) for n in shape), tuple(axes))


def make_host_mesh() -> AbstractMesh:
    """This host's cards (one device where there is none) as a 1-D "data"
    mesh."""
    return AbstractMesh((max(1, torch.cuda.device_count()),), ("data",))
