"""Mesh axes of the 4D hybrid algorithm (port of ``repro.core.mesh``).

The paper decomposes the devices as ``G_data x G_x x G_y x G_z``. The
port runs on one device so far: every factor must be 1, and then each
collective below is the identity, exactly as the JAX helpers degrade on an
unmapped axis. A factor above 1 raises ``NotImplementedError``; the
multi-rank mesh (``torch.distributed`` process groups, gloo on the CPU and
NCCL on the card) is the ROADMAP.md §1 item "multi-rank mesh".
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

AXES = ("data", "x", "y", "z")


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical 4D axes with their sizes (g_data, g_x, g_y, g_z)."""

    sizes: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def __post_init__(self):
        if len(self.sizes) != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} factors {AXES}, "
                             f"got {self.sizes}")
        if any(int(s) != 1 for s in self.sizes):
            raise NotImplementedError(
                f"mesh {tuple(self.sizes)}: the PyTorch port runs on one "
                f"device (mesh 1,1,1,1) until the ROADMAP.md §1 item "
                f"'multi-rank mesh' lands")

    def size(self, axis: str) -> int:
        return self.sizes[AXES.index(axis)]

    @property
    def gy(self) -> int:
        return self.size("y")

    @property
    def batch_shards(self) -> int:
        """How many ways the batch is split (data x z)."""
        return self.size("data") * self.size("z")


# Collectives over one axis. ``MeshAxes`` admits size-1 axes only, where
# each of these is the identity (rank 0 for ``axis_index``).

def psum(v, axes: MeshAxes, axis: str):
    return v


def pmax(v, axes: MeshAxes, axis: str):
    return v


def all_gather(v, axes: MeshAxes, axis: str, *, dim: int):
    return v


def psum_scatter(v, axes: MeshAxes, axis: str, *, dim: int):
    return v


def axis_index(axes: MeshAxes, axis: str) -> int:
    return 0
