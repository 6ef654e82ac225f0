"""Device mesh helpers for multi-chip scaling.

The reference's parallelism is shared-memory OpenMP + single-GPU offload
(SURVEY.md section 2, parallelism table); the accelerator-native equivalent
is a ``jax.sharding.Mesh`` over the devices with ``shard_map``/``pjit``
collectives."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_names: Sequence[str] = ("z",),
              axis_sizes: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Build a mesh over available devices. With one axis, all devices go on
    it; with several, ``axis_sizes`` must multiply to the device count."""
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for multi-axis meshes")
        axis_sizes = (len(devices),)
    grid = np.array(devices).reshape(tuple(axis_sizes))
    return Mesh(grid, tuple(axis_names))


def grid_sharding(mesh: Mesh, axis_name: str = "z") -> NamedSharding:
    """Z-slab sharding for ``[nx, ny, nz]`` grids: the last axis is split
    across ``axis_name`` (SURVEY.md section 5 long-context analogue)."""
    return NamedSharding(mesh, P(None, None, axis_name))


def ray_sharding(mesh: Mesh, axis_name: str = "z") -> NamedSharding:
    """Leading-axis sharding for ray/point batches ``[N, ...]``."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
