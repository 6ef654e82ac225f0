"""voxelized_geometry_tools_tpu: an accelerator-native differentiable voxel geometry
engine (JAX / XLA / Pallas / shard_map).

A from-scratch reimplementation of the capabilities of
``calderpg/voxelized_geometry_tools`` (C++17/CUDA/OpenCL) designed
accelerator-first:

* maps are functional pytrees of dense channel arrays (no cell atomics),
* dense passes (EDT sweeps, ray carving, fusion filtering) are vectorized
  XLA programs with Pallas kernels for the hot paths,
* SDF queries and the sphere-traced renderer are differentiable end-to-end
  (pixel gradients flow to voxel values and sensor poses), and
* multi-chip scaling uses ``jax.sharding.Mesh`` + ``shard_map`` collectives.
"""

from .version import __version__

from .core.grid import GridSpec
from .core.maps import (
    FREE, UNKNOWN, FILLED,
    OccupancyMap, OccupancyComponentMap,
    TaggedObjectOccupancyMap, TaggedObjectOccupancyComponentMap,
    SignedDistanceField,
)
from .core.dsh import (
    DSHGridSizes, DynamicSpatialHashedOccupancyMap, FillStatus, PackedDSHMap,
)

__all__ = [
    "__version__", "GridSpec",
    "FREE", "UNKNOWN", "FILLED",
    "OccupancyMap", "OccupancyComponentMap", "TaggedObjectOccupancyMap",
    "TaggedObjectOccupancyComponentMap", "SignedDistanceField",
    "DSHGridSizes", "DynamicSpatialHashedOccupancyMap", "FillStatus",
    "PackedDSHMap",
]
