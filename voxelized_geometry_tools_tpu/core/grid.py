"""Dense voxel-grid core: static geometry spec + functional index math.

This module is the accelerator-native replacement for the reference's external
``common_robotics_utilities::voxel_grid::VoxelGridBase`` (the interface surface
the reference consumes is enumerated in SURVEY.md section 2.12b). Instead of a
mutable C++ class hierarchy, a grid here is:

* a :class:`GridSpec` — static (hashable) geometry: voxel counts + resolution.
  It participates in jit as static metadata so all shapes are compile-time
  constants, and
* array leaves (``origin_transform`` + per-channel ``[nx, ny, nz]`` arrays)
  carried by the map dataclasses in :mod:`..core.maps`.

Conventions (matching the reference semantics inferred from
/root/reference/src/voxelized_geometry_tools/cpu_pointcloud_voxelization.cpp:229-290
and /root/reference/test/sdf_generation_test.cpp fixtures):

* The grid-frame origin is the *minimum corner* of voxel ``(0, 0, 0)``; the
  grid spans ``[0, counts[i] * voxel_sizes[i])`` along axis ``i`` in grid
  frame (``voxel_sizes == (resolution,) * 3`` for the uniform specs every
  map type enforces).
* ``origin_transform`` (``X_WG``) maps grid-frame points to world frame.
* ``location -> index`` is ``floor(p_grid / voxel_sizes)`` per axis.
* ``index -> location`` is the cell center ``(index + 0.5) * voxel_sizes``.

All functions are pure, jit-able, and vectorize over leading batch dims of the
point arguments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from . import transforms

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static voxel-grid geometry (hashable; safe as a jit static arg).

    Mirrors ``common_robotics_utilities::voxel_grid::VoxelGridSizes`` as used
    at /root/reference/test/sdf_generation_test.cpp:271-272 and
    /root/reference/test/voxel_raycasting_test.cpp:30-31.
    """

    counts: Tuple[int, int, int]
    resolution: float
    # Per-axis voxel sizes (``VoxelGridBase::VoxelSizes``); defaults to the
    # uniform ``(resolution,) * 3``. ``resolution`` always equals the X size
    # (``VoxelXSize`` — the value the reference's uniform-enforcing map
    # classes use everywhere after ``EnforceUniformVoxelSize``,
    # tagged_object_occupancy_map.hpp:118).
    voxel_sizes: Optional[Tuple[float, float, float]] = None

    def __post_init__(self):
        # not (x > 0) instead of x <= 0: NaN compares False both ways and
        # would otherwise construct a spec that poisons all index math.
        if not (math.isfinite(self.resolution) and self.resolution > 0.0):
            raise ValueError("resolution must be a positive finite number")
        if any(int(c) <= 0 for c in self.counts):
            raise ValueError("voxel counts must be positive")
        object.__setattr__(
            self, "counts", tuple(int(c) for c in self.counts))
        object.__setattr__(self, "resolution", float(self.resolution))
        if self.voxel_sizes is None:
            sizes = (self.resolution,) * 3
        else:
            sizes = tuple(float(s) for s in self.voxel_sizes)
            if len(sizes) != 3:
                raise ValueError(
                    f"voxel_sizes must have 3 entries, got {len(sizes)}")
            if any(not (math.isfinite(v) and v > 0.0) for v in sizes):
                raise ValueError(
                    "voxel sizes must be positive finite numbers")
            # Tolerant comparison: the same nominal size given at f32 vs
            # f64 precision must not be rejected; resolution snaps to the
            # X size (VoxelXSize) when they agree within 1 ulp-ish.
            if not math.isclose(sizes[0], self.resolution,
                                rel_tol=1e-6, abs_tol=0.0):
                raise ValueError(
                    "resolution must equal voxel_sizes[0] (VoxelXSize)")
            object.__setattr__(self, "resolution", sizes[0])
        object.__setattr__(self, "voxel_sizes", sizes)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_voxel_counts(resolution: float, counts) -> "GridSpec":
        return GridSpec(tuple(int(c) for c in counts), float(resolution))

    @staticmethod
    def from_voxel_sizes(voxel_sizes, counts) -> "GridSpec":
        """Per-axis voxel sizes (``VoxelGridSizes`` with distinct x/y/z
        sizes — the non-uniform L1 surface, SURVEY.md §2.12b)."""
        sizes = tuple(float(s) for s in voxel_sizes)
        return GridSpec(tuple(int(c) for c in counts), sizes[0],
                        voxel_sizes=sizes)

    @staticmethod
    def from_grid_sizes(resolution: float, sizes) -> "GridSpec":
        """Counts from physical axis sizes (``VoxelGridSizes::FromGridSizes``).

        Rounds up so the grid covers at least the requested extent; exact
        multiples (as in every reference test fixture) are preserved.
        """
        resolution = float(resolution)
        counts = tuple(
            int(np.maximum(1, np.ceil(float(s) / resolution - 1e-9)))
            for s in sizes)
        return GridSpec(counts, resolution)

    # -- basic properties --------------------------------------------------

    @property
    def num_x(self) -> int:
        return self.counts[0]

    @property
    def num_y(self) -> int:
        return self.counts[1]

    @property
    def num_z(self) -> int:
        return self.counts[2]

    @property
    def num_total(self) -> int:
        return self.counts[0] * self.counts[1] * self.counts[2]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.counts

    @property
    def grid_sizes(self) -> Tuple[float, float, float]:
        """Physical extents per axis (``VoxelGridBase::GridSizes``)."""
        return tuple(c * s for c, s in zip(self.counts, self.voxel_sizes))

    @property
    def has_uniform_voxel_size(self) -> bool:
        """``VoxelGridBase::HasUniformVoxelSize``."""
        return (self.voxel_sizes[0] == self.voxel_sizes[1]
                == self.voxel_sizes[2])

    def enforce_uniform_voxel_size(self) -> "GridSpec":
        """Raise unless the voxel size is uniform — what every reference map
        class does on construction (``EnforceUniformVoxelSize``,
        tagged_object_occupancy_map.hpp:118)."""
        if not self.has_uniform_voxel_size:
            raise ValueError(
                "this container requires a uniform voxel size; got "
                f"voxel_sizes={self.voxel_sizes}")
        return self

    def with_counts(self, counts) -> "GridSpec":
        return GridSpec(tuple(int(c) for c in counts), self.resolution,
                        voxel_sizes=self.voxel_sizes)

    # -- index math (pure, jit/vmap friendly) ------------------------------

    def grid_index_to_location_in_grid_frame(self, index,
                                             dtype=jnp.float32) -> Array:
        """Cell-center location in grid frame for integer index [..., 3].

        ``dtype`` selects the scalar type of the result (float64 callers —
        e.g. queries against a ``SignedDistanceField<double>`` — pass their
        field dtype so cell centers don't round through float32)."""
        idx = jnp.asarray(index)
        dt = jnp.dtype(dtype)
        # One path for uniform and per-axis sizes: multiplying by a
        # vector of equal entries is bit-identical to the scalar multiply.
        sizes = jnp.asarray(self.voxel_sizes, dt)
        return (idx.astype(dt) + dt.type(0.5)) * sizes

    def location_in_grid_frame_to_grid_index(self, p_grid) -> Array:
        """floor(p / voxel size) per axis; may be out of bounds. [..., 3]."""
        p = jnp.asarray(p_grid)
        # Force a float divide: integer-typed points would truncate the
        # resolution (0 for sub-unit resolutions) and emit garbage indices.
        if not jnp.issubdtype(p.dtype, jnp.floating):
            p = p.astype(jnp.float32)
        sizes = jnp.asarray(self.voxel_sizes, p.dtype)
        return jnp.floor(p[..., :3] / sizes).astype(jnp.int32)

    def check_grid_index_in_bounds(self, index) -> Array:
        idx = jnp.asarray(index)
        counts = jnp.asarray(self.counts, dtype=idx.dtype)
        return jnp.all((idx >= 0) & (idx < counts), axis=-1)

    def flat_index(self, index) -> Array:
        """Row-major (x-major, z-fastest) flat index — matches the reference's
        x/y/z loop nesting (e.g. topology_computation.hpp:167-173)."""
        idx = jnp.asarray(index)
        ny, nz = self.counts[1], self.counts[2]
        return (idx[..., 0] * (ny * nz) + idx[..., 1] * nz + idx[..., 2])

    def unflatten_index(self, flat) -> Array:
        f = jnp.asarray(flat)
        ny, nz = self.counts[1], self.counts[2]
        x = f // (ny * nz)
        rem = f % (ny * nz)
        return jnp.stack([x, rem // nz, rem % nz], axis=-1).astype(jnp.int32)


# -- world-frame helpers (need the origin transform leaf) -------------------


def location_to_grid_index(spec: GridSpec, inverse_origin_transform: Array,
                           p_world) -> Array:
    """World location -> integer grid index (maybe out of bounds)."""
    p_grid = transforms.apply_isometry(inverse_origin_transform,
                                       jnp.asarray(p_world)[..., :3])
    return spec.location_in_grid_frame_to_grid_index(p_grid)


def grid_index_to_location(spec: GridSpec, origin_transform: Array,
                           index) -> Array:
    """Integer grid index -> world cell-center location."""
    p_grid = spec.grid_index_to_location_in_grid_frame(index)
    return transforms.apply_isometry(origin_transform, p_grid)


def check_location_in_bounds(spec: GridSpec, inverse_origin_transform: Array,
                             p_world) -> Array:
    idx = location_to_grid_index(spec, inverse_origin_transform, p_world)
    return spec.check_grid_index_in_bounds(idx)


def get_index_values(data: Array, index, oob_value) -> Array:
    """Gather ``data[index]`` with the grid's out-of-bounds value semantics.

    ``index`` is ``[..., 3]``; any out-of-bounds lane returns ``oob_value``
    (mirrors ``VoxelGridBase::GetIndexImmutable`` returning the OOB cell).
    """
    idx = jnp.asarray(index)
    counts = jnp.asarray(data.shape[:3], dtype=idx.dtype)
    in_bounds = jnp.all((idx >= 0) & (idx < counts), axis=-1)
    safe = jnp.clip(idx, 0, counts - 1)
    gathered = data[safe[..., 0], safe[..., 1], safe[..., 2]]
    oob = jnp.asarray(oob_value, dtype=data.dtype)
    return jnp.where(in_bounds, gathered, oob)
