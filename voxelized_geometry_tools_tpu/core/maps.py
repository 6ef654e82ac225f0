"""Voxel map containers: the four occupancy cell layouts + the SDF container.

Accelerator-native redesign of the reference's map classes:

* ``OccupancyMap``                         (occupancy_map.hpp:65-217)
* ``OccupancyComponentMap``                (occupancy_component_map.hpp:29-315)
* ``TaggedObjectOccupancyMap``             (tagged_object_occupancy_map.hpp:29-413)
* ``TaggedObjectOccupancyComponentMap``    (tagged_object_occupancy_component_map.hpp)
* ``SignedDistanceField<ScalarType>``      (signed_distance_field.hpp:193-1232)

Instead of a C++ class hierarchy with per-cell atomics, each map is a frozen
dataclass registered as a JAX pytree: *struct-of-arrays* channels of shape
``[nx, ny, nz]`` plus a ``[4, 4]`` origin transform leaf, with the static
:class:`~.grid.GridSpec` and frame string as pytree metadata. All mutation is
functional (``dataclasses.replace``) and every channel op jits; lock-free
atomic cells are unnecessary because parallel writes become scatter-adds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import transforms
from .grid import GridSpec

Array = jnp.ndarray

# Occupancy value conventions shared with the reference: 0.0 = free,
# 0.5 = unknown, 1.0 = filled (README.md:1-2; occupancy_map.cpp:231-242).
FREE = 0.0
UNKNOWN = 0.5
FILLED = 1.0


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields))
    return cls


def _default_transform(origin_transform, dtype=jnp.float32) -> Array:
    """Normalize an origin transform; ``dtype`` follows the map's scalar
    type (a float64 SDF keeps a float64 origin — the f32 default would
    silently destroy translation precision the double-parity path promises
    to keep). Concrete inputs are validated as ISOMETRIES: the rigid-body
    inverse used throughout (transforms.invert_isometry, R^T) is wrong for
    scaled/sheared matrices, which the reference's Isometry3d type cannot
    even represent — reject them instead of silently reading the wrong
    voxels. Traced inputs (e.g. optimized camera-rig transforms inside
    jit) skip the check."""
    if origin_transform is None:
        return jnp.eye(4, dtype=dtype)
    t = jnp.asarray(origin_transform, dtype=dtype)
    if t.shape != (4, 4):
        raise ValueError(f"origin_transform must be [4, 4], got {t.shape}")
    if not isinstance(t, jax.core.Tracer):
        m = np.asarray(t, np.float64)
        if (not np.allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3), atol=1e-3)
                or not np.allclose(m[3], (0.0, 0.0, 0.0, 1.0), atol=1e-5)):
            raise ValueError(
                "origin_transform must be an isometry (orthonormal "
                "rotation + translation); the rigid-body inverse used for "
                "world<->grid transforms assumes R^-1 = R^T")
    return t


def _full(spec: GridSpec, value, dtype) -> Array:
    # Every reference map class enforces a uniform voxel size on construction
    # (EnforceUniformVoxelSize, tagged_object_occupancy_map.hpp:118);
    # non-uniform GridSpecs are an L1 capability only.
    spec.enforce_uniform_voxel_size()
    return jnp.full(spec.counts, value, dtype=dtype)


class _MapBase:
    """Shared geometry helpers for all map dataclasses."""

    spec: GridSpec
    origin_transform: Array

    @property
    def resolution(self) -> float:
        return self.spec.resolution

    @property
    def counts(self):
        return self.spec.counts

    @property
    def num_total_voxels(self) -> int:
        return self.spec.num_total

    def inverse_origin_transform(self) -> Array:
        return transforms.invert_isometry(self.origin_transform)

    def location_to_grid_index(self, p_world) -> Array:
        p_grid = transforms.apply_isometry(
            self.inverse_origin_transform(), jnp.asarray(p_world)[..., :3])
        return self.spec.location_in_grid_frame_to_grid_index(p_grid)

    def grid_index_to_location(self, index) -> Array:
        return transforms.apply_isometry(
            self.origin_transform,
            self.spec.grid_index_to_location_in_grid_frame(index))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    # -- cell-level access (the OO get/set surface of the reference's
    # VoxelGridBase: GetIndexImmutable / SetIndex / GetLocationImmutable /
    # SetLocation, batched and functional) ---------------------------------

    def _channel_names(self):
        return [f.name for f in dataclasses.fields(self)
                if f.name not in ("origin_transform",)
                and not f.metadata.get("static", False)
                and getattr(self, f.name).ndim == 3]

    def _get_cells(self, index):
        """Base cell query: (dict of per-channel values, valid mask).
        Out-of-bounds lanes return the nearest EDGE cell's value (indices
        clamp per axis) with ``valid=False`` — payloads of invalid lanes
        are meaningless; test the mask (query-object semantics of
        ``GetIndexImmutable``)."""
        idx = jnp.asarray(index)
        valid = self.spec.check_grid_index_in_bounds(idx)
        safe = jnp.clip(idx, 0, jnp.asarray(self.spec.counts) - 1)
        values = {name: getattr(self, name)[safe[..., 0], safe[..., 1],
                                            safe[..., 2]]
                  for name in self._channel_names()}
        return values, valid

    def get_index(self, index):
        """Cell channels at integer indices ``[..., 3]`` -> (dict of
        per-channel values, valid mask). Note: ``SignedDistanceField``
        overrides THIS method with distance-value semantics (its
        ``GetIndexImmutable`` returns the stored distance with the OOB
        value); ``get_location`` keeps the (dict, valid) contract on every
        map type."""
        return self._get_cells(index)

    def get_location(self, p_world):
        """Cell channels at world locations ``[..., 3|4]``
        (``GetLocationImmutable{3d,4d}``). Always returns the
        ``(dict, valid)`` base contract, on every map type."""
        return self._get_cells(self.location_to_grid_index(
            jnp.asarray(p_world)[..., :3]))

    def set_index(self, index, **channel_values):
        """Functional ``SetIndex``: returns a new map with the given channel
        values written at integer indices ``[..., 3]`` (out-of-bounds lanes
        dropped via scatter mode='drop' — clipping them would race valid
        writes to the clipped-onto cell). Component/segment caches are
        invalidated like the reference's OnMutableAccess hooks. Raises on a
        locked :class:`SignedDistanceField` (the reference refuses mutable
        access while locked; unlock first)."""
        if getattr(self, "locked", False):
            raise ValueError(
                "Cannot mutate a locked SignedDistanceField; unlock() first")
        idx = jnp.asarray(index)
        # Negative indices would wrap NumPy-style before the drop check;
        # push them past the upper bound so mode='drop' discards them too.
        counts = jnp.asarray(self.spec.counts, idx.dtype)
        idx = jnp.where(idx < 0, counts, idx)
        updates = {}
        names = self._channel_names()
        for name, value in channel_values.items():
            if name not in names:
                raise ValueError(f"Unknown channel {name!r}")
            chan = getattr(self, name)
            value = jnp.asarray(value, chan.dtype)
            value = jnp.broadcast_to(value, idx.shape[:-1])
            updates[name] = chan.at[
                idx[..., 0], idx[..., 1], idx[..., 2]].set(
                    value, mode="drop")
        for flag in ("components_valid", "spatial_segments_valid"):
            if hasattr(self, flag):
                updates[flag] = False
        return self.replace(**updates)

    def set_location(self, p_world, **channel_values):
        """Functional ``SetLocation{3d,4d}``."""
        return self.set_index(
            self.location_to_grid_index(jnp.asarray(p_world)[..., :3]),
            **channel_values)


@dataclasses.dataclass(frozen=True)
class OccupancyMap(_MapBase):
    """Dense float occupancy grid (occupancy_map.hpp:65-217)."""

    origin_transform: Array
    occupancy: Array  # f32 [nx, ny, nz]
    spec: GridSpec = dataclasses.field(metadata=dict(static=True))
    frame: str = dataclasses.field(default="", metadata=dict(static=True))

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE) -> "OccupancyMap":
        return OccupancyMap(
            origin_transform=_default_transform(origin_transform),
            occupancy=_full(spec, default_occupancy, jnp.float32),
            spec=spec, frame=frame)


OccupancyMap = _register(
    OccupancyMap, ["origin_transform", "occupancy"], ["spec", "frame"])


@dataclasses.dataclass(frozen=True)
class OccupancyComponentMap(_MapBase):
    """Occupancy + cached per-voxel connected-component labels
    (occupancy_component_map.hpp:29-315). ``components_valid`` mirrors the
    reference's cache invalidation: any functional update to ``occupancy``
    should go through :meth:`set_occupancy` which clears the flag."""

    origin_transform: Array
    occupancy: Array  # f32 [nx, ny, nz]
    component: Array  # u32 [nx, ny, nz]
    number_of_components: Array  # u32 scalar
    spec: GridSpec = dataclasses.field(metadata=dict(static=True))
    frame: str = dataclasses.field(default="", metadata=dict(static=True))
    components_valid: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE) -> "OccupancyComponentMap":
        return OccupancyComponentMap(
            origin_transform=_default_transform(origin_transform),
            occupancy=_full(spec, default_occupancy, jnp.float32),
            component=_full(spec, 0, jnp.uint32),
            number_of_components=jnp.uint32(0),
            spec=spec, frame=frame, components_valid=False)

    def set_occupancy(self, occupancy: Array) -> "OccupancyComponentMap":
        return self.replace(occupancy=occupancy, components_valid=False)


OccupancyComponentMap = _register(
    OccupancyComponentMap,
    ["origin_transform", "occupancy", "component", "number_of_components"],
    ["spec", "frame", "components_valid"])


@dataclasses.dataclass(frozen=True)
class TaggedObjectOccupancyMap(_MapBase):
    """Occupancy + semantic object id (tagged_object_occupancy_map.hpp)."""

    origin_transform: Array
    occupancy: Array  # f32 [nx, ny, nz]
    object_id: Array  # u32 [nx, ny, nz]
    spec: GridSpec = dataclasses.field(metadata=dict(static=True))
    frame: str = dataclasses.field(default="", metadata=dict(static=True))

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE,
               default_object_id: int = 0) -> "TaggedObjectOccupancyMap":
        return TaggedObjectOccupancyMap(
            origin_transform=_default_transform(origin_transform),
            occupancy=_full(spec, default_occupancy, jnp.float32),
            object_id=_full(spec, default_object_id, jnp.uint32),
            spec=spec, frame=frame)


TaggedObjectOccupancyMap = _register(
    TaggedObjectOccupancyMap,
    ["origin_transform", "occupancy", "object_id"], ["spec", "frame"])


@dataclasses.dataclass(frozen=True)
class TaggedObjectOccupancyComponentMap(_MapBase):
    """Richest cell layout: occupancy + object id + component + spatial
    segment (tagged_object_occupancy_component_map.hpp:80-577)."""

    origin_transform: Array
    occupancy: Array  # f32 [nx, ny, nz]
    object_id: Array  # u32 [nx, ny, nz]
    component: Array  # u32 [nx, ny, nz]
    spatial_segment: Array  # u32 [nx, ny, nz]
    number_of_components: Array  # u32 scalar
    number_of_spatial_segments: Array  # u32 scalar
    spec: GridSpec = dataclasses.field(metadata=dict(static=True))
    frame: str = dataclasses.field(default="", metadata=dict(static=True))
    components_valid: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    spatial_segments_valid: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE, default_object_id: int = 0
               ) -> "TaggedObjectOccupancyComponentMap":
        return TaggedObjectOccupancyComponentMap(
            origin_transform=_default_transform(origin_transform),
            occupancy=_full(spec, default_occupancy, jnp.float32),
            object_id=_full(spec, default_object_id, jnp.uint32),
            component=_full(spec, 0, jnp.uint32),
            spatial_segment=_full(spec, 0, jnp.uint32),
            number_of_components=jnp.uint32(0),
            number_of_spatial_segments=jnp.uint32(0),
            spec=spec, frame=frame,
            components_valid=False, spatial_segments_valid=False)

    def set_occupancy(self, occupancy: Array
                      ) -> "TaggedObjectOccupancyComponentMap":
        return self.replace(occupancy=occupancy, components_valid=False,
                            spatial_segments_valid=False)


TaggedObjectOccupancyComponentMap = _register(
    TaggedObjectOccupancyComponentMap,
    ["origin_transform", "occupancy", "object_id", "component",
     "spatial_segment", "number_of_components", "number_of_spatial_segments"],
    ["spec", "frame", "components_valid", "spatial_segments_valid"])


@dataclasses.dataclass(frozen=True)
class SignedDistanceField(_MapBase):
    """Dense signed-distance grid with locked min/max cache
    (signed_distance_field.hpp:193-1232). ``oob_value`` is the value returned
    for out-of-bounds queries (SignedDistanceFieldGenerationParameters
    default: +inf, signed_distance_field.hpp:1244-1245)."""

    origin_transform: Array
    distances: Array  # f32 [nx, ny, nz]
    minimum: Array  # f32 scalar (valid when locked)
    maximum: Array  # f32 scalar (valid when locked)
    spec: GridSpec = dataclasses.field(metadata=dict(static=True))
    frame: str = dataclasses.field(default="", metadata=dict(static=True))
    locked: bool = dataclasses.field(default=False, metadata=dict(static=True))
    oob_value: float = dataclasses.field(
        default=float("inf"), metadata=dict(static=True))

    @staticmethod
    def create(spec: GridSpec, distances: Array, origin_transform=None,
               frame: str = "", oob_value: float = float("inf"),
               locked: bool = False, dtype=None) -> "SignedDistanceField":
        """``dtype`` selects the scalar type — the analogue of the
        reference's ``SignedDistanceField<float>`` / ``<double>`` explicit
        instantiations (signed_distance_field.hpp:1268-1269). Default
        float32; float64 requires ``jax_enable_x64`` (raises otherwise
        rather than silently downcasting)."""
        # The reference SDF enforces a uniform voxel size on construction
        # (signed_distance_field.hpp:612-615); queries and EDT scaling mix
        # per-axis index math with the scalar resolution, so a non-uniform
        # spec would silently return wrong distances.
        spec.enforce_uniform_voxel_size()
        dtype = jnp.float32 if dtype is None else dtype
        values = jnp.asarray(distances).astype(dtype)
        if jnp.dtype(dtype) == jnp.float64 and values.dtype != jnp.float64:
            raise ValueError(
                "float64 SDFs require jax_enable_x64 "
                "(jax.config.update('jax_enable_x64', True))")
        if tuple(values.shape) != tuple(spec.shape):
            # JAX gathers clamp out-of-range indices, so a spec/data shape
            # mismatch would return silently wrong values, not errors.
            raise ValueError(
                f"distances shape {values.shape} != spec counts "
                f"{spec.shape}")
        sdf = SignedDistanceField(
            origin_transform=_default_transform(origin_transform,
                                                values.dtype),
            distances=values,
            minimum=jnp.zeros((), values.dtype),
            maximum=jnp.zeros((), values.dtype),
            spec=spec, frame=frame, locked=False, oob_value=float(oob_value))
        return sdf.lock() if locked else sdf

    def lock(self) -> "SignedDistanceField":
        """Cache min/max and freeze (signed_distance_field.hpp:783-787)."""
        return self.replace(minimum=jnp.min(self.distances),
                            maximum=jnp.max(self.distances), locked=True)

    def unlock(self) -> "SignedDistanceField":
        return dataclasses.replace(self, locked=False)

    def replace(self, **kwargs):
        """Functional update. Replacing ``distances`` on a LOCKED field
        unlocks the result: the cached min/max no longer describes the new
        values, and silently keeping ``locked=True`` would let
        ``get_minimum_maximum`` return stale bounds (the idiom
        ``sdf.replace(distances=d)`` threads arrays through jit everywhere;
        recomputing the cache there would bill two full-grid reductions to
        every render step). Re-``lock()`` explicitly if the cache is
        wanted."""
        if ("distances" in kwargs and self.locked
                and not {"minimum", "maximum", "locked"} & kwargs.keys()):
            kwargs["locked"] = False
        return dataclasses.replace(self, **kwargs)

    def get_minimum_maximum(self):
        if self.locked:
            return self.minimum, self.maximum
        return jnp.min(self.distances), jnp.max(self.distances)

    def get_index(self, index) -> Array:
        """Distance at integer index [..., 3] with OOB semantics."""
        from .grid import get_index_values
        return get_index_values(self.distances, index, self.oob_value)


SignedDistanceField = _register(
    SignedDistanceField,
    ["origin_transform", "distances", "minimum", "maximum"],
    ["spec", "frame", "locked", "oob_value"])
