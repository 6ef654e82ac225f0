"""Visualization export: the RViz CUBE_LIST payloads without the ROS types.

Accelerator-native equivalent of the reference ROS interface's display exporters
(/root/reference/include/voxelized_geometry_tools/ros_interface.hpp:92-411 and
src/.../ros_interface.cpp:41-1065): every exporter returns a
:class:`VoxelMarker` — grid-frame cell positions + RGBA colors + the marker
pose/scale — which is exactly the data content of a
``visualization_msgs::Marker`` CUBE_LIST and trivially convertible to one by a
thin ROS shim (kept out of this package to avoid a ROS dependency).

Cells with alpha == 0 are dropped, matching ExportVoxelGridToRViz
(ros_interface.hpp:130-141).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

Rgba = tuple

# A deterministic 21-color palette (+ reserved index 0) standing in for
# common_robotics_utilities::color_builder::LookupUniqueColor; component 0
# maps to transparent black like the reference's "no component" color.
_UNIQUE_COLORS = np.array([
    (0.0, 0.0, 0.0),  # 0 -> unused (alpha forced to 0)
    (0.8, 0.1, 0.1), (0.1, 0.8, 0.1), (0.1, 0.1, 0.8), (0.8, 0.8, 0.1),
    (0.8, 0.1, 0.8), (0.1, 0.8, 0.8), (0.5, 0.3, 0.0), (1.0, 0.5, 0.0),
    (0.5, 0.0, 1.0), (0.0, 0.5, 1.0), (0.6, 0.6, 0.6), (0.3, 0.0, 0.0),
    (0.0, 0.3, 0.0), (0.0, 0.0, 0.3), (0.9, 0.7, 0.7), (0.7, 0.9, 0.7),
    (0.7, 0.7, 0.9), (0.4, 0.2, 0.6), (0.2, 0.6, 0.4), (0.9, 0.4, 0.6),
    (0.4, 0.9, 0.2),
], dtype=np.float32)  # 22 entries: index 0 reserved, 1..21 distinct
# (the reference's single-segment exporter switches to hot-to-cold only at
# >= 22 segments, ros_interface.cpp:1081 — so 21 palette slots must exist)


def _pose_translation_quaternion(pose):
    """Shared marker-pose conversion (one definition for both marker
    kinds)."""
    from ..core.transforms import isometry_to_pose
    return isometry_to_pose(pose)


@dataclasses.dataclass
class VoxelMarker:
    """Data content of a CUBE_LIST marker."""
    frame: str
    pose: np.ndarray  # [4, 4] marker pose = grid origin transform
    scale: np.ndarray  # [3] voxel sizes
    positions: np.ndarray  # [N, 3] grid-frame cell centers
    colors: np.ndarray  # [N, 4] RGBA
    ns: str = ""  # marker namespace (``Marker.ns`` strings of the reference)

    @property
    def num_cells(self) -> int:
        return self.positions.shape[0]

    def pose_translation_quaternion(self):
        """The marker pose as ``(translation[3], quaternion_wxyz[4])`` —
        what a ROS shim puts in ``Marker.pose``
        (``EigenIsometry3dToGeometryPose``, ros_interface.hpp:116-121)."""
        return _pose_translation_quaternion(self.pose)


def lookup_component_color(component: int, alpha: float = 1.0) -> np.ndarray:
    """``LookupComponentColor`` (ros_interface.hpp:85-90)."""
    idx = int(component) % len(_UNIQUE_COLORS)
    rgb = _UNIQUE_COLORS[idx]
    a = 0.0 if component == 0 else alpha
    return np.array([rgb[0], rgb[1], rgb[2], a], dtype=np.float32)


def export_voxel_grid(spec, origin_transform, frame: str,
                      color_fn: Callable[[np.ndarray], np.ndarray],
                      *channels, ns: str = "") -> VoxelMarker:
    """Generic exporter (``ExportVoxelGridToRViz``, ros_interface.hpp:92-148).

    ``color_fn`` maps per-voxel channel values (numpy arrays of shape
    ``[nx,ny,nz]``) to RGBA ``[nx,ny,nz,4]``; zero-alpha cells are dropped.
    """
    chans = [np.asarray(c) for c in channels]
    rgba = np.asarray(color_fn(*chans), dtype=np.float32)
    keep = rgba[..., 3] > 0.0
    idx = np.argwhere(keep)
    # Marker scale and cell centers honor per-axis voxel sizes — the
    # reference's generic exporter uses VoxelSizes()/
    # GridIndexToLocationInGridFrame (ros_interface.hpp:120-127), and
    # non-uniform grids are an L1 capability consumed only here.
    sizes = np.asarray(spec.voxel_sizes, np.float64)
    positions = (idx.astype(np.float64) + 0.5) * sizes
    return VoxelMarker(
        frame=frame, pose=np.asarray(origin_transform, np.float64),
        scale=sizes.copy(), positions=positions,
        colors=rgba[keep], ns=ns)


def export_occupancy_for_display(
        omap, collision_color=(1.0, 0.0, 0.0, 0.5),
        free_color=(0.0, 1.0, 0.0, 0.5),
        unknown_color=(1.0, 1.0, 0.0, 0.5)) -> VoxelMarker:
    """``ExportForDisplay`` occupancy coloring (ros_interface.cpp:41-70):
    filled (>0.5) / free (<0.5) / unknown (==0.5)."""

    def color(occ):
        # Start from the unknown color so non-finite occupancies (which
        # match none of the three masks) never leave uninitialized RGBA.
        rgba = np.full(occ.shape + (4,), unknown_color, np.float32)
        rgba[occ > 0.5] = collision_color
        rgba[occ < 0.5] = free_color
        return rgba

    return export_voxel_grid(omap.spec, omap.origin_transform, omap.frame,
                             color, omap.occupancy, ns="occupancy_map")


_NO_COLOR = (0.0, 0.0, 0.0, 0.0)


def export_for_separate_display(
        omap, collision_color=(1.0, 0.0, 0.0, 0.5),
        free_color=(0.0, 1.0, 0.0, 0.5),
        unknown_color=(1.0, 1.0, 0.0, 0.5)) -> list:
    """``ExportForSeparateDisplay`` (ros_interface.hpp:495-498 and the
    per-type variants): the MarkerArray analogue — three markers splitting
    the map into collision-only / free-only / unknown-only cells, namespaced
    like the reference (ros_interface.cpp:83-89)."""
    collision = export_occupancy_for_display(
        omap, collision_color, _NO_COLOR, _NO_COLOR)
    collision.ns = "collision_only"
    free = export_occupancy_for_display(
        omap, _NO_COLOR, free_color, _NO_COLOR)
    free.ns = "free_only"
    unknown = export_occupancy_for_display(
        omap, _NO_COLOR, _NO_COLOR, unknown_color)
    unknown.ns = "unknown_only"
    return [collision, free, unknown]


def export_surfaces_for_display(omap, surface_mask,
                                surface_color=(1.0, 0.0, 0.0, 1.0)
                                ) -> VoxelMarker:
    """``ExportSurfacesForDisplay``: only surface cells, one color."""

    def color(occ, surf):
        rgba = np.zeros(occ.shape + (4,), np.float32)
        rgba[surf.astype(bool)] = surface_color
        return rgba

    return export_voxel_grid(omap.spec, omap.origin_transform, omap.frame,
                             color, omap.occupancy, surface_mask,
                             ns="occupancy_surfaces")


def _surface_mask_or_default(omap, surface_mask):
    if surface_mask is not None:
        return np.asarray(surface_mask).astype(bool)
    from ..ops import topology
    return np.asarray(topology.is_surface_index(omap.occupancy))


def export_classified_surfaces_for_display(
        omap, collision_color=(1.0, 0.0, 0.0, 0.5),
        free_color=(0.0, 1.0, 0.0, 0.5),
        unknown_color=(1.0, 1.0, 0.0, 0.5),
        surface_mask=None) -> VoxelMarker:
    """``ExportSurfacesForDisplay(map, collision, free, unknown)``
    (ros_interface.cpp:96-134): surface cells colored by occupancy class,
    everything else transparent. ``surface_mask=None`` computes the
    26-neighbor occupancy surface (``IsSurfaceIndex``) like the reference."""
    surf = _surface_mask_or_default(omap, surface_mask)

    def color(occ):
        rgba = np.zeros(occ.shape + (4,), np.float32)
        rgba[surf & (occ > 0.5)] = collision_color
        rgba[surf & (occ < 0.5)] = free_color
        rgba[surf & (occ == 0.5)] = unknown_color
        return rgba

    return export_voxel_grid(omap.spec, omap.origin_transform, omap.frame,
                             color, omap.occupancy, ns="occupancy_surfaces")


def export_surfaces_for_separate_display(
        omap, collision_color=(1.0, 0.0, 0.0, 0.5),
        free_color=(0.0, 1.0, 0.0, 0.5),
        unknown_color=(1.0, 1.0, 0.0, 0.5),
        surface_mask=None) -> list:
    """``ExportSurfacesForSeparateDisplay`` (ros_interface.hpp:507-510):
    three markers splitting the surface cells by occupancy class
    (ros_interface.cpp:150-158 namespaces)."""
    surf = _surface_mask_or_default(omap, surface_mask)
    collision = export_classified_surfaces_for_display(
        omap, collision_color, _NO_COLOR, _NO_COLOR, surface_mask=surf)
    collision.ns = "collision_surfaces_only"
    free = export_classified_surfaces_for_display(
        omap, _NO_COLOR, free_color, _NO_COLOR, surface_mask=surf)
    free.ns = "free_surfaces_only"
    unknown = export_classified_surfaces_for_display(
        omap, _NO_COLOR, _NO_COLOR, unknown_color, surface_mask=surf)
    unknown.ns = "unknown_surfaces_only"
    return [collision, free, unknown]


def _object_rgba(object_id: np.ndarray, object_color_map) -> np.ndarray:
    """Per-object RGBA lookup. With a color map, mapped ids get their color
    and unmapped ids are transparent; with none, ids take palette colors
    (id 0 transparent). NOTE: the reference's ``specifies_colors =
    object_color_map.empty()`` (ros_interface.cpp:584) inverts its own
    intent — an EMPTY map would look ids up in the empty map and hide
    everything while a non-empty map would be ignored; this implements the
    documented intent (hpp:611-614 default argument) instead."""
    obj = np.asarray(object_id).astype(np.int64)
    if object_color_map:
        max_id = max(int(k) for k in object_color_map)
        table = np.zeros((max_id + 2, 4), np.float32)  # default transparent
        for k, rgba in object_color_map.items():
            table[int(k)] = np.asarray(rgba, np.float32)
        return table[np.minimum(obj, max_id + 1)]
    palette = np.stack([lookup_component_color(c)
                        for c in range(len(_UNIQUE_COLORS))])
    rgba = palette[obj % len(_UNIQUE_COLORS)]
    rgba[obj == 0, 3] = 0.0
    return rgba


def export_tagged_objects_for_display(omap,
                                      object_color_map=None) -> VoxelMarker:
    """``ExportForDisplay(map, object_color_map)`` for the tagged maps
    (ros_interface.hpp:611-614, 667-671): every cell colored by its object
    id — explicit colors from the map (unmapped ids transparent) or unique
    palette colors when no map is given (id 0 transparent)."""
    return export_voxel_grid(
        omap.spec, omap.origin_transform, omap.frame,
        lambda obj: _object_rgba(obj, object_color_map), omap.object_id,
        ns="occupancy_map_objects")


def export_tagged_object_surfaces_for_display(
        omap, object_color_map=None, surface_mask=None) -> VoxelMarker:
    """``ExportSurfacesForDisplay(map, object_color_map)``
    (ros_interface.cpp:681-725): object-id coloring restricted to surface
    cells (26-neighbor ``IsSurfaceIndex`` when no mask is given)."""
    surf = _surface_mask_or_default(omap, surface_mask)

    def color(obj):
        rgba = _object_rgba(obj, object_color_map)
        rgba[~surf] = 0.0
        return rgba

    return export_voxel_grid(omap.spec, omap.origin_transform, omap.frame,
                             color, omap.object_id, ns="occupancy_surfaces")


def export_connected_components_for_display(
        omap, color_unknown_components: bool = True) -> VoxelMarker:
    """``ExportConnectedComponentsForDisplay(map, color_unknown_components)``
    (ros_interface.hpp:557-558, cpp:356-389): per-component unique colors;
    with ``color_unknown_components=False`` the components of UNKNOWN cells
    (occupancy == 0.5) are drawn opaque gray (0.5, 0.5, 0.5, 1.0) instead of
    their palette color."""

    def color(comp, occ):
        palette = np.stack([lookup_component_color(c)
                            for c in range(len(_UNIQUE_COLORS))])
        rgba = palette[comp.astype(np.int64) % len(_UNIQUE_COLORS)]
        rgba[comp == 0, 3] = 0.0
        if not color_unknown_components:
            rgba[occ == 0.5] = (0.5, 0.5, 0.5, 1.0)
        return rgba

    return export_voxel_grid(omap.spec, omap.origin_transform, omap.frame,
                             color, omap.component, omap.occupancy,
                             ns="connected_components")


def export_spatial_segments_for_display(omap) -> VoxelMarker:
    """All spatial segments, component-palette colored (convenience
    extension of ``ExportSpatialSegmentForDisplay``)."""

    def color(seg):
        palette = np.stack([lookup_component_color(c)
                            for c in range(len(_UNIQUE_COLORS))])
        rgba = palette[seg.astype(np.int64) % len(_UNIQUE_COLORS)]
        rgba[seg == 0, 3] = 0.0
        return rgba

    return export_voxel_grid(omap.spec, omap.origin_transform, omap.frame,
                             color, omap.spatial_segment,
                             ns="spatial_segments")


def interpolate_hot_to_cold(value: np.ndarray, low: float,
                            high: float) -> np.ndarray:
    """``color_builder::InterpolateHotToCold``: blue (cold, low) -> cyan ->
    green -> yellow -> red (hot, high); returns RGBA [..., 4], alpha 1."""
    v = np.clip((np.asarray(value, np.float64) - low)
                / max(high - low, 1e-300), 0.0, 1.0)
    # Piecewise over 4 bands (standard hot-to-cold map, hot at v=1).
    r = np.clip(4.0 * v - 2.0, 0.0, 1.0)
    g = np.where(v < 0.5, np.clip(4.0 * v, 0.0, 1.0),
                 np.clip(4.0 - 4.0 * v, 0.0, 1.0))
    b = np.clip(2.0 - 4.0 * v, 0.0, 1.0)
    return np.stack([r, g, b, np.ones_like(v)], axis=-1).astype(np.float32)


def export_spatial_segment_for_display(omap, object_id: int,
                                       spatial_segment: int) -> VoxelMarker:
    """``ExportSpatialSegmentForDisplay(map, object_id, spatial_segment)``
    (ros_interface.cpp:1065-1107): only the cells of ONE object's segment,
    palette-colored for <22 total segments, hot-to-cold interpolated
    otherwise. Raises if the spatial segments are stale (the reference's
    ``NumSpatialSegments().Value()`` throws in that state)."""
    if not getattr(omap, "spatial_segments_valid", True):
        raise ValueError(
            "spatial segments are stale; run update_spatial_segments first")
    num_segments = int(omap.number_of_spatial_segments)

    def color(seg, obj):
        in_segment = (obj == np.uint32(object_id)) & (
            seg == np.uint32(spatial_segment))
        if num_segments < 22:
            rgba_on = lookup_component_color(spatial_segment)
        else:
            rgba_on = interpolate_hot_to_cold(
                float(spatial_segment), 0.0, float(num_segments))
        rgba = np.zeros(seg.shape + (4,), np.float32)
        rgba[in_segment] = rgba_on
        return rgba

    return export_voxel_grid(
        omap.spec, omap.origin_transform, omap.frame,
        color, omap.spatial_segment, omap.object_id,
        ns=f"object_{object_id}_spatial_segment_{spatial_segment}")


def export_sdf_for_display(sdf, alpha: float = 0.5) -> VoxelMarker:
    """``ExportSDFForDisplay`` (ros_interface.hpp:332-381): distance-colored —
    blue outside scaled by +range, red inside scaled by -range."""
    distances = np.asarray(sdf.distances)
    finite = np.isfinite(distances)
    dmax = distances[finite & (distances > 0)].max(initial=1e-6)
    dmin = distances[finite & (distances < 0)].min(initial=-1e-6)

    def color(d):
        rgba = np.zeros(d.shape + (4,), np.float32)
        pos = d >= 0.0
        rgba[..., 2] = np.where(pos, np.clip(d / dmax, 0, 1), 0.0)
        rgba[..., 0] = np.where(~pos, np.clip(d / dmin, 0, 1), 0.0)
        rgba[..., 3] = alpha
        return rgba

    return export_voxel_grid(sdf.spec, sdf.origin_transform, sdf.frame,
                             color, sdf.distances, ns="sdf_distance")


def export_sdf_collision_only(sdf, collision_color=(1.0, 0.0, 0.0, 0.5)
                              ) -> VoxelMarker:
    """Collision-only SDF display (ros_interface.hpp:383-411)."""

    def color(d):
        rgba = np.zeros(d.shape + (4,), np.float32)
        rgba[d <= 0.0] = collision_color
        return rgba

    return export_voxel_grid(sdf.spec, sdf.origin_transform, sdf.frame,
                             color, sdf.distances, ns="sdf_collision")


def export_dsh_grid(dsh_map, color_fn: Callable[[np.ndarray], np.ndarray]
                    ) -> VoxelMarker:
    """Chunked sparse grid exporter
    (``ExportDynamicSpatialHashedVoxelGridToRViz``, ros_interface.hpp:
    258-328): walks every allocated chunk, emitting grid-frame cell centers
    for cells whose color has alpha > 0. ``color_fn`` maps a chunk's dense
    occupancy ``[cx,cy,cz]`` to RGBA ``[cx,cy,cz,4]``."""
    res = dsh_map.resolution
    counts = np.asarray(dsh_map.chunk_counts, np.int64)
    positions = []
    colors = []
    for region, data in dsh_map.chunk_items():
        rgba = np.asarray(color_fn(np.asarray(data)), np.float32)
        keep = rgba[..., 3] > 0.0
        idx = np.argwhere(keep)
        if idx.size == 0:
            continue
        base = np.asarray(region, np.int64) * counts
        positions.append((idx + base + 0.5) * res)
        colors.append(rgba[keep])
    if positions:
        positions = np.concatenate(positions, axis=0)
        colors = np.concatenate(colors, axis=0)
    else:
        positions = np.zeros((0, 3), np.float64)
        colors = np.zeros((0, 4), np.float32)
    return VoxelMarker(
        frame=dsh_map.frame,
        pose=np.asarray(dsh_map.origin_transform, np.float64),
        scale=np.full(3, res), positions=positions, colors=colors)


def export_dsh_occupancy_for_display(
        dsh_map, collision_color=(1.0, 0.0, 0.0, 0.5),
        free_color=(0.0, 1.0, 0.0, 0.0),
        unknown_color=(1.0, 1.0, 0.0, 0.0)) -> VoxelMarker:
    """DSH occupancy coloring: occupancy > 0.5 collision, < 0.5 free,
    == 0.5 unknown (ros_interface.cpp occupancy coloring convention)."""
    collision = np.asarray(collision_color, np.float32)
    free = np.asarray(free_color, np.float32)
    unknown = np.asarray(unknown_color, np.float32)

    def color(occ):
        rgba = np.empty(occ.shape + (4,), np.float32)
        rgba[:] = unknown
        rgba[occ > 0.5] = collision
        rgba[occ < 0.5] = free
        return rgba

    return export_dsh_grid(dsh_map, color)


def export_dsh_for_separate_display(
        dsh_map, collision_color=(1.0, 0.0, 0.0, 0.5),
        free_color=(0.0, 1.0, 0.0, 0.5),
        unknown_color=(1.0, 1.0, 0.0, 0.5)) -> list:
    """``ExportForSeparateDisplay(DynamicSpatialHashedOccupancyMap, ...)``
    (ros_interface.hpp:589-592, cpp:501-507): three markers splitting the
    allocated cells into collision / free / unknown."""
    collision = export_dsh_occupancy_for_display(
        dsh_map, collision_color, _NO_COLOR, _NO_COLOR)
    collision.ns = "collision_only"
    free = export_dsh_occupancy_for_display(
        dsh_map, _NO_COLOR, free_color, _NO_COLOR)
    free.ns = "free_only"
    unknown = export_dsh_occupancy_for_display(
        dsh_map, _NO_COLOR, _NO_COLOR, unknown_color)
    unknown.ns = "unknown_only"
    return [collision, free, unknown]


def export_voxel_grid_indices(spec, origin_transform, frame: str,
                              indices, color) -> VoxelMarker:
    """Single-color marker for an explicit index list
    (``ExportVoxelGridIndicesToRViz``, ros_interface.hpp:212-256)."""
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    rgba = np.broadcast_to(np.asarray(color, np.float32), (idx.shape[0], 4))
    keep = rgba[:, 3] > 0.0
    sizes = np.asarray(spec.voxel_sizes, np.float64)
    return VoxelMarker(
        frame=frame, pose=np.asarray(origin_transform, np.float64),
        scale=sizes.copy(),
        positions=(idx[keep].astype(np.float64) + 0.5) * sizes,
        colors=np.ascontiguousarray(rgba[keep]))


def export_voxel_grid_index_map(spec, origin_transform, frame: str,
                                index_color_map) -> VoxelMarker:
    """Per-index-color marker for a ``{(x, y, z): rgba}`` mapping
    (convenience generalization of ``ExportVoxelGridIndexMapToRViz``,
    ros_interface.hpp:150-210 — the reference's exact uint8-flag signature
    is :func:`export_index_map_for_display`)."""
    if index_color_map:
        idx = np.asarray(list(index_color_map.keys()), np.int64)
        rgba = np.asarray(list(index_color_map.values()), np.float32)
    else:
        idx = np.zeros((0, 3), np.int64)
        rgba = np.zeros((0, 4), np.float32)
    keep = rgba[:, 3] > 0.0 if rgba.size else np.zeros(0, bool)
    sizes = np.asarray(spec.voxel_sizes, np.float64)
    return VoxelMarker(
        frame=frame, pose=np.asarray(origin_transform, np.float64),
        scale=sizes.copy(),
        positions=(idx[keep].astype(np.float64) + 0.5) * sizes,
        colors=np.ascontiguousarray(rgba[keep]))


def export_index_map_for_display(omap, index_map,
                                 surface_color=(1.0, 0.0, 0.0, 1.0)
                                 ) -> VoxelMarker:
    """``ExportIndexMapForDisplay(map, {GridIndex: uint8}, surface_color)``
    (ros_interface.hpp:639-649, cpp:166-183): the indices whose uint8 flag
    is nonzero, rendered in ONE color (the reference's surface-map display;
    feed it ``ops.topology.extract_surfaces`` output). Zero-alpha colors
    export an empty marker like the reference's ``cell_color.a > 0`` test."""
    indices = [k for k, flag in index_map.items() if int(flag) > 0]
    marker = export_voxel_grid_indices(
        omap.spec, omap.origin_transform, omap.frame, indices
        if indices else np.zeros((0, 3), np.int64), surface_color)
    marker.ns = "occupancy_map_surface"
    return marker


@dataclasses.dataclass
class TriangleMarker:
    """Data content of a TRIANGLE_LIST marker — the meshed counterpart of
    :class:`VoxelMarker` for surfaces extracted by
    :func:`..ops.isosurface.extract_isosurface` (an accelerator-native addition; the
    reference displays voxels only). ``points`` is ``[3*T, 3]`` world/grid
    positions, three consecutive rows per triangle, exactly the layout
    ``visualization_msgs::Marker.points`` expects for TRIANGLE_LIST."""
    frame: str
    pose: np.ndarray  # [4, 4] marker pose (identity if points are world)
    points: np.ndarray  # [3*T, 3]
    color: np.ndarray  # [4] single RGBA for the whole mesh
    ns: str = ""

    @property
    def num_triangles(self) -> int:
        return self.points.shape[0] // 3

    def pose_translation_quaternion(self):
        return _pose_translation_quaternion(self.pose)


def export_isosurface_for_display(iso_mesh, frame: str,
                                  color=(0.2, 0.6, 0.9, 1.0),
                                  ns: str = "isosurface",
                                  pose=None) -> TriangleMarker:
    """Pack an :class:`..ops.isosurface.IsoMesh` as a TRIANGLE_LIST marker,
    dropping invalid capacity rows and degenerate slivers.

    ``pose``: marker pose; pass the SDF's ``origin_transform`` for a mesh
    extracted with ``frame="grid"`` (identity default suits world-frame
    meshes — the positions already carry the transform). Raises on an
    overflowed (truncated) mesh like the weld/statistics consumers: a
    silently holed surface in the display is the worst failure mode.
    """
    if bool(iso_mesh.overflowed):
        raise ValueError(
            f"IsoMesh overflowed its capacity ({int(iso_mesh.num_triangles)}"
            f" > {iso_mesh.capacity}) — re-extract with more max_triangles")
    v = np.asarray(iso_mesh.vertices)[np.asarray(iso_mesh.valid)]
    if v.size:
        # Scale-relative sliver test (an absolute epsilon breaks at small
        # world units): area against squared longest edge.
        e = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                      v[:, 2] - v[:, 1]])
        edge2 = (e * e).sum(-1).max(axis=0)
        area2 = np.linalg.norm(np.cross(e[0], e[1]), axis=-1)
        v = v[area2 > 1e-9 * np.maximum(edge2, 1e-300)]
    return TriangleMarker(
        frame=frame,
        pose=(np.eye(4, dtype=np.float64) if pose is None
              else np.asarray(pose, np.float64)),
        points=np.ascontiguousarray(v.reshape(-1, 3).astype(np.float64)),
        color=np.asarray(color, np.float32), ns=ns)
