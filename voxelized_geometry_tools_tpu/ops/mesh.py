"""Triangle-mesh rasterization into voxel grids.

Accelerator-native redesign of the reference's rasterizer
(/root/reference/src/voxelized_geometry_tools/mesh_rasterizer.cpp). The
reference loops serially over the voxels in each triangle's AABB index range;
here every triangle gets a *static-size* candidate window (the max AABB index
extent over the mesh, computed host-side) and all (triangle, window-cell)
pairs are evaluated as one vmapped closest-point-on-triangle test, followed by
a single scatter-max into the occupancy channel.

Semantics matched to the reference:

* a voxel is filled iff the closest point on the triangle is within
  ``sqrt(3)/2 * resolution`` of the cell center (cpp:117-119, 182-183) — the
  same conservative approximation, including the float ``sqrt(3)`` threshold,
* only voxels whose index lies in ``[index(aabb_min), index(aabb_max)]`` are
  considered (cpp:141-153) — boundary cells outside that index range stay
  empty exactly as in mesh_rasterization_test.cpp:38-45,
* the candidate among the three edge segments is chosen by true
  distance-to-query (the reference compares the raw ``squaredNorm()`` of the
  candidate *points* — mesh_rasterizer.cpp:82-84 — an upstream quirk we do
  not reproduce; both choices agree on every reference test fixture).
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core import transforms
from ..core.grid import GridSpec
from ..core.maps import OccupancyMap, OccupancyComponentMap

Array = jnp.ndarray


def _closest_point_on_segment(a, b, q):
    """ClosestPointOnLineSegment (cpp:45-57)."""
    ab = b - a
    denom = jnp.maximum(jnp.sum(ab * ab, axis=-1), 1e-30)
    ratio = jnp.sum(ab * (q - a), axis=-1) / denom
    return a + ab * jnp.clip(ratio, 0.0, 1.0)[..., None]


def _point_projects_inside(v1, v2, v3, q):
    """PointProjectsInsideTriangle (cpp:26-43): three same-side tests with
    >= 0 so edges/vertices count as inside."""

    def same_side(a, b, p1, p2):
        ab = b - a
        c1 = jnp.cross(ab, p1 - a)
        c2 = jnp.cross(ab, p2 - a)
        return jnp.sum(c1 * c2, axis=-1) >= 0.0

    return (same_side(v1, v2, v3, q) & same_side(v2, v3, v1, q)
            & same_side(v3, v1, v2, q))


def closest_point_on_triangle(v1, v2, v3, normal, q):
    """CalcClosestPointOnTriangle (cpp:59-102) with true-distance edge
    selection (see module docstring)."""
    inside = _point_projects_inside(v1, v2, v3, q)
    # Project q to the triangle plane: q - (n.(q-v1)/|n|^2) n
    # (VectorRejection of the normal, cpp:68-72).
    n2 = jnp.maximum(jnp.sum(normal * normal, axis=-1), 1e-30)
    coeff = jnp.sum(normal * (q - v1), axis=-1) / n2
    projected = q - normal * coeff[..., None]

    c12 = _closest_point_on_segment(v1, v2, q)
    c23 = _closest_point_on_segment(v2, v3, q)
    c31 = _closest_point_on_segment(v3, v1, q)
    d12 = jnp.sum((c12 - q) ** 2, axis=-1)
    d23 = jnp.sum((c23 - q) ** 2, axis=-1)
    d31 = jnp.sum((c31 - q) ** 2, axis=-1)
    best_23_31 = jnp.where((d23 <= d31)[..., None], c23, c31)
    best_edge = jnp.where((
        (d12 <= d23) & (d12 <= d31))[..., None], c12, best_23_31)
    return jnp.where(inside[..., None], projected, best_edge)


@functools.partial(jax.jit, static_argnames=("spec", "window"))
def _rasterize_windows(spec: GridSpec, origin_transform: Array,
                       occupancy: Array, tri_vertices: Array,
                       min_indices: Array, max_indices: Array,
                       window: Tuple[int, int, int]) -> Array:
    """Evaluate all (triangle, window-cell) pairs and scatter-fill. Jitted
    (shape-specialized on the window) — the eager path dispatches ~50 ops
    through the device runtime per call, which dominates for small meshes."""
    wx, wy, wz = window
    offsets = jnp.stack(jnp.meshgrid(
        jnp.arange(wx), jnp.arange(wy), jnp.arange(wz),
        indexing="ij"), axis=-1).reshape(-1, 3).astype(jnp.int32)  # [W, 3]

    res = spec.resolution
    min_check_radius = res * 0.5
    # The reference computes the radius as (res/2 * sqrt(3))^2 in double,
    # which is strictly below 3*(res/2)^2 — its fixtures depend on cells at
    # exactly that distance staying empty (mesh_rasterizer.cpp:117-119).
    # Emulate the double-precision comparison in f32 by taking the largest
    # f32 value that does not exceed the f64 threshold.
    t64 = (min_check_radius * np.sqrt(3.0)) ** 2
    t32 = np.float32(t64)
    if float(t32) > t64:
        t32 = np.nextafter(t32, np.float32(0.0))
    max_check_radius_sq = jnp.float32(t32)

    v1 = tri_vertices[:, 0]
    v2 = tri_vertices[:, 1]
    v3 = tri_vertices[:, 2]
    normal = jnp.cross(v2 - v1, v3 - v1)

    # Candidate indices [T, W, 3].
    cand = min_indices[:, None, :] + offsets[None, :, :]
    in_window = jnp.all(cand <= max_indices[:, None, :], axis=-1)
    in_bounds = spec.check_grid_index_in_bounds(cand)
    centers = transforms.apply_isometry(
        origin_transform,
        spec.grid_index_to_location_in_grid_frame(cand))

    closest = closest_point_on_triangle(
        v1[:, None, :], v2[:, None, :], v3[:, None, :], normal[:, None, :],
        centers)
    dist_sq = jnp.sum((closest - centers) ** 2, axis=-1)
    fill = in_window & in_bounds & (dist_sq <= max_check_radius_sq)

    flat = spec.flat_index(cand)
    safe = jnp.where(fill, flat, 0)
    filled_flat = jnp.zeros(spec.num_total, jnp.float32).at[
        safe.reshape(-1)].max(
            jnp.where(fill, 1.0, 0.0).reshape(-1), mode="drop")
    return jnp.maximum(occupancy, filled_flat.reshape(spec.counts))


def rasterize_mesh_into_channel(spec: GridSpec, origin_transform,
                                occupancy: Array, vertices, triangles,
                                enforce_containment: bool = False) -> Array:
    """Rasterize triangles into an occupancy channel (``RasterizeMesh``,
    mesh_rasterizer.hpp:40-68). Vertices are world-frame ``[V, 3]``;
    ``triangles`` are ``[T, 3]`` vertex indices."""
    # The window/fill-radius math uses the scalar resolution; reject
    # non-uniform specs like every other raw-spec entry point (a 4x-wide
    # z window with correct per-axis centers would voxelize silently
    # wrong otherwise).
    spec.enforce_uniform_voxel_size()
    vertices = np.asarray(vertices, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    if triangles.size == 0:
        return occupancy

    # Host-side (f64) window computation mirroring the reference's per-
    # triangle AABB index range (cpp:133-153).
    tri_pts = vertices[triangles]  # [T, 3, 3]
    m = np.asarray(origin_transform, dtype=np.float64)
    rt = m[:3, :3].T
    pts_grid = (tri_pts - m[:3, 3]) @ rt.T
    aabb_min = pts_grid.min(axis=1)
    aabb_max = pts_grid.max(axis=1)
    min_idx = np.floor(aabb_min / spec.resolution).astype(np.int64)
    max_idx = np.floor(aabb_max / spec.resolution).astype(np.int64)

    if enforce_containment:
        counts = np.asarray(spec.counts)
        if np.any(min_idx < 0) or np.any(max_idx >= counts):
            raise RuntimeError(
                "Triangle is not contained by occupancy map")

    window = tuple(int(w) for w in (max_idx - min_idx).max(axis=0) + 1)
    return _rasterize_windows(
        spec, jnp.asarray(origin_transform, jnp.float32),
        occupancy, jnp.asarray(tri_pts, jnp.float32),
        jnp.asarray(min_idx, jnp.int32), jnp.asarray(max_idx, jnp.int32),
        window)


def rasterize_mesh(occupancy_map, vertices, triangles,
                   enforce_containment: bool = False):
    """Rasterize into any map type carrying an ``occupancy`` channel."""
    occ = rasterize_mesh_into_channel(
        occupancy_map.spec, occupancy_map.origin_transform,
        occupancy_map.occupancy, vertices, triangles, enforce_containment)
    if hasattr(occupancy_map, "set_occupancy"):
        return occupancy_map.set_occupancy(occ)
    return occupancy_map.replace(occupancy=occ)


def _auto_sized_map(vertices, resolution: float, frame: str, factory):
    """Grid auto-sizing from the mesh AABB with a one-voxel buffer
    (``RasterizeMeshIntoOccupancyMapImpl``, cpp:231-278)."""
    if resolution <= 0.0:
        raise ValueError("resolution must be greater than zero")
    vertices = np.asarray(vertices, dtype=np.float64)
    lower = vertices.min(axis=0)
    upper = vertices.max(axis=0)
    buffer = resolution * 2.0
    spec = GridSpec.from_grid_sizes(resolution,
                                    tuple(upper - lower + buffer))
    origin = transforms.isometry_from_translation(
        tuple(lower - resolution))
    return factory(spec, origin, frame)


def rasterize_mesh_into_occupancy_map(vertices, triangles,
                                      resolution: float) -> OccupancyMap:
    """``RasterizeMeshIntoOccupancyMap`` (mesh_rasterizer.hpp:74-81)."""
    omap = _auto_sized_map(
        vertices, resolution, "mesh",
        lambda spec, origin, frame: OccupancyMap.create(spec, origin, frame))
    return rasterize_mesh(omap, vertices, triangles,
                          enforce_containment=True)


def rasterize_mesh_into_occupancy_component_map(
        vertices, triangles, resolution: float) -> OccupancyComponentMap:
    """``RasterizeMeshIntoOccupancyComponentMap`` (hpp:83-90)."""
    omap = _auto_sized_map(
        vertices, resolution, "mesh",
        lambda spec, origin, frame: OccupancyComponentMap.create(
            spec, origin, frame))
    return rasterize_mesh(omap, vertices, triangles,
                          enforce_containment=True)
