"""Pointcloud voxelization: multi-camera depth-cloud ray carving + fusion.

Accelerator-native redesign of the reference's voxelization stack
(/root/reference/include/voxelized_geometry_tools/pointcloud_voxelization_interface.hpp,
.../src/.../cpu_pointcloud_voxelization.cpp and the CUDA/OpenCL kernels in
cuda_voxelization_helpers.cu:73-426):

* a *pointcloud* is a pytree of ``[N, 3]`` camera-frame points + an
  ``X_WC`` origin transform + max range (replaces ``PointCloudWrapper``,
  pointcloud_voxelization_interface.hpp:94-204),
* per-cloud *tracking grids* of ``{seen_free, seen_filled}`` int32 counters
  (replaces atomic ``CpuVoxelizationTrackingCell``) are built with an
  Amanatides–Woo DDA walk under ``lax.scan`` vmapped over rays, accumulated
  with a single scatter-add per cloud — the contention-free analogue of
  ``atomicAdd`` carving,
* the ``CountsSeenAs`` fusion filter (hpp:55-86 + cpu cpp:438-497) is a pure
  per-voxel map over stacked camera grids.

Ray-walk semantics (entry clipping, endpoint marking, step tie-breaking,
early exit at grid boundaries) follow cpu_pointcloud_voxelization.cpp:208-436
exactly, so the raycast count invariants from voxel_raycasting_test.cpp hold.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import transforms
from ..core.grid import GridSpec
from ..core.maps import OccupancyMap

Array = jnp.ndarray


class SeenAs(enum.IntEnum):
    """pointcloud_voxelization_interface.hpp:18."""
    UNKNOWN = 0
    FILLED = 1
    FREE = 2


class FilterOptions(NamedTuple):
    """``PointCloudVoxelizationFilterOptions`` (hpp:20-92)."""
    percent_seen_free: float = 1.0
    outlier_points_threshold: int = 1
    num_cameras_seen_free: int = 1

    def validate(self) -> "FilterOptions":
        if not (0.0 < self.percent_seen_free <= 1.0):
            raise ValueError("0 < percent_seen_free <= 1 must be true")
        if self.outlier_points_threshold <= 0:
            raise ValueError("outlier_points_threshold <= 0")
        if self.num_cameras_seen_free <= 0:
            raise ValueError("num_cameras_seen_free <= 0")
        return self


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Camera-frame depth points + camera pose (``PointCloudWrapper``)."""
    points: Array  # f32 [N, 3] in camera frame; non-finite points skipped
    origin_transform: Array  # f32 [4, 4] X_WC
    max_range: Array  # f32 scalar

    @staticmethod
    def create(points, origin_transform=None,
               max_range: float = float("inf")) -> "PointCloud":
        if origin_transform is None:
            origin_transform = jnp.eye(4, dtype=jnp.float32)
        return PointCloud(
            points=jnp.asarray(points, dtype=jnp.float32).reshape(-1, 3),
            origin_transform=jnp.asarray(origin_transform, jnp.float32),
            max_range=jnp.float32(max_range))


class TrackingGrid(NamedTuple):
    """Per-camera carve counters (cpu_pointcloud_voxelization.hpp:24-40)."""
    seen_free: Array  # i32 [nx, ny, nz]
    seen_filled: Array  # i32 [nx, ny, nz]


class VoxelizerRuntime(NamedTuple):
    """Phase wall timings (pointcloud_voxelization_interface.hpp:206-229).

    Populated honestly (a device sync between the carve and filter phases)
    whenever a ``runtime_log_fn`` is supplied to an EAGER entry point —
    :func:`voxelize_pointclouds` called with concrete arrays, or any
    backend's ``voxelize_pointclouds`` (ops/backends.py), which is the
    reference-parity calling convention. Under an enclosing ``jax.jit``
    there are no phase boundaries to time (the whole pipeline fuses into
    one XLA computation) and both fields are reported as 0.0 — time the
    fused call instead. This is the one deliberate fidelity gap vs the
    reference's always-populated struct: inserting syncs inside a trace
    would split the fusion the jit user asked for."""
    raycasting_time: float
    filtering_time: float


def _ray_visits(spec: GridSpec, p_start_grid: Array, start_index: Array,
                p_final_grid: Array, final_index: Array, ray: Array,
                hit: Array, clipped: Array):
    """Batched DDA walk setup over a whole ray block (cpu cpp:292-435).
    Inputs are ``[N, 3]`` / ``[N]``; returns ``(init_state, step_fn,
    endpoint_flat, endpoint_is_filled)`` — the walk itself is driven by
    :func:`_walk_and_scatter` so segments can early-exit.

    Everything is expressed as component-wise selects on separate per-axis
    ``[N]`` arrays: per-lane dynamic indexing (``t[axis]``,
    ``cur.at[axis].add``) vmaps to one gather/scatter PER STEP PER OPERAND —
    measured ~700M gather rows for a single 640x480 cloud at 128^3, 8x the
    whole carve's useful work."""
    n_counts = jnp.asarray(spec.counts, dtype=jnp.int32)
    res = jnp.float32(spec.resolution)
    half = res * 0.5

    # Axis steps from index difference sign (cpp:299-321).
    step = jnp.sign(final_index - start_index).astype(jnp.int32)

    # Initial per-axis t to leave the start voxel, in units of the full ray
    # (cpp:323-361).
    start_center = spec.grid_index_to_location_in_grid_frame(start_index)
    bottom = start_center - half
    top = start_center + half

    t_pos = jnp.abs((top - p_start_grid) / ray)
    t_neg = jnp.abs((p_start_grid - bottom) / ray)
    t0 = jnp.where(ray > 0.0, t_pos,
                   jnp.where(ray < 0.0, t_neg, jnp.inf))  # [N, 3]
    delta_t = jnp.where(ray != 0.0, jnp.abs(res / ray), jnp.inf)

    # Endpoint mark (cpp:367-381): filled unless range-clipped.
    final_in = spec.check_grid_index_in_bounds(final_index)
    endpoint_flat = jnp.where(
        hit & final_in, spec.flat_index(final_index).astype(jnp.int32), -1)
    endpoint_is_filled = ~clipped

    ny, nz = spec.counts[1], spec.counts[2]
    fx, fy, fz = final_index[:, 0], final_index[:, 1], final_index[:, 2]
    sx, sy, sz = step[:, 0], step[:, 1], step[:, 2]
    dtx, dty, dtz = delta_t[:, 0], delta_t[:, 1], delta_t[:, 2]
    tx0, ty0, tz0 = t0[:, 0], t0[:, 1], t0[:, 2]

    # t values are computed in closed form per axis (t0 + k * dt with an
    # exact integer step counter k) instead of the reference's serial
    # ``t += dt`` accumulation: both are valid DDA orderings (they differ
    # only in float rounding at cell-boundary ties), and the closed form is
    # what the column-marching twin (_column_carve_chunk) can reproduce
    # BIT-EXACTLY — keeping the two accelerator paths equal on every voxel,
    # not just in aggregate.
    # Zeroed infinite deltas: k stays 0 on axes that never step, so
    # t == t0 == +inf is preserved without 0 * inf NaNs.
    dtx_s = jnp.where(jnp.isfinite(dtx), dtx, 0.0)
    dty_s = jnp.where(jnp.isfinite(dty), dty, 0.0)
    dtz_s = jnp.where(jnp.isfinite(dtz), dtz, 0.0)

    def body(state, _):
        cx_, cy_, cz_, kx, ky, kz, active = state
        tx = tx0 + kx.astype(jnp.float32) * dtx_s
        ty = ty0 + ky.astype(jnp.float32) * dty_s
        tz = tz0 + kz.astype(jnp.float32) * dtz_s
        running = active & ((cx_ != fx) | (cy_ != fy) | (cz_ != fz))
        in_b = ((cx_ >= 0) & (cx_ < n_counts[0])
                & (cy_ >= 0) & (cy_ < n_counts[1])
                & (cz_ >= 0) & (cz_ < n_counts[2]))
        alive = running & in_b
        visit = jnp.where(alive, cx_ * (ny * nz) + cy_ * nz + cz_,
                          -1).astype(jnp.int32)
        # Axis choice with the reference's exact tie-breaking (cpp:405-434).
        pick_x = (tx <= ty) & (tx <= tz)
        pick_y = ~pick_x & (ty <= tx) & (ty <= tz)
        pick_z = ~pick_x & ~pick_y
        at_final = jnp.where(pick_x, cx_ == fx,
                             jnp.where(pick_y, cy_ == fy, cz_ == fz))
        alive = alive & ~at_final
        adv_x = alive & pick_x
        adv_y = alive & pick_y
        adv_z = alive & pick_z
        one = jnp.int32(1)
        new = (jnp.where(adv_x, cx_ + sx, cx_),
               jnp.where(adv_y, cy_ + sy, cy_),
               jnp.where(adv_z, cz_ + sz, cz_),
               jnp.where(adv_x, kx + one, kx),
               jnp.where(adv_y, ky + one, ky),
               jnp.where(adv_z, kz + one, kz),
               alive)
        return new, visit

    zero_k = jnp.zeros_like(start_index[:, 0], dtype=jnp.int32)
    init = (start_index[:, 0], start_index[:, 1], start_index[:, 2],
            zero_k, zero_k, zero_k, hit)
    return init, body, endpoint_flat, endpoint_is_filled


_DDA_SEGMENT = 64


def _walk_and_scatter(init, body, free_counts, max_steps: int):
    """March the DDA in ``_DDA_SEGMENT``-step segments under a while_loop,
    scattering each segment's visits and stopping as soon as every ray in
    the block has finished — the walk budget must cover the grid diagonal
    but typical paths are far shorter, so fixed-length scans waste most of
    their scatter slots on dead lanes."""
    n_segments = -(-max_steps // _DDA_SEGMENT)

    def seg_cond(state):
        i, dda, _ = state
        return (i < n_segments) & jnp.any(dda[-1])

    def seg_body(state):
        i, dda, counts = state
        dda, visits = lax.scan(body, dda, None, length=_DDA_SEGMENT)
        return i + 1, dda, _scatter_counts(counts, visits.reshape(-1))

    _, _, free_counts = lax.while_loop(
        seg_cond, seg_body, (jnp.int32(0), init, free_counts))
    return free_counts


def _norm3_canonical(v: Array) -> Array:
    """Euclidean norm over the last axis of ``[..., 3]`` with an
    order-canonical summation (ascending squares via a median-of-3 select),
    so the result is bit-identical under any axis permutation — required
    for the permuted-frame column carve to reproduce the identity-frame
    walk exactly."""
    sq = v * v
    a, b, c = sq[..., 0], sq[..., 1], sq[..., 2]
    lo = jnp.minimum(jnp.minimum(a, b), c)
    hi = jnp.maximum(jnp.maximum(a, b), c)
    mid = jnp.maximum(jnp.minimum(a, b), jnp.minimum(jnp.maximum(a, b), c))
    return jnp.sqrt((lo + mid) + hi)


def _prepare_rays(spec: GridSpec, X_GC: Array, points: Array,
                  max_range: Array, slab_axis_order=(0, 1, 2)):
    """Per-ray setup: range clip + grid entry clip (cpp:216-290).

    ``slab_axis_order`` fixes the axis visit order of the entry slab test's
    prefix accumulation (its ``miss`` flag is order-sensitive for grazing
    rays); the column-carve path passes the inverse axis permutation so the
    permuted-frame clip is bit-identical to the identity-frame one."""
    p_gco = X_GC[:3, 3]
    p_gp = transforms.apply_isometry(X_GC, points)  # [N, 3]
    finite = jnp.all(jnp.isfinite(points), axis=-1)

    ray = p_gp - p_gco
    ray_len = _norm3_canonical(ray)
    clipped = ray_len > max_range
    scale = jnp.where(ray_len > 0, max_range / jnp.maximum(ray_len, 1e-30),
                      0.0)
    p_final = jnp.where(clipped[:, None], p_gco + ray * scale[:, None], p_gp)

    grid_sizes = jnp.asarray(spec.grid_sizes, dtype=jnp.float32)

    # Far-endpoint clamp: any endpoint beyond the farthest grid corner is
    # interchangeable (it is out of the grid — no filled mark — and the
    # in-grid free-mark span is identical), but a huge finite endpoint
    # (depth-sensor sentinels like 1e9/FLT_MAX with max_range=inf)
    # saturates/wraps the int32 index math below, flipping the DDA's step
    # SIGN and breaking the walk/column bit-exact contract. Clamp the
    # endpoint onto the bounding sphere of grid+origin plus two voxels:
    # every downstream quantity (step sign, final_index, crossing counts)
    # then stays in sane integer range. `ray` itself is NOT clamped — the
    # walk's t parameterization and entry clip are fractions of the
    # original ray, unchanged.
    far_corner = jnp.sqrt(jnp.sum(jnp.maximum(
        jnp.abs(p_gco), jnp.abs(grid_sizes - p_gco)) ** 2))
    l_safe = far_corner + jnp.float32(2.0 * spec.resolution)
    off = p_final - p_gco
    # Overflow-robust norm: FLT_MAX-magnitude components square to inf in
    # f32, so normalize by the max-abs component first.
    m_abs = jnp.max(jnp.abs(off), axis=-1)
    offn = off / jnp.maximum(m_abs, 1e-30)[:, None]  # components in [-1, 1]
    d_unit = jnp.sqrt(jnp.sum(offn * offn, axis=-1))  # in [1, sqrt(3)]
    too_far = m_abs * jnp.minimum(d_unit, 2.0) > l_safe
    clamped_final = (p_gco + offn
                     * (l_safe / jnp.maximum(d_unit, 1e-30))[:, None])
    p_final = jnp.where(too_far[:, None], clamped_final, p_final)
    origin_index = spec.location_in_grid_frame_to_grid_index(p_gco)
    origin_in = spec.check_grid_index_in_bounds(origin_index)

    # Slab test for rays starting outside the grid (cpp:234-290,
    # Ericson RTCD 5.3.3).
    direction = ray / jnp.maximum(ray_len, 1e-30)[:, None]
    flat_thresh = 1e-10

    def slab(carry, axis):
        tmin, tmax, miss = carry
        d = direction[:, axis]
        nearly_flat = jnp.abs(d) < flat_thresh
        in_slab = (p_gco[axis] >= 0.0) & (p_gco[axis] < grid_sizes[axis])
        ood = 1.0 / jnp.where(nearly_flat, 1.0, d)
        tlow = (0.0 - p_gco[axis]) * ood
        thigh = (grid_sizes[axis] - p_gco[axis]) * ood
        t1 = jnp.minimum(tlow, thigh)
        t2 = jnp.maximum(tlow, thigh)
        tmin_new = jnp.where(nearly_flat, tmin, jnp.maximum(tmin, t1))
        # NOTE: the reference updates tmax with `if (t2 > tmax) tmax = t2`
        # (cpp:273-276) — widening, as written upstream — mirrored here.
        tmax_new = jnp.where(nearly_flat, tmax, jnp.maximum(tmax, t2))
        miss_new = miss | jnp.where(nearly_flat, ~in_slab,
                                    tmin_new > tmax_new)
        return (tmin_new, tmax_new, miss_new), None

    n = points.shape[0]
    # Initial carries derive from `points` so their varying-manual-axes match
    # the body outputs under shard_map (points may be +/-inf: use a select,
    # not arithmetic, to avoid NaNs).
    seed = jnp.where(jnp.zeros(n, dtype=bool), points[:, 0], 0.0)
    tmin0 = seed
    tmax0 = seed + jnp.broadcast_to(max_range, (n,)).astype(jnp.float32)
    miss0 = seed > 0.0  # all False, varying like points
    (tmin, _, miss), _ = lax.scan(slab, (tmin0, tmax0, miss0),
                                  jnp.asarray(slab_axis_order, jnp.int32))
    # The reference nudges the entry point 1e-10 into the grid (cpp:287-289);
    # that vanishes in f32 (boundary-exact entries would index out of bounds
    # and kill the whole ray), so the nudge scales with the voxel size.
    nudge = 1e-3 * spec.resolution
    p_entry = p_gco + direction * (tmin + nudge)[:, None]
    p_start = jnp.where(origin_in, p_gco[None, :], p_entry)
    hit = finite & (origin_in | ~miss)

    start_index = spec.location_in_grid_frame_to_grid_index(p_start)
    final_index = spec.location_in_grid_frame_to_grid_index(p_final)
    return p_start, start_index, p_final, final_index, ray, hit, clipped


def _scatter_counts(counts_flat: Array, flat_targets: Array) -> Array:
    valid = flat_targets >= 0
    safe = jnp.where(valid, flat_targets, 0)
    return counts_flat.at[safe].add(valid.astype(jnp.int32), mode="drop")


def _balanced_chunk(n_rays: int, ray_chunk: int) -> int:
    """Chunk width that balances ``n_rays`` across the minimum number of
    ``<= ray_chunk`` chunks instead of padding the last one: 38400 rays
    at ray_chunk=16384 get 3 x 12800 instead of 2 x 16384 + 10752 dead
    lanes (+28% scatter rows — dropped lanes cost nearly full scatter
    rate). Lane-aligned to 256. Results are bit-exact under
    any chunking (integer scatter-adds commute; sorting only regroups)."""
    n_rays = max(n_rays, 1)
    if n_rays <= ray_chunk:
        return n_rays
    n_chunks = -(-n_rays // ray_chunk)
    per = -(-n_rays // n_chunks)
    return min(-(-per // 256) * 256, ray_chunk)


def grid_from_camera(grid_origin_transform: Array,
                     camera_pose: Array) -> Array:
    """Grid-from-camera isometry ``X_GW @ X_WC`` that every carve starts
    from."""
    return transforms.compose(
        transforms.invert_isometry(grid_origin_transform), camera_pose)


def _permuted_grid_origin(grid_origin_transform: Array,
                          perm: Tuple[int, int, int]) -> Array:
    """Origin transform of the grid frame whose axis ``i`` is the original
    axis ``perm[i]``."""
    p4 = np.zeros((4, 4), np.float32)
    for new_ax, old_ax in enumerate(perm):
        p4[new_ax, old_ax] = 1.0
    p4[3, 3] = 1.0
    return (jnp.asarray(grid_origin_transform, jnp.float32)
            @ jnp.asarray(p4, jnp.float32).T)


def raycast_pointcloud(spec: GridSpec, grid_origin_transform: Array,
                       cloud: PointCloud,
                       max_steps: Optional[int] = None,
                       ray_chunk: int = 16384) -> TrackingGrid:
    """Carve one cloud into a fresh tracking grid
    (``DoRaycastPointCloud``, cpu cpp:167-206). Fully jittable; rays are the
    vmapped axis, counter accumulation is a scatter-add. Rays are processed in
    ``ray_chunk`` blocks under ``lax.scan`` so the per-step visit buffer stays
    bounded at ``ray_chunk * max_steps`` regardless of cloud size."""
    # DDA math (delta = res / ray etc.) assumes cubic voxels, matching the
    # reference's uniform-enforcing maps (occupancy_map.hpp constructors).
    spec.enforce_uniform_voxel_size()
    if max_steps is None:
        max_steps = spec.num_x + spec.num_y + spec.num_z + 2

    X_GC = grid_from_camera(grid_origin_transform, cloud.origin_transform)

    n_rays = cloud.points.shape[0]
    n_total = spec.num_total
    if n_rays == 0:
        zero = jnp.zeros(spec.counts, jnp.int32)
        return TrackingGrid(zero, zero)

    chunk = _balanced_chunk(n_rays, ray_chunk)
    pad = (-n_rays) % chunk
    # Padding rays are non-finite -> hit=False -> no marks.
    points = jnp.pad(cloud.points, ((0, pad), (0, 0)),
                     constant_values=jnp.inf)
    points = points.reshape(-1, chunk, 3)

    def chunk_body(carry, chunk_points):
        free_counts, filled_counts = carry
        (p_start, start_idx, p_final, final_idx, ray, hit,
         clipped) = _prepare_rays(spec, X_GC, chunk_points, cloud.max_range)

        init, body, endpoint_flat, endpoint_filled = _ray_visits(
            spec, p_start, start_idx, p_final, final_idx, ray, hit, clipped)
        free_counts = _walk_and_scatter(init, body, free_counts, max_steps)

        # Endpoint marks (cpp:367-381): free if range-clipped, else filled.
        free_counts = _scatter_counts(
            free_counts, jnp.where(endpoint_filled, -1, endpoint_flat))
        filled_flat = jnp.where(endpoint_filled, endpoint_flat, -1)
        return (free_counts,
                _scatter_counts(filled_counts, filled_flat)), None

    # Zero counters derived from the (possibly device-varying) points so the
    # scan carry types match under shard_map.
    vary = jnp.any(jnp.zeros((), dtype=bool) & jnp.isfinite(points[0, 0, 0]))
    zero_counts = jnp.where(vary, 1, 0).astype(jnp.int32) + jnp.zeros(
        n_total, jnp.int32)
    init = (zero_counts, zero_counts)
    (free_counts, filled_counts), _ = lax.scan(chunk_body, init, points)
    return TrackingGrid(seen_free=free_counts.reshape(spec.counts),
                        seen_filled=filled_counts.reshape(spec.counts))


def _column_carve_chunk(spec: GridSpec, p_start: Array, start_idx: Array,
                        final_idx: Array, ray: Array, hit: Array,
                        free_rows: Array, m_max: int,
                        run_beats_c1: bool = False,
                        run_beats_c2: bool = False,
                        c1_beats_c2: bool = True,
                        voxel_budget: Optional[int] = None) -> Array:
    """Column-marching DDA: one iteration per visited (x, y) COLUMN.

    The voxel walk (``_ray_visits``) pays one scatter element per visited
    voxel, and scatter elements were the entire carve bottleneck on the
    accelerator this was designed on (not measured on the H100). But a ray's visits within one xy column are a
    CONTIGUOUS z run, so this walk advances column-by-column and emits the
    whole run as ONE ``[nz]``-wide masked row scatter-add (a 512-byte row
    costs ~10 ns — barely more than a scalar element). Element count drops
    from (path voxels) to (path columns): ~4-6x fewer for depth-camera
    bundles marching near the grid's z axis.

    Semantics mirror cpu_pointcloud_voxelization.cpp:292-435: the start
    voxel is marked, the final voxel is not, walks stop when the stepped
    axis reaches the final coordinate (the reference's early-break) or at
    the first out-of-bounds voxel. The z-step count per column is the
    closed form ``ceil((min(tx,ty) - tz) / dtz)`` rather than the
    reference's serially accumulated comparisons, so t values can differ by
    float rounding at exact cell-boundary ties — the same class of
    divergence the reference accepts between its own CPU (double) and
    CUDA/OpenCL (float) backends, validated by the shared oracle
    (pointcloud_voxelization_test.cpp:275-295).
    """
    nx, ny, nz = spec.counts
    res = jnp.float32(spec.resolution)
    half = res * 0.5

    step = jnp.sign(final_idx - start_idx).astype(jnp.int32)
    start_center = spec.grid_index_to_location_in_grid_frame(start_idx)
    t_pos = jnp.abs((start_center + half - p_start) / ray)
    t_neg = jnp.abs((p_start - (start_center - half)) / ray)
    t0 = jnp.where(ray > 0.0, t_pos, jnp.where(ray < 0.0, t_neg, jnp.inf))
    delta = jnp.where(ray != 0.0, jnp.abs(res / ray), jnp.inf)

    cx, cy, z0 = start_idx[:, 0], start_idx[:, 1], start_idx[:, 2]
    fx, fy, fz = final_idx[:, 0], final_idx[:, 1], final_idx[:, 2]
    sx, sy, sz = step[:, 0], step[:, 1], step[:, 2]
    tx0, ty0, tz0 = t0[:, 0], t0[:, 1], t0[:, 2]
    dtx, dty, dtz = delta[:, 0], delta[:, 1], delta[:, 2]
    # Safe deltas for closed-form t (k stays 0 on axes that never step, so
    # zeroing an infinite delta keeps t == t0 == +inf without 0 * inf NaNs).
    dtx_s = jnp.where(jnp.isfinite(dtx), dtx, 0.0)
    dty_s = jnp.where(jnp.isfinite(dty), dty, 0.0)
    dtz_s = jnp.where(jnp.isfinite(dtz), dtz, 0.0)

    big = jnp.int32(2 * (nx + ny + nz))
    n_rows = nx * ny
    zrange = jnp.arange(nz, dtype=jnp.int32)[None, :]

    def tz_at(k):
        return tz0 + k.astype(jnp.float32) * dtz_s

    alive0 = hit & ~((cx == fx) & (cy == fy) & (z0 == fz))
    # Start voxel must be in bounds (callers clip entry), but guard anyway.
    alive0 = alive0 & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) \
        & (z0 >= 0) & (z0 < nz)

    budget32 = None if voxel_budget is None else jnp.int32(voxel_budget)

    def cond(state):
        i = state[0]
        alive = state[7]
        return (i < m_max) & jnp.any(alive)

    def body(state):
        i, cx, cy, z, kx, ky, kz, alive, rows = state[:9]
        tx = tx0 + kx.astype(jnp.float32) * dtx_s
        ty = ty0 + ky.astype(jnp.float32) * dty_s
        tz = tz_at(kz)
        # Column pick and run-vs-column ties replicate the reference's
        # fixed x >= y >= z priority mapped through the axis permutation
        # (the run/c1/c2 booleans are derived from run_axis by the caller).
        pick_c1 = jnp.where(tx == ty, jnp.bool_(c1_beats_c2), tx < ty)
        m = jnp.where(pick_c1, tx, ty)
        run_tie_wins = jnp.where(pick_c1, jnp.bool_(run_beats_c1),
                                 jnp.bool_(run_beats_c2))
        at_final_col = (cx == fx) & (cy == fy)

        # z-steps demanded before the column changes: first crossing index
        # j >= kz that is NOT consumed before the column step. Crossing j
        # (time fl(tz0 + j*dtz)) is consumed while its time < m, or == m
        # when the run axis outranks the picked column. The closed form
        # lands within one of the true j; the +/-1 sweeps below pin it to
        # the EXACT float comparisons the voxel walk makes, keeping the two
        # paths bit-identical.
        def consumed(jv):
            cj = tz_at(jv)
            return (cj < m) | (run_tie_wins & (cj == m))

        frac = (m - tz) / dtz
        frac = jnp.where(jnp.isfinite(frac), frac,
                         big.astype(jnp.float32))
        j = kz + jnp.where(tz < m,
                           jnp.clip(jnp.ceil(jnp.maximum(frac, 0.0)), 0,
                                    big.astype(jnp.float32)),
                           0.0).astype(jnp.int32)
        for _ in range(2):
            j = jnp.where((j > kz) & ~consumed(j - 1), j - 1, j)
        for _ in range(2):
            j = jnp.where(consumed(j), j + 1, j)
        n_raw = jnp.clip(j - kz, 0, big)

        # z-steps until z == fz. With sz == 0 the start and final share the
        # z layer and z never moves, so z is ALREADY at fz: any demanded z
        # pick breaks immediately (cpp:420-434 with z_step == 0), and in
        # the final column current == final fires with nothing to mark.
        n_to_fz = jnp.where(sz != 0, jnp.maximum((fz - z) * sz, 0), 0)
        n_edge = jnp.where(sz > 0, (nz - 1) - z,
                           jnp.where(sz < 0, z, big))

        # Walk-terminating clamps inside this column:
        #  * z reaches the final z coordinate; the next z pick breaks AFTER
        #    the loop top marked fz (non-final column) — run ends at fz.
        #  * in the final column the loop-top current==final exit fires
        #    BEFORE marking fz — run ends at fz - sz.
        #  * stepping past the grid edge: the stepped-to voxel is never
        #    marked — run ends at the edge voxel.
        # The grid-edge clamp outranks the final-z clamps: a final voxel
        # beyond the grid is never reached — the walk exits at the edge
        # (otherwise z_end overruns the grid and, in the diff variant, the
        # exit element's slot would spill into the next column's section).
        end_fz = ((n_raw > n_to_fz) & ~at_final_col
                  & (n_to_fz <= n_edge))
        end_fz_final = (at_final_col & (n_raw >= n_to_fz)
                        & (n_to_fz - 1 <= n_edge))
        n_eff = jnp.minimum(n_raw, n_edge)
        n_eff = jnp.where(end_fz, n_to_fz, n_eff)
        n_eff = jnp.where(end_fz_final, n_to_fz - 1, n_eff)
        end_oob_z = (~end_fz & ~end_fz_final) & (n_raw > n_edge)
        column_done = end_fz | end_fz_final | end_oob_z

        z_end = z + sz * n_eff
        # end_fz_final with n_to_fz == 0 means the column's only voxel IS
        # the final voxel -> nothing to mark this iteration.
        emit = alive & ~(end_fz_final & (n_to_fz == 0))

        if budget32 is not None:
            # Per-ray visited-voxel budget, bit-matching the walk: each walk
            # iteration marks exactly one voxel while alive, and this run
            # would mark n_eff + 1 (z through z_end inclusive; the run's
            # first voxel is marked by the iteration that stepped into the
            # column). Truncate the run at the voxel where the walk's
            # budget expires and kill the ray there.
            used = state[9]
            r_full = jnp.where(emit, n_eff + 1, 0)
            allowed = jnp.maximum(budget32 - used, 0)
            trunc = r_full > allowed
            r_eff = jnp.minimum(r_full, allowed)
            emit = emit & (r_eff > 0)
            z_end_mark = z + sz * jnp.maximum(r_eff - 1, 0)
        else:
            z_end_mark = z_end

        zmin = jnp.minimum(z, z_end_mark)
        zmax = jnp.maximum(z, z_end_mark)
        mask = ((zrange >= zmin[:, None]) & (zrange <= zmax[:, None]))
        row_idx = jnp.where(emit, cx * ny + cy, n_rows)
        rows = rows.at[row_idx].add(mask.astype(free_rows.dtype),
                                    mode="drop")

        # Column step (only for lanes not terminated inside the column).
        pick_x = pick_c1
        # Early break: stepping an axis already at its final coordinate
        # (cpp:405-434); current voxel was already marked by this run.
        break_b = jnp.where(pick_x, cx == fx, cy == fy)
        ncx = jnp.where(pick_x, cx + sx, cx)
        ncy = jnp.where(pick_x, cy, cy + sy)
        oob_col = (ncx < 0) | (ncx >= nx) | (ncy < 0) | (ncy >= ny)
        step_ok = ~column_done & ~break_b & ~oob_col

        alive_next = alive & step_ok
        if budget32 is not None:
            alive_next = alive_next & ~trunc
        one = jnp.int32(1)
        new_cx = jnp.where(alive_next & pick_x, ncx, cx)
        new_cy = jnp.where(alive_next & ~pick_x, ncy, cy)
        new_kx = jnp.where(alive_next & pick_x, kx + one, kx)
        new_ky = jnp.where(alive_next & ~pick_x, ky + one, ky)
        new_z = jnp.where(alive_next, z_end, z)
        new_kz = jnp.where(alive_next, kz + n_eff, kz)
        out = (i + 1, new_cx, new_cy, new_z, new_kx, new_ky, new_kz,
               alive_next, rows)
        if budget32 is not None:
            out = out + (used + r_eff,)
        return out

    zero_k = jnp.zeros_like(cx, dtype=jnp.int32)
    state = (jnp.int32(0), cx, cy, z0, zero_k, zero_k, zero_k, alive0,
             free_rows)
    if budget32 is not None:
        state = state + (zero_k,)
    state = lax.while_loop(cond, body, state)
    return state[8]


def _column_carve_chunk_diff(spec: GridSpec, p_start: Array,
                             start_idx: Array, final_idx: Array, ray: Array,
                             hit: Array, bucket_grid: Array, m_max: int,
                             run_beats_c1: bool = False,
                             run_beats_c2: bool = False,
                             c1_beats_c2: bool = True) -> Array:
    """Diff-scatter twin of :func:`_column_carve_chunk`: ONE SCALAR scatter
    element per visited column instead of a ``[nz]``-wide row (~6.6 vs
    ~10 ns each, measured — the last constant factor on the carve).

    Each column's z-run is encoded by its ENTRY element ``(column, z_in)``;
    the run's two diff endpoints (+1 at its low z, -1 above its high z) are
    recovered in :func:`_combine_diff_buckets` from that element and the
    NEXT column's entry element — which sits at a fixed offset (the xy step
    direction, one z level) — so elements are bucketed by (step direction,
    z-march sign) and the endpoint algebra becomes nine dense shifted adds
    + one z cumsum. Entry/exit elements close each ray's first/last run;
    a run that dies unmarked in its entry column is cancelled exactly by
    its exit element (the ``n_eff = -1`` algebra).

    ``bucket_grid`` is int32 ``[10, nx*ny, nz+2]`` (D, B0, 4x B+, 4x B-);
    the walk itself is identical to the rows variant, so the result after
    :func:`_combine_diff_buckets` is bit-equal to the voxel walk.
    """
    nx, ny, nz = spec.counts
    res = jnp.float32(spec.resolution)
    half = res * 0.5

    step = jnp.sign(final_idx - start_idx).astype(jnp.int32)
    start_center = spec.grid_index_to_location_in_grid_frame(start_idx)
    t_pos = jnp.abs((start_center + half - p_start) / ray)
    t_neg = jnp.abs((p_start - (start_center - half)) / ray)
    t0 = jnp.where(ray > 0.0, t_pos, jnp.where(ray < 0.0, t_neg, jnp.inf))
    delta = jnp.where(ray != 0.0, jnp.abs(res / ray), jnp.inf)

    cx, cy, z0 = start_idx[:, 0], start_idx[:, 1], start_idx[:, 2]
    fx, fy, fz = final_idx[:, 0], final_idx[:, 1], final_idx[:, 2]
    sx, sy, sz = step[:, 0], step[:, 1], step[:, 2]
    tx0, ty0, tz0 = t0[:, 0], t0[:, 1], t0[:, 2]
    dtx, dty, dtz = delta[:, 0], delta[:, 1], delta[:, 2]
    dtx_s = jnp.where(jnp.isfinite(dtx), dtx, 0.0)
    dty_s = jnp.where(jnp.isfinite(dty), dty, 0.0)
    dtz_s = jnp.where(jnp.isfinite(dtz), dtz, 0.0)

    big = jnp.int32(2 * (nx + ny + nz))
    n_rows = nx * ny
    sec = n_rows * (nz + 2)  # one bucket section
    n_flat = 10 * sec

    def tz_at(k):
        return tz0 + k.astype(jnp.float32) * dtz_s

    def el_index(bucket, col_flat, zslot):
        return bucket * sec + col_flat * (nz + 2) + zslot

    def scatter(grid_flat, idx, val, on):
        safe = jnp.where(on, idx, n_flat)
        return grid_flat.at[safe].add(jnp.where(on, val, 0), mode="drop")

    alive0 = hit & ~((cx == fx) & (cy == fy) & (z0 == fz))
    alive0 = alive0 & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) \
        & (z0 >= 0) & (z0 < nz)

    grid_flat = bucket_grid.reshape(-1)
    col0 = cx * ny + cy
    # Entry element: opens the first run (sz > 0: +1 at its low z; sz < 0:
    # -1 above its high z; sz == 0: the self-contained B0 pair).
    entry_bucket = jnp.where(sz == 0, 1, 0)
    entry_slot = jnp.where(sz < 0, z0 + 1, z0)
    entry_val = jnp.where(sz < 0, -1, 1)
    grid_flat = scatter(grid_flat, el_index(entry_bucket, col0, entry_slot),
                        entry_val, alive0)

    def cond(state):
        i = state[0]
        alive = state[7]
        return (i < m_max) & jnp.any(alive)

    def body(state):
        (i, cx, cy, z, kx, ky, kz, alive, exit_col, exit_z, exit_on,
         gflat) = state
        tx = tx0 + kx.astype(jnp.float32) * dtx_s
        ty = ty0 + ky.astype(jnp.float32) * dty_s
        tz = tz_at(kz)
        pick_c1 = jnp.where(tx == ty, jnp.bool_(c1_beats_c2), tx < ty)
        m = jnp.where(pick_c1, tx, ty)
        run_tie_wins = jnp.where(pick_c1, jnp.bool_(run_beats_c1),
                                 jnp.bool_(run_beats_c2))
        at_final_col = (cx == fx) & (cy == fy)

        def consumed(jv):
            cj = tz_at(jv)
            return (cj < m) | (run_tie_wins & (cj == m))

        frac = (m - tz) / dtz
        frac = jnp.where(jnp.isfinite(frac), frac, big.astype(jnp.float32))
        j = kz + jnp.where(tz < m,
                           jnp.clip(jnp.ceil(jnp.maximum(frac, 0.0)), 0,
                                    big.astype(jnp.float32)),
                           0.0).astype(jnp.int32)
        for _ in range(2):
            j = jnp.where((j > kz) & ~consumed(j - 1), j - 1, j)
        for _ in range(2):
            j = jnp.where(consumed(j), j + 1, j)
        n_raw = jnp.clip(j - kz, 0, big)

        n_to_fz = jnp.where(sz != 0, jnp.maximum((fz - z) * sz, 0), 0)
        n_edge = jnp.where(sz > 0, (nz - 1) - z,
                           jnp.where(sz < 0, z, big))
        # The grid-edge clamp outranks the final-z clamps: a final voxel
        # beyond the grid is never reached — the walk exits at the edge
        # (otherwise z_end overruns the grid and, in the diff variant, the
        # exit element's slot would spill into the next column's section).
        end_fz = ((n_raw > n_to_fz) & ~at_final_col
                  & (n_to_fz <= n_edge))
        end_fz_final = (at_final_col & (n_raw >= n_to_fz)
                        & (n_to_fz - 1 <= n_edge))
        n_eff = jnp.minimum(n_raw, n_edge)
        n_eff = jnp.where(end_fz, n_to_fz, n_eff)
        n_eff = jnp.where(end_fz_final, n_to_fz - 1, n_eff)
        end_oob_z = (~end_fz & ~end_fz_final) & (n_raw > n_edge)
        column_done = end_fz | end_fz_final | end_oob_z
        z_end = z + sz * n_eff

        pick_x = pick_c1
        break_b = jnp.where(pick_x, cx == fx, cy == fy)
        ncx = jnp.where(pick_x, cx + sx, cx)
        ncy = jnp.where(pick_x, cy, cy + sy)
        oob_col = (ncx < 0) | (ncx >= nx) | (ncy < 0) | (ncy >= ny)
        step_ok = ~column_done & ~break_b & ~oob_col
        alive_next = alive & step_ok
        dying = alive & ~step_ok

        # Column element for the stepped-into column: bucketed by the xy
        # step direction and z sign (delta code 0..3 = x+, x-, y+, y-).
        dcode = jnp.where(pick_x, jnp.where(sx > 0, 0, 1),
                          jnp.where(sy > 0, 2, 3))
        col_bucket = jnp.where(sz == 0, 1,
                               jnp.where(sz > 0, 2 + dcode, 6 + dcode))
        new_col = ncx * ny + ncy
        # sz<0 elements live at slot z+1 so every derived endpoint is a
        # non-negative slot; B- combination shifts account for it.
        # An sz==0 lane stepping into its FINAL column dies unmarked next
        # iteration and its B0 element is self-contained (no exit-element
        # cancel exists for it) — suppress the element instead.
        el_slot = jnp.where(sz < 0, z_end + 1, z_end)
        el_on = alive_next & ~((sz == 0) & (ncx == fx) & (ncy == fy))
        gflat = scatter(gflat, el_index(col_bucket, new_col, el_slot),
                        jnp.ones_like(col_bucket), el_on)

        # Exit element of dying lanes closes (or exactly cancels) the last
        # run: sz > 0: -1 at z_end + 1; sz < 0: +1 at z_end. sz == 0 runs
        # are self-contained (B0) and need no exit.
        exit_col = jnp.where(dying, cx * ny + cy, exit_col)
        exit_z = jnp.where(dying, z_end, exit_z)
        exit_on = exit_on | (dying & (sz != 0))

        one = jnp.int32(1)
        new_cx = jnp.where(alive_next & pick_x, ncx, cx)
        new_cy = jnp.where(alive_next & ~pick_x, ncy, cy)
        new_kx = jnp.where(alive_next & pick_x, kx + one, kx)
        new_ky = jnp.where(alive_next & ~pick_x, ky + one, ky)
        new_z = jnp.where(alive_next, z_end, z)
        new_kz = jnp.where(alive_next, kz + n_eff, kz)
        return (i + 1, new_cx, new_cy, new_z, new_kx, new_ky, new_kz,
                alive_next, exit_col, exit_z, exit_on, gflat)

    zero_k = jnp.zeros_like(cx, dtype=jnp.int32)
    state = (jnp.int32(0), cx, cy, z0, zero_k, zero_k, zero_k, alive0,
             jnp.zeros_like(col0), jnp.zeros_like(z0),
             jnp.zeros_like(alive0), grid_flat)
    state = lax.while_loop(cond, body, state)
    (_, fcx, fcy, fcz, _, _, _, alive_f, exit_col, exit_z, exit_on,
     grid_flat) = state

    # Lanes cut off by an m_max budget smaller than the column bound would
    # leave their last run unclosed — close it at the current position.
    exit_col = jnp.where(alive_f, fcx * ny + fcy, exit_col)
    exit_z = jnp.where(alive_f, fcz, exit_z)
    exit_on = exit_on | (alive_f & (sz != 0))

    exit_slot = jnp.where(sz < 0, exit_z, exit_z + 1)
    exit_val = jnp.where(sz < 0, 1, -1)
    grid_flat = scatter(grid_flat, el_index(jnp.zeros_like(exit_col),
                                            exit_col, exit_slot),
                        exit_val, exit_on)
    return grid_flat.reshape(bucket_grid.shape)


def _combine_diff_buckets(spec: GridSpec, bucket_grid: Array) -> Array:
    """Fold the 10 diff buckets into per-voxel seen-free counts (see
    :func:`_column_carve_chunk_diff`): nine dense shifted adds + one z
    cumsum — exact integer arithmetic, no scatter."""
    nx, ny, nz = spec.counts
    g = bucket_grid.reshape(10, nx, ny, nz + 2)
    d = g[0]
    b0 = g[1]
    diff = d + b0
    # B0: -1 one z above each element.
    diff = diff.at[:, :, 1:].add(-b0[:, :, :-1])

    def shift_xy(arr, dx, dy):
        """arr sampled at (x + dx, y + dy), zero outside."""
        out = jnp.zeros_like(arr)
        sx = slice(max(dx, 0), nx + min(dx, 0))
        tx_ = slice(max(-dx, 0), nx + min(-dx, 0))
        sy = slice(max(dy, 0), ny + min(dy, 0))
        ty_ = slice(max(-dy, 0), ny + min(-dy, 0))
        return out.at[tx_, ty_].set(arr[sx, sy])

    deltas = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    for k, (dx, dy) in enumerate(deltas):
        bp = g[2 + k]   # sz > 0, step delta (dx, dy)
        # +1 at the element; -1 at (col - delta, z + 1).
        diff = diff + bp
        diff = diff.at[:, :, 1:].add(-shift_xy(bp, dx, dy)[:, :, :-1])
        bm = g[6 + k]   # sz < 0 (elements stored at slot z + 1)
        # +1 at (col - delta, z) = slot z + 1 shifted down one z;
        # -1 at (col, z + 1) = the element's own slot.
        diff = diff.at[:, :, :-1].add(shift_xy(bm, dx, dy)[:, :, 1:])
        diff = diff - bm
    counts = jnp.cumsum(diff, axis=2)[:, :, :nz]
    return counts


_AXIS_PERMS = {0: (1, 2, 0), 1: (2, 0, 1), 2: (0, 1, 2)}


def raycast_pointcloud_columns(spec: GridSpec, grid_origin_transform: Array,
                               cloud: PointCloud,
                               max_steps: Optional[int] = None,
                               ray_chunk: int = 16384,
                               run_axis: Union[int, str] = 2,
                               accumulate: str = "rows") -> TrackingGrid:
    """Column-marching twin of :func:`raycast_pointcloud` (same tracking-grid
    output; see :func:`_column_carve_chunk` for the scatter-volume argument
    and the float-tie caveat). ``run_axis`` selects which grid axis becomes
    the contiguous run direction — pick the camera bundle's dominant axis;
    rays orthogonal to it degrade to one element per voxel (the walk path's
    column count equals its voxel count there). ``run_axis="split"``
    carves each ray along its OWN dominant axis (direction-independent
    cost for oblique cameras; see :func:`_raycast_columns_split`). ``accumulate``: ``"rows"``
    (default; one masked ``[nz]`` row per column,
    :func:`_column_carve_chunk`) or ``"diff"`` (one scalar element per
    column + bucket-shift combine, :func:`_column_carve_chunk_diff`) —
    identical results. Rows is the default; which is faster on the H100
    is not measured.

    ``max_steps`` is a per-ray VISITED-VOXEL budget with semantics identical
    to :func:`raycast_pointcloud` (runs are truncated at the exact voxel
    where the walk's step budget would expire, keeping the two paths
    bit-identical under any budget); only ``accumulate="rows"`` supports it.
    """
    spec.enforce_uniform_voxel_size()
    if max_steps is not None and accumulate != "rows":
        raise ValueError(
            "max_steps is only supported with accumulate='rows' (the diff "
            "variant's endpoint algebra cannot truncate runs mid-column)")
    if isinstance(run_axis, str):
        if run_axis != "split":
            raise ValueError(f"Unknown run_axis {run_axis!r}")
        return _raycast_columns_split(spec, grid_origin_transform, cloud,
                                      max_steps, ray_chunk, accumulate)
    perm = _AXIS_PERMS[int(run_axis)]
    # Reference priority x >= y >= z mapped into the permuted frame:
    # which axis wins each pairwise tie is decided by ORIGINAL axis id.
    c1_old, c2_old, run_old = perm
    tie_flags = dict(run_beats_c1=run_old < c1_old,
                     run_beats_c2=run_old < c2_old,
                     c1_beats_c2=c1_old < c2_old)
    if perm != (0, 1, 2):
        # Carve in a permuted grid frame where run_axis is last; counts are
        # invariant to axis relabeling, so permute back at the end. (The
        # entry slab clip runs per permuted axis order here; its
        # accumulation order can differ from the original frame's at exact
        # boundary grazes — same tolerance class as the t ties.)
        pspec = GridSpec(tuple(spec.counts[a] for a in perm),
                        spec.resolution)
        porigin = _permuted_grid_origin(grid_origin_transform, perm)
        inv = tuple(np.argsort(perm))
        grid = _raycast_columns_impl(pspec, porigin, cloud, max_steps,
                                     ray_chunk, tie_flags,
                                     slab_axis_order=inv,
                                     accumulate=accumulate)
        return TrackingGrid(
            seen_free=jnp.transpose(grid.seen_free, inv),
            seen_filled=jnp.transpose(grid.seen_filled, inv))
    return _raycast_columns_impl(spec, grid_origin_transform, cloud,
                                 max_steps, ray_chunk, tie_flags,
                                 accumulate=accumulate)


def _raycast_columns_split(spec: GridSpec, grid_origin_transform: Array,
                           cloud: PointCloud, max_steps: Optional[int],
                           ray_chunk: int,
                           accumulate: str) -> TrackingGrid:
    """Direction-independent column carve: each ray runs along ITS OWN
    dominant grid axis (``run_axis="split"``).

    A single global ``run_axis`` degrades when the camera sits at
    45 degrees to every axis (runs shorten toward one voxel), while the reference's per-voxel DDA walk costs
    the same in any direction (cpu_pointcloud_voxelization.cpp:292-435).
    This path recovers direction independence for the FAST carve: rays are
    partitioned by ``argmax |dir|`` in the grid frame and each of the (up
    to) three groups is carved with its matching ``run_axis``, summed —
    scatter-adds are integer and order-independent, so the total is
    bit-exact vs the voxel walk just like each single-axis call.

    Fully jittable (the partition is a mask, not a gather): each
    single-axis call sees the other groups' rays as non-finite points,
    whose ``m_est`` sorts them into leading all-dead chunks that exit the
    column while_loop after one alive-check — the three calls together do
    ~one call's carving work plus two extra chunk scans of dead lanes."""
    X_GC = grid_from_camera(grid_origin_transform, cloud.origin_transform)
    p_grid = transforms.apply_isometry(X_GC, cloud.points)
    d = p_grid - X_GC[:3, 3]
    finite = jnp.all(jnp.isfinite(cloud.points), axis=-1)
    axis_id = jnp.argmax(jnp.abs(jnp.where(finite[:, None], d, 0.0)),
                         axis=-1)
    total = None
    for a in range(3):
        sel = finite & (axis_id == a)
        pts = jnp.where(sel[:, None], cloud.points, jnp.inf)
        grid = raycast_pointcloud_columns(
            spec, grid_origin_transform,
            PointCloud(points=pts, origin_transform=cloud.origin_transform,
                       max_range=cloud.max_range),
            max_steps=max_steps, ray_chunk=ray_chunk, run_axis=a,
            accumulate=accumulate)
        total = grid if total is None else TrackingGrid(
            seen_free=total.seen_free + grid.seen_free,
            seen_filled=total.seen_filled + grid.seen_filled)
    return total


def _raycast_columns_impl(spec: GridSpec, grid_origin_transform: Array,
                          cloud: PointCloud, max_steps: Optional[int],
                          ray_chunk: int, tie_flags: dict,
                          slab_axis_order=(0, 1, 2),
                          accumulate: str = "rows") -> TrackingGrid:
    nx, ny, nz = spec.counts
    X_GC = grid_from_camera(grid_origin_transform, cloud.origin_transform)

    n_rays = cloud.points.shape[0]
    if n_rays == 0:
        zero = jnp.zeros(spec.counts, jnp.int32)
        return TrackingGrid(zero, zero)

    # m_max bounds COLUMN iterations (the xy footprint diagonal); a user
    # max_steps is a per-ray VOXEL budget with the walk path's semantics.
    # `_walk_and_scatter` runs whole _DDA_SEGMENT-step segments, so the
    # walk's effective budget rounds up to a multiple of 64 — mirror that
    # exactly to keep the two paths bit-identical under any budget.
    m_max = nx + ny + 2
    voxel_budget = None
    if max_steps is not None:
        voxel_budget = -(-int(max_steps) // _DDA_SEGMENT) * _DDA_SEGMENT

    chunk = _balanced_chunk(n_rays, ray_chunk)
    pad = (-n_rays) % chunk

    # Sort rays by projected xy-path length so each chunk's column budget
    # (the while_loop runs to the chunk MAX) matches its rays: without this
    # one grazing ray drags a whole chunk of short rays through dead-lane
    # scatter rows, which cost nearly as much as live ones (measured).
    # Smaller chunks tighten the sorted m-quantiles further — 16k beats 64k
    # by 13% on config2 (92.8 vs 105.8 ms); per-chunk overhead bites below
    # ~8k.
    raw_points = cloud.points
    if n_rays > chunk:
        p_world = transforms.apply_isometry(X_GC, raw_points)
        origin = X_GC[:3, 3]
        start_i = spec.location_in_grid_frame_to_grid_index(origin)
        final_i = spec.location_in_grid_frame_to_grid_index(p_world)
        m_est = (jnp.abs(final_i[:, 0] - start_i[0])
                 + jnp.abs(final_i[:, 1] - start_i[1]))
        m_est = jnp.where(jnp.all(jnp.isfinite(raw_points), axis=-1),
                          m_est, jnp.int32(0))
        order = jnp.argsort(m_est)
        raw_points = raw_points[order]

    points = jnp.pad(raw_points, ((0, pad), (0, 0)),
                     constant_values=jnp.inf)
    points = points.reshape(-1, chunk, 3)

    use_diff = accumulate == "diff"
    if accumulate not in ("rows", "diff"):
        raise ValueError(f"Unknown accumulate mode {accumulate!r}")

    def chunk_body(carry, chunk_points):
        free_acc, free_pt_counts, filled_counts = carry
        (p_start, start_idx, p_final, final_idx, ray, hit,
         clipped) = _prepare_rays(spec, X_GC, chunk_points, cloud.max_range,
                                  slab_axis_order=slab_axis_order)
        if use_diff:
            free_acc = _column_carve_chunk_diff(
                spec, p_start, start_idx, final_idx, ray, hit, free_acc,
                m_max, **tie_flags)
        else:
            free_acc = _column_carve_chunk(
                spec, p_start, start_idx, final_idx, ray, hit, free_acc,
                m_max, voxel_budget=voxel_budget, **tie_flags)
        final_in = spec.check_grid_index_in_bounds(final_idx)
        endpoint_flat = jnp.where(
            hit & final_in, spec.flat_index(final_idx).astype(jnp.int32), -1)
        free_flat = jnp.where(clipped, endpoint_flat, -1)
        filled_flat = jnp.where(clipped, -1, endpoint_flat)
        free_pt_counts = _scatter_counts(free_pt_counts, free_flat)
        return (free_acc, free_pt_counts,
                _scatter_counts(filled_counts, filled_flat)), None

    vary = jnp.any(jnp.zeros((), dtype=bool) & jnp.isfinite(points[0, 0, 0]))
    vary_i = jnp.where(vary, 1, 0).astype(jnp.int32)
    if use_diff:
        zero_acc = vary_i + jnp.zeros((10, nx * ny, nz + 2), jnp.int32)
    else:
        zero_acc = vary_i + jnp.zeros((nx * ny, nz), jnp.int32)
    zero_counts = vary_i + jnp.zeros(spec.num_total, jnp.int32)
    (free_acc, free_pt_counts, filled_counts), _ = lax.scan(
        chunk_body, (zero_acc, zero_counts, zero_counts), points)
    if use_diff:
        free_counts = _combine_diff_buckets(spec, free_acc).reshape(-1)
    else:
        free_counts = free_acc.reshape(-1)
    free_counts = free_counts + free_pt_counts
    return TrackingGrid(seen_free=free_counts.reshape(spec.counts),
                        seen_filled=filled_counts.reshape(spec.counts))


def _policy_sample(pts_dev, k: int = 2048):
    """~``k``-point subsample for the eager run-axis policies, ON DEVICE
    before materializing (a full 640x480 cloud would be ~3.7 MB of D2H +
    an O(N) matmul just to pick one of three axes). Golden-ratio stepping
    rather than a fixed stride: structured depth-image clouds are laid out
    scanline-major, and a stride that divides (or resonates with) the row
    width samples one image COLUMN — a spatially biased subset that can
    misestimate the dominant axis. A step at the
    golden fraction of N, forced coprime with N, is maximally
    non-resonant with every row width. Speed policy only: the column
    carve is bit-exact with the walk for ANY axis choice."""
    n_pts = pts_dev.shape[0]
    if n_pts <= k:
        return pts_dev
    step = max(1, int(round(n_pts * 0.6180339887498949)))
    while np.gcd(step, n_pts) != 1:
        step += 1
    idx = (np.arange(k, dtype=np.int64) * step) % n_pts
    return pts_dev[idx]


def dominant_ray_axis(cloud: PointCloud,
                      grid_origin_transform=None) -> int:
    """Best ``run_axis`` for :func:`raycast_pointcloud_columns`: the GRID
    axis most aligned with the cloud's mean ray direction (eager helper —
    call with concrete data, not under jit)."""
    pts = np.asarray(_policy_sample(cloud.points))
    finite = np.all(np.isfinite(pts), axis=-1)
    if not finite.any():
        return 2
    X_GC = np.asarray(cloud.origin_transform, np.float64)
    if grid_origin_transform is not None:
        X_GC = np.linalg.inv(np.asarray(grid_origin_transform,
                                        np.float64)) @ X_GC
    mean_dir = (pts[finite] @ X_GC[:3, :3].T).mean(axis=0)
    return int(np.argmax(np.abs(mean_dir)))


def pick_run_axis(cloud: PointCloud, grid_origin_transform=None,
                  split_threshold: float = 0.75) -> Union[int, str]:
    """Eager ``run_axis`` policy for :func:`raycast_pointcloud_columns`:
    the dominant GRID axis when at least ``split_threshold`` of (sampled)
    rays share it, else ``"split"`` (per-ray dominant axes — oblique
    camera bundles whose rays straddle axis boundaries carve each ray in
    its own best frame). Like :func:`dominant_ray_axis` this is a speed
    policy only — every choice is bit-exact with the voxel walk."""
    pts = np.asarray(_policy_sample(cloud.points))
    finite = np.all(np.isfinite(pts), axis=-1)
    if not finite.any():
        return 2
    X_GC = np.asarray(cloud.origin_transform, np.float64)
    if grid_origin_transform is not None:
        X_GC = np.linalg.inv(np.asarray(grid_origin_transform,
                                        np.float64)) @ X_GC
    dirs = pts[finite] @ X_GC[:3, :3].T
    per_ray = np.argmax(np.abs(dirs), axis=-1)
    counts = np.bincount(per_ray, minlength=3)
    top = int(counts.argmax())
    if counts[top] >= split_threshold * counts.sum():
        return top
    return "split"


def raycast_single_point(spec: GridSpec, grid_origin_transform: Array,
                         p_world_origin, p_world_point,
                         max_range: float = float("inf"),
                         max_steps: Optional[int] = None) -> TrackingGrid:
    """``CpuPointCloudVoxelizer::RaycastSinglePoint`` (cpu cpp:81-109): carve a
    single origin->point ray given in the *grid frame* (the reference API
    takes grid-frame p_GCo/p_GP; pass an identity grid transform for that)."""
    origin = jnp.asarray(p_world_origin, jnp.float32)[:3]
    point = jnp.asarray(p_world_point, jnp.float32)[:3]
    # The cloud's camera frame is a pure translation to the ray origin, so the
    # camera-frame point is the world offset from that origin.
    cloud = PointCloud.create(
        (point - origin).reshape(1, 3),
        origin_transform=transforms.isometry_from_translation(origin),
        max_range=max_range)
    return raycast_pointcloud(spec, grid_origin_transform, cloud, max_steps)


def counts_seen_as(options: FilterOptions, seen_free: Array,
                   seen_filled: Array) -> Array:
    """Vectorized ``CountsSeenAs`` voting rule (hpp:55-86). Returns int8
    SeenAs codes."""
    filtered_filled = jnp.where(
        seen_filled >= options.outlier_points_threshold, seen_filled, 0)
    both = (seen_free > 0) & (filtered_filled > 0)
    pct = seen_free.astype(jnp.float32) / jnp.maximum(
        (seen_free + filtered_filled).astype(jnp.float32), 1.0)
    both_result = jnp.where(pct >= options.percent_seen_free,
                            SeenAs.FREE, SeenAs.FILLED)
    result = jnp.where(
        both, both_result,
        jnp.where(seen_free > 0, SeenAs.FREE,
                  jnp.where(filtered_filled > 0, SeenAs.FILLED,
                            SeenAs.UNKNOWN)))
    return result.astype(jnp.int8)


def combine_and_filter(options: FilterOptions, seen_free: Array,
                       seen_filled: Array, occupancy: Array) -> Array:
    """Fuse stacked per-camera counters ``[C, nx, ny, nz]`` into occupancy
    (``DoCombineAndFilterGrids``, cpu cpp:438-497). Filled static cells are
    left untouched; others become filled if any camera saw a hit, free if
    enough cameras saw through, else unknown."""
    seen = counts_seen_as(options, seen_free, seen_filled)  # [C, ...]
    cameras_filled = jnp.sum((seen == SeenAs.FILLED).astype(jnp.int32),
                             axis=0)
    cameras_free = jnp.sum((seen == SeenAs.FREE).astype(jnp.int32), axis=0)
    fused = jnp.where(
        cameras_filled > 0, jnp.float32(1.0),
        jnp.where(cameras_free >= options.num_cameras_seen_free,
                  jnp.float32(0.0), jnp.float32(0.5)))
    return jnp.where(occupancy <= 0.5, fused, occupancy)


def voxelize_pointclouds(
        static_environment: OccupancyMap,
        filter_options: FilterOptions,
        pointclouds: Sequence[PointCloud],
        runtime_log_fn: Optional[Callable[[VoxelizerRuntime], None]] = None,
        max_steps: Optional[int] = None) -> OccupancyMap:
    """End-to-end ``VoxelizePointClouds`` (pointcloud_voxelization_interface.
    hpp:246-292): carve each cloud into its own tracking grid, then fuse.
    Wall times for the two phases are reported like ``VoxelizerRuntime``
    when called eagerly; under jit the runtime reports zeros (see
    :class:`VoxelizerRuntime` for the contract and why)."""
    filter_options.validate()
    spec = static_environment.spec

    # Phase sync points only exist outside a trace: under jit the whole
    # pipeline fuses and the per-phase VoxelizerRuntime is reported as
    # zeros (the caller times the fused call instead).
    def _sync(x):
        if runtime_log_fn is not None:
            jax.block_until_ready(x)  # a no-op on tracers

    t0 = time.monotonic()
    if pointclouds:
        grids = [raycast_pointcloud(spec,
                                    static_environment.origin_transform,
                                    cloud, max_steps)
                 for cloud in pointclouds]
        seen_free = jnp.stack([g.seen_free for g in grids])
        seen_filled = jnp.stack([g.seen_filled for g in grids])
    else:
        seen_free = jnp.zeros((0,) + spec.counts, jnp.int32)
        seen_filled = jnp.zeros((0,) + spec.counts, jnp.int32)
    _sync(seen_free)
    t1 = time.monotonic()

    occupancy = combine_and_filter(filter_options, seen_free, seen_filled,
                                   static_environment.occupancy)
    _sync(occupancy)
    t2 = time.monotonic()

    if runtime_log_fn is not None:
        runtime_log_fn(VoxelizerRuntime(t1 - t0, t2 - t1))
    return static_environment.replace(occupancy=occupancy)
