"""Differentiable SDF raycasting / sphere tracing.

This is new accelerator-native capability built *on top of* the reference's query
primitives (the reference has no renderer; its raycasting — cpu DDA carving —
is reproduced in :mod:`.voxelize`): a sphere-traced depth/occupancy renderer
over :class:`SignedDistanceField` grids in which **pixel gradients flow back
to voxel distances and to the camera pose** (the BASELINE.json north star).

Design:

* rays are generated from a pinhole camera (pose = ``[4,4]`` isometry leaf, so
  ``jax.grad`` reaches translation/rotation through ray origins/directions),
* marching is a fixed-length ``lax.scan`` (static trip count -> reverse-mode
  AD and remat work; converged rays keep ``dt = 0`` so extra iterations are
  no-ops in both value and gradient),
* distance samples use the trilinear interpolation from
  :mod:`.sdf_query` — continuous in position and linear in the voxel values,
* rays are first clipped to the grid AABB with a slab test so marching starts
  at the grid boundary; rays that miss return ``hit=False`` with depth at
  ``max_depth``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import transforms
from ..core.maps import SignedDistanceField
from . import sdf_query

Array = jnp.ndarray

# Either acceleration table works on every render path (the pair table is
# the large-grid variant; estimate_location_distance_fast dispatches on
# row width).
_AnyCornerTable = Union[sdf_query.CornerTable, sdf_query.CornerPairTable]


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole camera: intrinsics + world-from-camera pose. The optical
    convention is +z forward, +x right, +y down (standard depth camera)."""
    pose: Array  # [4,4] X_WC
    fx: Array
    fy: Array
    cx: Array
    cy: Array
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def create(pose, width: int, height: int,
               focal: Optional[float] = None, fx=None, fy=None,
               cx=None, cy=None) -> "PinholeCamera":
        if focal is not None:
            fx = fy = focal
        if fx is None or fy is None:
            raise ValueError(
                "PinholeCamera.create needs focal= (sets both) or fx= and "
                "fy= explicitly")
        if cx is None:
            cx = (width - 1) / 2.0
        if cy is None:
            cy = (height - 1) / 2.0
        return PinholeCamera(
            pose=jnp.asarray(pose, jnp.float32),
            fx=jnp.float32(fx), fy=jnp.float32(fy),
            cx=jnp.float32(cx), cy=jnp.float32(cy),
            width=int(width), height=int(height))


PinholeCamera = jax.tree_util.register_dataclass(
    PinholeCamera,
    data_fields=["pose", "fx", "fy", "cx", "cy"],
    meta_fields=["width", "height"])


class RenderResult(NamedTuple):
    depth: Array      # [H, W] ray depth (t along unit ray direction)
    hit: Array        # [H, W] bool, surface hit within max_depth
    points: Array     # [H, W, 3] final world-space sample positions
    distance: Array   # [H, W] final SDF sample value


class SdfMip(NamedTuple):
    """Conservative coarse lower-bound grid for empty-space skipping.

    ``values[b]`` lower-bounds the true SDF anywhere inside coarse block
    ``b``: ``min-pool(distances, factor) - half_block_diagonal`` (valid
    because ``|grad d| <= 1`` for a metric SDF). One nearest-neighbor gather
    from this small table is a safe sphere-tracing step, so rays cross empty
    space in ``O(extent / block)`` cheap steps before any fine trilinear
    sampling happens."""
    values: Array        # f32 [ncx * ncy * ncz] flattened coarse blocks
    coarse_counts: Tuple[int, int, int]
    factor: int
    block_size: float    # factor * resolution (meters)


def build_sdf_mip(sdf: SignedDistanceField, factor: int = 8) -> SdfMip:
    """Min-pool the SDF into ``factor^3`` blocks and subtract the block
    half-diagonal, yielding a per-block lower bound on distance."""
    nx, ny, nz = sdf.spec.counts
    f = int(factor)
    pcx, pcy, pcz = (-nx) % f, (-ny) % f, (-nz) % f
    d = jnp.pad(jnp.asarray(sdf.distances, jnp.float32),
                ((0, pcx), (0, pcy), (0, pcz)), constant_values=jnp.inf)
    cx, cy, cz = d.shape[0] // f, d.shape[1] // f, d.shape[2] // f
    pooled = d.reshape(cx, f, cy, f, cz, f).min(axis=(1, 3, 5))
    # For any x in the block, the center c_x of x's FINE cell is one of the
    # pooled centers, so d(x) >= d(c_x) - |x - c_x| >= min_pool - (sqrt(3)/2)
    # * resolution (half a fine-cell diagonal, independent of the block
    # factor). The march compares against CORRECTED distances (stored value
    # pulled 0.5*res toward the surface, sdf_query.py), so the bound must
    # also cover that half-voxel shift: margin = (sqrt(3)/2 + 0.5) * res.
    margin = jnp.float32(
        (0.5 * float(np.sqrt(3.0)) + 0.5) * sdf.spec.resolution)
    return SdfMip(values=(pooled - margin).reshape(-1),
                  coarse_counts=(cx, cy, cz), factor=f,
                  block_size=f * sdf.spec.resolution)


def camera_rays(camera: PinholeCamera) -> Tuple[Array, Array]:
    """World-frame ray origins ``[H,W,3]`` and unit directions ``[H,W,3]``."""
    u = jnp.arange(camera.width, dtype=jnp.float32)
    v = jnp.arange(camera.height, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v, indexing="xy")
    dirs_cam = jnp.stack([
        (uu - camera.cx) / camera.fx,
        (vv - camera.cy) / camera.fy,
        jnp.ones_like(uu),
    ], axis=-1)
    dirs_cam = dirs_cam / jnp.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    dirs_world = transforms.rotate_vector(camera.pose, dirs_cam)
    origins = jnp.broadcast_to(camera.pose[:3, 3], dirs_world.shape)
    return origins, dirs_world


def _clip_to_grid(sdf: SignedDistanceField, origins: Array,
                  dirs: Array) -> Tuple[Array, Array, Array]:
    """Slab-clip rays to the grid AABB in grid frame. Returns
    (t_enter, t_exit, hits_grid)."""
    inv = sdf.inverse_origin_transform()
    o_grid = transforms.apply_isometry(inv, origins)
    d_grid = transforms.rotate_vector(inv, dirs)
    sizes = jnp.asarray(sdf.spec.grid_sizes, jnp.float32)

    safe_d = jnp.where(jnp.abs(d_grid) < 1e-12,
                       jnp.where(d_grid < 0, -1e-12, 1e-12), d_grid)
    t_low = (0.0 - o_grid) / safe_d
    t_high = (sizes - o_grid) / safe_d
    t1 = jnp.minimum(t_low, t_high)
    t2 = jnp.maximum(t_low, t_high)
    t_enter = jnp.max(t1, axis=-1)
    t_exit = jnp.min(t2, axis=-1)
    hits = (t_exit > jnp.maximum(t_enter, 0.0))
    return jnp.maximum(t_enter, 0.0), t_exit, hits


def sphere_trace(sdf: SignedDistanceField, origins: Array, dirs: Array,
                 num_steps: int = 64,
                 surface_threshold: Optional[float] = None,
                 max_depth: float = 100.0,
                 step_scale: float = 1.0,
                 corner_table: Optional[_AnyCornerTable] = None,
                 early_exit: bool = False,
                 mip: Optional[SdfMip] = None,
                 coarse_steps: int = 64,
                 head_steps: int = 8,
                 tail_chunks: int = 8,
                 t_init: Optional[Array] = None,
                 t_init_valid_from: Optional[Array] = None,
                 sort_key: Optional[Array] = None,
                 certified_miss: Optional[Array] = None,
                 sort_block: int = 1,
                 relax: float = 1.0,
                 remat: bool = False,
                 with_stats: bool = False):
    """Sphere-trace rays through an SDF grid.

    ``origins``/``dirs`` are ``[..., 3]`` world frame. The march advances each
    ray by its sampled distance (classic sphere tracing) until the sample
    falls below ``surface_threshold`` (default: half a voxel — the corrected-
    center distance of :mod:`.sdf_query` is zero at the surface, half-voxel
    keeps marching stable at coarse grids), the ray exits the grid, or
    ``num_steps`` is exhausted.

    Performance knobs (``corner_table``/``early_exit``/``head_steps``/
    ``tail_chunks`` preserve exact sampling semantics; ``t_init`` — a
    certified deeper start — changes the sample SEQUENCE, so depths agree
    with the plain march within the convergence threshold and hits are a
    superset for every ray whose query actually CROSSES the threshold:
    the sphere-trace map ``t -> t + d(t)`` is monotone for a 1-Lipschitz
    field, so a certified-safe skip can't cross a surface the plain march
    would find. The one exception class is tangent GRAZERS — rays whose
    query merely dips to within float-noise of ``surface_threshold``
    without crossing it (no root, a measure-~zero ``q <= thresh`` sliver
    narrower than the local step size). Whether any sample lands inside
    such a sliver is decided by the sample sequence, so those pixels can
    classify either way under ANY resampling — measured on the 512^3
    sphere at focal 600: 8 of 307k pixels, all with min query within
    1.6% of thresh, certificates uninvolved (the block cones died
    conservatively BEFORE the dip). This is the same marginal-silhouette
    divergence class the reference accepts between its own CPU (double)
    and CUDA/OpenCL (float) backends.):

    * ``corner_table``: a prebuilt :class:`sdf_query.CornerTable` — trilinear
      samples cost ONE gather instead of eight.
    * ``early_exit``: march under ``lax.while_loop`` and stop as soon as every
      ray has converged or left the grid, instead of a fixed ``num_steps``
      scan. Inference-only: while_loop does not support reverse-mode AD, so
      leave False (the default) when differentiating through the render.
    * ``mip``: a prebuilt :class:`SdfMip` — rays first skip empty space with
      up to ``coarse_steps`` conservative coarse-block jumps (cheap
      nearest-neighbor gathers from the small mip table; jumps shrink by
      the convergence band ``thresh + (sqrt(3)/2)*res`` so they can neither
      cross the surface nor leapfrog a grazing ``query <= thresh`` dip).
      Same contract as the cone prepass: hits are a SUPERSET of the plain
      march's and common depths agree within the convergence threshold.
      Inference-only (while_loop; no gradient contribution from the skip).
    * ``head_steps`` / ``tail_chunks`` (early_exit mode only): after
      ``head_steps`` full-width fine steps, still-alive rays (typically the
      silhouette-grazing few percent) are compacted to the front by a stable
      sort and the remaining budget is marched in ``tail_chunks`` ray chunks,
      each under its own while_loop — all-converged chunks cost one step
      instead of dragging the whole wave to ``num_steps`` (gathers are
      issued per active row, so wave width is the cost).
    * ``certified_miss`` (early_exit mode only): a bool array marking rays
      the caller PROVED cannot meet the surface anywhere in
      ``[t_init_valid_from, t_init]`` (the cone prepass's escape
      certificate). Such rays — when their own in-grid span lies inside
      that interval — are retired before the tail march entirely; they
      still receive the standard final sample, so outputs are unchanged.
    * ``sort_block`` (with ``tail_chunks``): treat each run of
      ``sort_block`` consecutive rays as ONE sort unit — the compaction
      argsort runs over ``n / sort_block`` keys (block key = most-urgent
      ray's key) and the permute moves whole contiguous row blocks, which
      the gather engine services at near row rate instead of per scalar.
      The caller must lay rays out so blocks are contiguous
      (:func:`render_depth` does this for cone blocks).
    * ``relax`` (early_exit mode only): over-relaxed sphere tracing
      (Keinert et al. 2014, "Enhanced Sphere Tracing"). Steps advance by
      ``relax * d`` instead of ``d``; a step is kept only if the next
      sample satisfies ``step <= d_prev + d_new`` (the two step spheres
      overlap), otherwise the march REVERTS to the classic step from the
      previous sample — for a field with the distance property
      ``|f(x)| <= dist(x, surface)`` a zero crossing inside the stepped
      segment forces ``d_new <= step - d_prev``, so no crossing is ever
      stepped over un-reverted, and reverted re-steps are classic (never
      themselves reverted, so an interpolation artifact cannot revert-
      loop). Cost: one discarded sample per revert; gain: eps-floor
      silhouette crawlers advance ``relax`` x farther per sample. Hits
      may differ from the plain march ONLY in the tangent-grazer class
      above (samples land ``~relax`` x sparser in a sub-threshold dip,
      so the detection band widens by that factor); converged depths
      still agree within the convergence threshold because convergence
      is only ever declared on un-reverted samples. ``1.0`` (default)
      compiles the classic march bit-identically; useful range is
      1.2-1.9 (``relax >= 2`` would make even an exact-field classic
      re-step trigger the overlap test at equality). Inference-only.
    * ``with_stats``: also return a dict of per-phase WORK COUNTERS —
      the while-loop iteration counts each phase actually executed
      (``fine_head_iters`` scalar, ``fine_tail_iters [tail_chunks]``) and
      the static widths they ran at (``fine_head_width``,
      ``fine_tail_chunk_width``, ``fine_sort_blocks``,
      ``fine_sort_arrays``). One iteration issues exactly one gather row
      per lane of its phase width, so ``sum(iters * width)`` is the
      frame's gather-row count. Counters ride the existing loop
      carries — no extra work per iteration; the extra OUTPUTS can shift
      XLA fusion, so results agree with the default path to the ulp
      rather than bitwise.
    """
    if surface_threshold is None:
        surface_threshold = 0.25 * sdf.resolution
    relax = float(relax)
    if relax < 1.0:
        # Under-relaxation is spelled step_scale (< 1) — a silent overlap
        # of the two knobs would double-apply the scaling.
        raise ValueError(f"relax={relax} must be >= 1.0 "
                         "(use step_scale for under-relaxation)")
    if relax > 1.0 and not early_exit:
        raise ValueError("relax > 1 requires early_exit=True (the revert "
                         "logic lives in the while-loop march; the "
                         "differentiable scan path stays classic)")
    thresh = jnp.float32(surface_threshold)
    eps = jnp.float32(1e-3 * sdf.resolution)

    if corner_table is not None:
        def sample(pos):
            return sdf_query.estimate_location_distance_fast(
                sdf, corner_table, pos)

        def sample_valid(pos):
            return sdf_query.location_query_valid(
                sdf, pos, corner_table.rows.dtype)
    else:
        def sample(pos):
            return sdf_query.estimate_location_distance(sdf, pos)

        def sample_valid(pos):
            return sdf_query.location_query_valid(sdf, pos)

    t_enter, t_exit, hits_grid = _clip_to_grid(sdf, origins, dirs)
    t0 = jnp.where(hits_grid, t_enter + eps, jnp.float32(max_depth))
    t_stop = jnp.minimum(t_exit, jnp.float32(max_depth))
    killed = None
    if certified_miss is not None and t_init is not None and early_exit:
        # The miss certificate covers [t_init_valid_from, t_init]; a ray
        # whose own in-grid span sits inside it provably never converges,
        # so skip its march (it keeps the standard final sample below —
        # identical outputs, the certificate guarantees no hit).
        killed = jnp.asarray(certified_miss) \
            & (t_stop <= jnp.asarray(t_init, jnp.float32))
        if t_init_valid_from is not None:
            killed = killed & (
                t_enter >= jnp.asarray(t_init_valid_from, jnp.float32))
    if t_init is not None:
        # Caller-provided certified-safe starting depths (e.g. the cone
        # prepass of render_depth): never BEFORE the grid entry.
        ti = jnp.minimum(jnp.asarray(t_init, jnp.float32), t_stop)
        if t_init_valid_from is not None:
            # The certificate only covers [t_init_valid_from, t_init]: a
            # ray entering the grid before the certifying march STARTED has
            # an uncertified window [t_enter, t_init_valid_from) that could
            # contain a surface — use its own entry instead (the fixed
            # cone-start slack does not bound fine entries for distant
            # grids / grazing faces).
            ti = jnp.where(
                t_enter >= jnp.asarray(t_init_valid_from, jnp.float32),
                ti, t0)
        t0 = jnp.maximum(t0, ti)

    if mip is not None:
        # Empty-space skip: advance each ray by the conservative coarse
        # lower bound until the bound says the surface is within one block.
        # The jump must shrink by the CONVERGENCE BAND, not just the true
        # surface: the fine march converges where the corrected query dips
        # <= thresh, i.e. anywhere the metric distance D <= thresh + delta
        # (|query - D| <= delta). mip.values already cover delta's
        # half-voxel terms; the remaining uncovered band is
        # thresh + (sqrt(3)/2) * res, and an unshrunk jump could leapfrog a
        # grazing dip entirely (hits flipped on a far-obstacle scene,
        # test_mip_skip_grazing_band).
        inv = sdf.inverse_origin_transform()
        ncx, ncy, ncz = mip.coarse_counts
        block = jnp.float32(mip.block_size)
        switch = jnp.float32(mip.block_size)
        band = thresh + jnp.float32(
            0.5 * float(np.sqrt(3.0)) * sdf.resolution)

        def coarse_bound(t):
            pos = origins + dirs * t[..., None]
            p_grid = transforms.apply_isometry(inv, pos)
            ci = jnp.floor(p_grid / block).astype(jnp.int32)
            ci = jnp.clip(ci, 0, jnp.asarray((ncx - 1, ncy - 1, ncz - 1),
                                             jnp.int32))
            flat = ci[..., 0] * (ncy * ncz) + ci[..., 1] * ncz + ci[..., 2]
            return mip.values[flat]

        def skip_cond(carry):
            i, _, skipping = carry
            return (i < coarse_steps) & jnp.any(skipping)

        def skip_body(carry):
            i, t, skipping = carry
            advance = coarse_bound(t) - band
            can_skip = advance > switch
            new_t = jnp.where(skipping & can_skip, t + advance, t)
            still = skipping & can_skip & (new_t < t_stop)
            return i + 1, new_t, still

        _, t0, _ = lax.while_loop(skip_cond, skip_body,
                                  (jnp.int32(0), t0, hits_grid))

    def advance_ray(t, alive, o, d_ray, stop):
        pos = o + d_ray * t[..., None]
        q = sample(pos)
        d = jnp.where(q.valid, q.value, thresh)  # nudge forward if outside
        converged = q.valid & (d <= thresh)
        advance = jnp.maximum(d * step_scale, eps)
        new_t = jnp.where(alive & ~converged, t + advance, t)
        new_alive = alive & ~converged & (new_t < stop)
        return new_t, new_alive, d, converged

    def advance_once(t, alive):
        new_t, new_alive, _, _ = advance_ray(t, alive, origins, dirs, t_stop)
        return new_t, new_alive

    def march_while(t_init, alive_init, o, d_ray, stop, budget,
                    d_cur0=None, conv0=None):
        # ``conv`` marks rays that CONVERGED (as opposed to escaping or
        # exhausting the budget): for those, ``t`` stopped AT the last
        # sampled position, so the carried ``d_cur`` IS the field value at
        # the final point — the sparse final sample below reuses it
        # instead of re-gathering. ``d_cur0``/``conv0`` thread a previous
        # phase's carry through (head -> sorted tail).
        big = jnp.float32(1e30)

        def cond(carry):
            i = carry[0]
            alive = carry[2]
            return (i < budget) & jnp.any(alive)

        def body(carry):
            i, t, alive, d_prev, d_cur, conv = carry
            new_t, new_alive, d, converged = advance_ray(
                t, alive, o, d_ray, stop)
            d_prev = jnp.where(alive, d_cur, d_prev)
            d_cur = jnp.where(alive, d, d_cur)
            conv = conv | (alive & converged)
            return i + 1, new_t, new_alive, d_prev, d_cur, conv

        def body_relaxed(carry):
            # Over-relaxed variant (``relax`` > 1, see the docstring): the
            # carry additionally tracks the advance just taken and whether
            # it was a relaxed (unverified) one. Only relaxed steps are
            # ever reverted; revert re-steps are classic, so a field-
            # artifact negative sample cannot revert-loop. All extra work
            # is elementwise ops on the existing loop carry — the gather count per
            # iteration is unchanged (one sample row per lane).
            i, t, alive, d_prev, d_cur, conv, last_adv, was_relaxed = carry
            pos = o + d_ray * t[..., None]
            q = sample(pos)
            # Overshoot test value: an OUT-OF-GRID sample proves nothing
            # about the skipped segment, so it must test as 0 (always
            # revert an unverified step that ran off the grid), not as the
            # nudge value ``thresh`` the march otherwise substitutes.
            d_test = jnp.where(q.valid, q.value, 0.0)
            overshoot = alive & was_relaxed & (last_adv > d_cur + d_test)
            d = jnp.where(q.valid, q.value, thresh)
            converged = q.valid & (d <= thresh) & ~overshoot
            classic = jnp.maximum(d * step_scale, eps)
            classic_prev = jnp.maximum(d_cur * step_scale, eps)
            # Relax only TANGENTIAL rays — those whose sampled distance is
            # decaying at less than half the march rate (silhouette
            # crawlers; the nearest surface point is moving with them). A
            # head-on ray has d decaying at ~the full step size, so every
            # relaxed step would fail the overlap test and be reverted —
            # on the bench sphere, uniformly relaxing INCREASED frame rows
            # 6-19% (counted gather rows, not a time).
            tangential = (d_cur - d) < jnp.float32(0.5) * last_adv
            adv = jnp.where(tangential,
                            jnp.maximum(d * step_scale * jnp.float32(relax),
                                        eps),
                            classic)
            new_t = jnp.where(
                overshoot, t - last_adv + classic_prev,
                jnp.where(alive & ~converged, t + adv, t))
            new_adv = jnp.where(overshoot, classic_prev, adv)
            new_relaxed = tangential & ~overshoot
            # Exit is decided by the CLASSIC step's guarantee (no crossing
            # within [t, t + d)): a relaxed step that lands past ``stop``
            # has NOT proven the segment empty, so the ray stays alive and
            # the out-of-grid sample above reverts it next iteration.
            escaped = ~overshoot & (t + classic >= stop)
            new_alive = alive & ~converged & ~escaped
            d_prev = jnp.where(alive & ~overshoot, d_cur, d_prev)
            d_cur = jnp.where(alive & ~overshoot, d, d_cur)
            conv = conv | (alive & converged)
            return (i + 1, new_t, new_alive, d_prev, d_cur, conv,
                    new_adv, new_relaxed)

        # Derive the initial carries from the inputs so their varying
        # manual axes match the body outputs under shard_map.
        d0 = t_init * 0.0 + big
        dc0 = d0 if d_cur0 is None else d_cur0
        cv0 = (alive_init ^ alive_init) if conv0 is None else conv0
        if relax > 1.0:
            (iters, t_out, alive_out, d_prev, d_cur, conv_out, _,
             _) = lax.while_loop(
                cond, body_relaxed,
                (jnp.int32(0), t_init, alive_init, d0, dc0, cv0, d0 * 0.0,
                 alive_init ^ alive_init))
            return t_out, alive_out, d_prev, d_cur, conv_out, iters
        iters, t_out, alive_out, d_prev, d_cur, conv_out = lax.while_loop(
            cond, body, (jnp.int32(0), t_init, alive_init, d0, dc0, cv0))
        return t_out, alive_out, d_prev, d_cur, conv_out, iters

    alive0 = hits_grid if mip is None else (hits_grid & (t0 < t_stop))
    if killed is not None:
        alive0 = alive0 & ~killed
    stats = {}
    d_carried = sparse_block = None  # set by the block-sorted tail
    if early_exit:
        head = min(int(head_steps), num_steps) if tail_chunks > 1 \
            else num_steps
        if head > 0:
            t_final, alive, d_prev, d_cur, conv, head_iters = march_while(
                t0, alive0, origins, dirs, t_stop, head)
            stats["fine_head_iters"] = head_iters
        else:
            # head_steps=0: no full-width fine steps at all — the caller
            # must supply `sort_key` (e.g. the cone-depth edge key of
            # render_depth) so the convergence sort has something to
            # cluster slow rays by.
            t_final, alive = t0, alive0
            d_prev = d_cur = None
            conv = jnp.zeros_like(alive0)
            stats["fine_head_iters"] = jnp.int32(0)
        stats["fine_head_width"] = int(np.prod(t_final.shape)) \
            if t_final.shape else 1
        remaining = num_steps - head
        if remaining > 0 and tail_chunks > 1:
            # Compact still-alive rays ordered by ESTIMATED remaining steps
            # (current distance over its last per-step decrease — a
            # geometric-decay extrapolation). A chunk's tail cost is its
            # SLOWEST ray, so grouping rays by expected convergence keeps
            # grazing/silhouette rays in one chunk instead of making every
            # live chunk pay the worst-case budget (the dominant tail term:
            # cost ~= live_chunks x worst_steps x chunk width).
            batch_shape = t_final.shape
            n = int(np.prod(batch_shape)) if batch_shape else 1
            k = int(tail_chunks)
            bs = int(sort_block) if sort_block and n % sort_block == 0 \
                else 1
            # Pad in whole sort blocks so block units stay intact.
            nb = n // bs
            pad_b = (-nb) % k
            pad = pad_b * bs
            chunk = (n + pad) // k

            def flat_pad(x, fill):
                x = x.reshape((n,) + x.shape[len(batch_shape):])
                cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
                return jnp.pad(x, cfg, constant_values=fill)

            alive_f = flat_pad(alive, False)
            if d_cur is not None:
                decay = flat_pad(d_prev - d_cur, 0.0)
                steps_est = flat_pad(d_cur, 0.0) / jnp.maximum(decay, eps)
            elif sort_key is not None:
                # Caller-supplied slowness estimate (no fine samples yet):
                # larger = slower, so negate for the ascending sort.
                steps_est = -flat_pad(
                    jnp.asarray(sort_key, jnp.float32), 0.0)
            else:
                steps_est = flat_pad(t_final * 0.0, 0.0)
            key = jnp.where(alive_f, steps_est, jnp.float32(3e30))
            if bs > 1:
                # Sort at BLOCK granularity: one key per contiguous
                # sort_block run (its most-urgent live ray), and permute
                # whole [bs]-row units — the gather engine moves 4*bs-byte
                # rows at near scalar-row cost, so the compaction permute
                # drops from n row-gathers to n/bs.
                order_b = jnp.argsort(key.reshape(-1, bs).min(axis=1),
                                      stable=True)

                def permute(x):
                    rows = x.reshape((nb + pad_b, bs) + x.shape[1:])
                    return rows[order_b].reshape(x.shape)
            else:
                order = jnp.argsort(key, stable=True)

                def permute(x):
                    return x[order]

            t_s = permute(flat_pad(t_final, 0.0))
            alive_s = permute(alive_f)
            o_s = permute(flat_pad(
                jnp.broadcast_to(origins, batch_shape + (3,)), 0.0))
            d_s = permute(flat_pad(
                jnp.broadcast_to(dirs, batch_shape + (3,)), 0.0))
            stop_s = permute(flat_pad(
                jnp.broadcast_to(t_stop, batch_shape), 0.0))
            big = jnp.float32(1e30)
            # Thread the head phase's last-sample carry into the tail so
            # the final merged (d_cur, conv) cover BOTH phases; with
            # head_steps=0 these are constants (no permute rows).
            dc0_s = (permute(flat_pad(d_cur, big)) if d_cur is not None
                     else t_s * 0.0 + big)
            cv0_s = (permute(flat_pad(conv, False)) if d_cur is not None
                     else alive_s ^ alive_s)

            def march_chunk(args):
                t_c, alive_c, o_c, d_c, stop_c, dc_c, cv_c = args
                t_out, _, _, d_last, conv_o, i_out = march_while(
                    t_c, alive_c, o_c, d_c, stop_c, remaining,
                    d_cur0=dc_c, conv0=cv_c)
                return (t_out, d_last, conv_o), i_out

            # lax.map compiles the chunk body once and runs chunks
            # sequentially — all-dead chunks cost a single alive check.
            (t_sorted, dl_sorted, cv_sorted), tail_iters = lax.map(
                march_chunk, (
                    t_s.reshape(k, chunk), alive_s.reshape(k, chunk),
                    o_s.reshape(k, chunk, 3), d_s.reshape(k, chunk, 3),
                    stop_s.reshape(k, chunk), dc0_s.reshape(k, chunk),
                    cv0_s.reshape(k, chunk)))
            stats["fine_tail_iters"] = tail_iters          # i32 [k]
            stats["fine_tail_chunk_width"] = chunk
            # Rows the compaction permute moves PER ARRAY: whole
            # sort-blocks when bs > 1, scalar rows otherwise.
            stats["fine_sort_blocks"] = (nb + pad_b) if bs > 1 else (n + pad)
            # Permute gathers in (t, alive, o, d, stop; +dc0/cv0 when a
            # head phase ran) + scatters back (t; +d_last/conv when the
            # sparse final sample below consumes them) — all at sort-block
            # row granularity.
            sparse_final = bs > 1
            stats["fine_sort_arrays"] = (5 + (2 if d_cur is not None else 0)
                                         + (3 if sparse_final else 1))

            if bs > 1:
                def unsort_tail(xs, dtype):
                    return jnp.zeros(
                        (nb + pad_b, bs), dtype).at[order_b].set(
                            xs.reshape(nb + pad_b, bs)).reshape(-1)[:n]
            else:
                def unsort_tail(xs, dtype):
                    return jnp.zeros(
                        n + pad, dtype).at[order].set(xs.reshape(-1))[:n]
            t_final = unsort_tail(t_sorted, t_final.dtype).reshape(
                batch_shape)
            if sparse_final:
                d_carried = unsort_tail(dl_sorted, dl_sorted.dtype)
                conv = unsort_tail(cv_sorted, jnp.bool_).reshape(batch_shape)
                sparse_block = (bs, k)
    else:
        def step(carry, _):
            t, alive = carry
            return advance_once(t, alive), None

        if remat:
            # Rematerialize the march step in the backward pass: reverse-
            # mode over the scan otherwise saves every step's gather
            # indices + trilinear weights (~36 B/ray/step — ~0.7 GB for a
            # 640x480x64 march, quadratic trouble at larger frames).
            # Recomputing a step is one extra gather — cheap against HBM.
            step = jax.checkpoint(step)
        (t_final, alive), _ = lax.scan(step, (t0, alive0), None,
                                       length=num_steps)
        stats["fine_head_iters"] = jnp.int32(num_steps)
        stats["fine_head_width"] = int(np.prod(t_final.shape)) \
            if t_final.shape else 1

    points = origins + dirs * t_final[..., None]
    if d_carried is not None:
        # Sparse final sample (block-tail schedules): most rays' final
        # value is already known without a gather —
        #   * CONVERGED rays stopped AT their last sampled position, so
        #     the march's carried sample IS the final value (bitwise the
        #     same expression on the same position);
        #   * rays whose final position left the grid (march escapes,
        #     grid-missers) provably read ``(inf, False)`` — validity is
        #     pure elementwise math (:func:`sdf_query.location_query_valid`).
        # Real gathers remain only for in-grid non-converged rays:
        # certificate-retired blocks (never marched) and budget-capped
        # crawlers. Those are compacted needs-first at CONE-BLOCK
        # granularity (certificates are per-block, so need is block-
        # coherent) and sampled in chunks that skip when need-free —
        # outputs are unchanged, the dense per-ray final gather
        # (10-43% of frame rows depending on scene) shrinks to the needy
        # fraction. Inference-only like the rest of the early-exit path.
        bs_f, k_f = sparse_block
        n_f = int(np.prod(batch_shape))
        valid = sample_valid(points)
        conv_f = conv.reshape(-1)
        valid_f = valid.reshape(-1)
        needs = valid_f & ~conv_f
        nb2 = n_f // bs_f
        k2 = min(k_f, nb2)
        pad2 = (-nb2) % k2
        block_needs = jnp.pad(needs.reshape(nb2, bs_f).any(axis=1),
                              (0, pad2), constant_values=False)
        order2 = jnp.argsort(~block_needs, stable=True)  # needy first
        pts_sorted = jnp.pad(
            points.reshape(nb2, bs_f, 3),
            ((0, pad2), (0, 0), (0, 0)))[order2]
        bpc = (nb2 + pad2) // k2
        chunk_go = block_needs[order2].reshape(k2, bpc).any(axis=1)
        vdt = (corner_table.rows.dtype if corner_table is not None
               else jnp.asarray(sdf.distances).dtype)

        def sample_chunk(args):
            pts_c, go = args

            def do(_):
                qc = sample(pts_c.reshape(-1, 3))
                return jnp.where(qc.valid, qc.value,
                                 jnp.array(jnp.inf, vdt))

            def skip(_):
                return jnp.full(bpc * bs_f, jnp.inf, vdt)

            return lax.cond(go, do, skip, None), go.astype(jnp.int32)

        vals_sorted, executed = lax.map(sample_chunk,
                                        (pts_sorted.reshape(k2, bpc, bs_f, 3),
                                         chunk_go))
        gathered = jnp.zeros((nb2 + pad2, bs_f), vdt).at[order2].set(
            vals_sorted.reshape(nb2 + pad2, bs_f)).reshape(-1)[:n_f]
        final_d = jnp.where(
            conv_f, d_carried.astype(vdt),
            jnp.where(valid_f, gathered,
                      jnp.array(jnp.inf, vdt))).reshape(batch_shape)
        hit = hits_grid & valid & (final_d <= thresh * 2.0)
        if with_stats:
            stats["final_sample_rows"] = jnp.sum(executed) * (bpc * bs_f)
            stats["final_sort_blocks"] = nb2 + pad2
            stats["final_sort_arrays"] = 2  # points permute + value scatter
    else:
        q = sample(points)
        final_d = jnp.where(q.valid, q.value, jnp.inf)
        hit = hits_grid & q.valid & (final_d <= thresh * 2.0)

    # Newton-style refinement: pull the depth to the zero crossing along the
    # ray using the final sample. Keeps depth differentiable in voxel values
    # even where the march converged early (d(depth)/d(voxels) = -dd/1 along
    # the ray direction via the chain rule).
    refined_t = t_final + jnp.where(hit, final_d, 0.0)
    depth = jnp.where(hit, refined_t, jnp.float32(max_depth))
    result = RenderResult(depth=depth, hit=hit, points=points,
                          distance=final_d)
    if with_stats:
        if "final_sample_rows" not in stats:  # dense path
            stats["final_sample_rows"] = int(np.prod(t_final.shape)) \
                if t_final.shape else 1
        return result, stats
    return result


def _cone_prepass(sdf: SignedDistanceField, camera: PinholeCamera,
                  factor: int, num_steps: int,
                  surface_threshold: float, max_depth: float,
                  corner_table: Optional[_AnyCornerTable],
                  max_cone_steps: Optional[int] = None,
                  cone_tail_chunks: int = 1,
                  cone_refine: Optional[int] = None,
                  stats: Optional[dict] = None,
                  raw_sample_fn=None
                  ) -> Tuple[Array, Array, Array, Array]:
    """Cone-traced coarse pass: one ray per ``factor x factor`` pixel block,
    advanced only while the SDF sample exceeds the cone radius — so the
    returned per-block depth ``T`` certifies that NO fine ray in the block
    can meet the surface before ``T``:

    every fine ray shares the pinhole apex and deviates from the block
    center ray by at most the block's angular radius ``theta`` (computed
    per block from its corner directions — exact, no small-angle
    assumption), so a fine-ray point at radial distance ``t`` lies within
    ``t * tan(theta)`` of the axis point at ``t``; while
    ``d(axis(t)) > t*tan(theta) + margin`` the step
    ``(d - t*tan) / (1 + tan)`` keeps that invariant (Amanatides-style
    cone sphere tracing over an exact metric SDF).

    Cost is ``rays / factor^2`` marches; the fine march then starts at
    ``T`` and typically converges in a few steps instead of re-walking the
    whole empty interior. Returns ``(t_init, t_valid_from, slowness,
    escaped)`` — four ``[H,W]`` images: the certified per-block depth, the
    depth the cone march STARTED at, a per-block slowness estimate (march
    steps the cone consumed, +budget if it never died — silhouette-grazing
    cones advance by the eps floor and score highest), and a bool MISS
    certificate: the cone left the grid still safe, so the certified
    interval ``[t_valid_from, t_init]`` spans the whole in-grid path and
    every fine ray contained in it provably never meets the surface
    (:func:`sphere_trace` uses this to retire such rays without marching
    them). The certificate only covers ``[t_valid_from, t_init]`` where
    ``t_valid_from`` is the CENTER ray's entry depth: a fine ray that
    enters the grid before that (side-face or grazing entry) has an
    uncertified window and must fall back to its own entry depth
    (:func:`sphere_trace` applies that test).

    ``max_cone_steps`` caps the cone march budget below ``num_steps``:
    shallower certified starts are still certified (correctness is
    unaffected), the fine tail just marches a little further — a knob to
    trade the full-width cone while_loop (which silhouette cones otherwise
    drag to ``num_steps``) against the sorted, chunked fine tail.

    ``cone_tail_chunks > 1`` applies the fine tail's own trick to the cone
    march: after 8 full-width cone steps, still-alive cones are compacted
    ordered by estimated remaining steps and the rest of the budget runs
    in that many chunks — silhouette-grazing cones (eps-floor crawlers)
    share a chunk instead of dragging every step to full width. Results
    are bitwise identical for any chunk count.

    ``cone_refine`` (a block size dividing ``factor``) runs a SECOND,
    hierarchical cone stage: every parent block spawns its
    ``(factor/cone_refine)^2`` sub-cones, which CONTINUE from the
    parent's certified depth with a narrower angular radius. A cone that
    died pinched between its own radius and a silhouette gets a second
    chance to certify deeper or escape outright — at a fraction of the
    cost of running the finer grid from scratch, because sub-cones start
    deep and converge or escape in a few steps. Certificates compose
    (children start AT the parent depth, so intervals are contiguous);
    the returned images are at ``cone_refine`` block granularity.

    ``raw_sample_fn`` overrides the SDF sampler (position ``[..., 3]``
    world -> :class:`sdf_query.DistanceQuery`): the grid-sharded renderer
    injects a psum-composed slab sampler here so the prepass can run with
    REPLICATED arithmetic over a sharded grid — every device marches the
    identical (tiny, rays/factor^2) cone wave and only the sample values
    ride a collective, so certificates come out bit-identical to the
    single-chip prepass.
    """
    f = int(factor)
    wc, hc = camera.width // f, camera.height // f

    def block_dirs(du, dv, bf):
        # World direction of the fine pixel at offset (du, dv) within each
        # bf x bf block (same math as camera_rays, on the coarse lattice).
        u = (jnp.arange(camera.width // bf, dtype=jnp.float32) * bf) + du
        v = (jnp.arange(camera.height // bf, dtype=jnp.float32) * bf) + dv
        uu, vv = jnp.meshgrid(u, v, indexing="xy")
        d = jnp.stack([(uu - camera.cx) / camera.fx,
                       (vv - camera.cy) / camera.fy,
                       jnp.ones_like(uu)], axis=-1)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return transforms.rotate_vector(camera.pose, d)

    def block_geometry(bf):
        """(center dirs, tan of the exact per-block angular radius) for
        ``bf x bf`` pixel blocks. The extreme DIRECTIONS of a block are
        attained at its 4 corner pixels for a pinhole (gnomonic geodesics
        are straight lines; spherical distance to the center is
        quasi-convex along them, so the max over the rectangle sits at a
        vertex)."""
        center = block_dirs((bf - 1) / 2.0, (bf - 1) / 2.0, bf)
        sin_t = jnp.zeros(center.shape[:-1], jnp.float32)
        for du in (-0.5, bf - 0.5):
            for dv in (-0.5, bf - 0.5):
                c = block_dirs(du, dv, bf)
                cross = jnp.cross(c, center)
                sin_t = jnp.maximum(sin_t,
                                    jnp.linalg.norm(cross, axis=-1))
        tan_t = sin_t / jnp.sqrt(jnp.maximum(1.0 - sin_t * sin_t, 1e-6))
        return center, tan_t

    center, tan_t = block_geometry(f)
    origins = jnp.broadcast_to(camera.pose[:3, 3], center.shape)

    if raw_sample_fn is not None:
        raw_sample = raw_sample_fn
    elif corner_table is not None:
        def raw_sample(pos):
            return sdf_query.estimate_location_distance_fast(
                sdf, corner_table, pos)
    else:
        def raw_sample(pos):
            return sdf_query.estimate_location_distance(sdf, pos)

    # Cone samples are clamped INTO the grid box (grid frame) and the
    # returned value is offset-corrected: there is no geometry outside the
    # grid and the SDF is 1-Lipschitz, so d(true) >= d(clamped) - |offset|
    # — the safety test stays conservative while the march can start
    # BEFORE the entry face and run past the exit face, where the raw
    # query is invalid. (Until round 3 the prepass issued raw queries from
    # its pre-entry start, so for ANY camera outside the grid the first
    # sample was invalid, every cone died on step 0, and the prepass
    # silently certified nothing — the round-2 render gains all came from
    # the convergence-sorted tail.)
    inv = sdf.inverse_origin_transform()
    fwd = sdf.origin_transform
    sizes_g = jnp.asarray(sdf.spec.grid_sizes, jnp.float32)
    clamp_pad = jnp.float32(0.25 * sdf.resolution)

    def sample(pos):
        p_g = transforms.apply_isometry(inv, pos)
        p_c = jnp.clip(p_g, clamp_pad, sizes_g - clamp_pad)
        off = jnp.linalg.norm(p_g - p_c, axis=-1)
        q = raw_sample(transforms.apply_isometry(fwd, p_c))
        return sdf_query.DistanceQuery(q.value - off, q.valid)

    # Start the cone exactly at the CENTER ray's entry depth. For face-on
    # blocks every fine ray of the block enters later than the center (the
    # center direction has the largest cosine against the face normal), so
    # the certificate covers them from their own entry; side-face/grazing
    # fine rays that enter earlier fall back to their own entry depth via
    # the per-ray ``t_enter >= t_valid_from`` gate in :func:`sphere_trace`.
    # A pre-entry slack start is counterproductive:
    # the Lipschitz offset correction makes pre-entry samples read
    # ``d(face) - |pre-entry distance|``, which kills the cone whenever the
    # slack exceeds the face's clearance.
    t_enter_c, t_exit_c, hits_c = _clip_to_grid(sdf, origins, center)
    # Cap the cone at max_depth: fine rays stop at min(exit, max_depth)
    # too (sphere_trace), so "crossed the cap still-safe" is as valid an
    # escape certificate as crossing the exit — and deep scenes stop
    # burning cone budget past depths nothing will march to.
    t_exit_c = jnp.minimum(t_exit_c, jnp.float32(max_depth))
    t_start = jnp.maximum(t_enter_c, 0.0)
    # Safety margin. The certificate must bound the INTERPOLATED corrected
    # query (what the fine march converges on), which is NOT 1-Lipschitz —
    # corrected corner values can differ by up to 2*res across a sign
    # change. Route the bound through the true metric distance D (exactly
    # 1-Lipschitz) instead: |query(p) - D(p)| <= delta with
    # delta = (0.5 + sqrt(3)/2) * res (0.5*res center correction plus the
    # weighted-corner-distance interpolation error, maximal at the cell
    # center), so  query(p_fine) >= query(sample) - 2*delta - |p_fine -
    # p_sample|  and the cone must keep  query > tan*t + 2*delta + thresh.
    # (The round-2 margin 2*thresh + 0.5*res was never exercised — the
    # prepass died on step 0, see above — and is genuinely unsound: it
    # skipped marginal silhouette hits once the cone actually marched.)
    #
    # STRICTNESS BAND (round-4 fix): the cone step (q - r) / (1 + tan)
    # consumes the margin EXACTLY at its endpoint — substituting
    # s = t_new into the interval guarantee gives query(fine) >= thresh
    # with EQUALITY attainable, while fine convergence is query <= thresh
    # INCLUSIVE, so a tangent ray sitting exactly on the threshold is
    # certified-missed in exact math, and f32 rounding in the query chain
    # widens "exactly" into a small band (measured on the 512^3 sphere at
    # focal 600: 8 silhouette-tangent pixels whose converged fine query
    # was 0.0039*res BELOW thresh were escape-certified away). Adding
    # band to the margin makes the endpoint guarantee strict by `band`:
    # query(fine) >= thresh + band - float_err > thresh. 0.05*res is
    # ~13x the observed rounding excursion and costs nothing (the total
    # margin goes 2.98 -> 3.03 voxels).
    delta = (0.5 + float(np.sqrt(3.0)) / 2.0) * sdf.resolution
    band = 0.05 * sdf.resolution
    margin = jnp.float32(surface_threshold + 2.0 * delta + band)
    eps = jnp.float32(1e-3 * sdf.resolution)

    budget = num_steps if max_cone_steps is None \
        else min(int(max_cone_steps), num_steps)

    def cone_march(state0, o, c, tt, tx, steps):
        """March cones while safe; per-cone sequences are independent of
        which cones share the loop, so any chunking is result-invariant."""
        def cond(state):
            i, _, alive = state[0], state[1], state[2]
            return (i < steps) & jnp.any(alive)

        def body(state):
            i, t, alive, used, escaped, d_prev, d_cur = state
            q = sample(o + c * t[..., None])
            r = tt * t + margin
            safe = q.valid & (q.value > r)
            step = jnp.maximum((q.value - r) / (1.0 + tt), eps)
            t_new = jnp.where(alive & safe, t + step, t)
            alive_new = alive & safe & (t_new < tx)
            # Escape: the cone crossed the grid-exit depth while STILL
            # safe — the certified interval now covers its entire in-grid
            # path.
            escaped_new = escaped | (alive & safe & (t_new >= tx))
            used_new = jnp.where(alive, used + 1.0, used)
            d_prev = jnp.where(alive, d_cur, d_prev)
            d_cur = jnp.where(alive, q.value, d_cur)
            return (i + 1, t_new, alive_new, used_new, escaped_new,
                    d_prev, d_cur)

        return lax.while_loop(cond, body, state0)

    big = jnp.float32(1e30)
    k_cone = int(cone_tail_chunks)

    def run_stage(o, c, tt, tx, t0, alive0, used0, escaped0,
                  head_steps=None, sort_key0=None):
        """Head + (optionally) sorted chunked tail over FLAT [m] cones.

        The chunked tail is the fine tail's trick applied to the cone
        march itself: silhouette-grazing cones crawl at the eps floor and
        otherwise drag the full-width while_loop to ``budget``; after 8
        full-width steps, still-alive cones are compacted ordered by
        estimated remaining steps and the rest of the budget runs in
        ``k_cone`` chunks under lax.map — all-dead chunks cost one alive
        check. Bit-result-invariant (per-cone sequences unchanged).

        ``head_steps=0`` skips the full-width head entirely and sorts by
        the caller's ``sort_key0`` (larger = slower) instead of the
        head's decay estimate — the refine stage uses this with the
        PARENT's slowness so dead children (of escaped parents) and
        fast-converging children never occupy full-width lanes (the
        round-4 net-loss came from exactly those lanes)."""
        d0 = t0 * 0.0 + big
        head = budget if k_cone <= 1 else min(8, budget)
        if head_steps is not None and k_cone > 1:
            # With no chunked tail (k_cone <= 1) a head override of 0
            # would skip the stage's march entirely — the full-width
            # head IS the march there, so the override only applies when
            # the tail machinery exists to pick the work up.
            head = min(int(head_steps), budget)
        if head > 0:
            hd_iters, t_c, alive_e, used, escaped, d_prev, d_cur = \
                cone_march(
                    (jnp.int32(0), t0, alive0, used0, escaped0, d0, d0),
                    o, c, tt, tx, head)
        else:
            hd_iters = jnp.int32(0)
            t_c, alive_e, used, escaped = t0, alive0, used0, escaped0
            d_prev = d_cur = d0
        st = {"head_iters": hd_iters, "head_width": t_c.shape[0]}
        if stats is not None:
            stats.setdefault("cone_stages", []).append(st)
        if k_cone <= 1 or budget <= head:
            return t_c, alive_e, used, escaped
        n = t_c.shape[0]
        pad = (-n) % k_cone
        chunk = (n + pad) // k_cone
        # 10 permute gathers in + 4 unsort scatters out, scalar rows.
        st["sort_rows"] = n + pad
        st["sort_arrays"] = 14

        def flat_pad(x, fill):
            cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, cfg, constant_values=fill)

        alive_f = flat_pad(alive_e, False)
        if head > 0:
            decay = flat_pad(d_prev - d_cur, 0.0)
            est = flat_pad(d_cur, 0.0) / jnp.maximum(decay, eps)
        elif sort_key0 is not None:
            est = -flat_pad(jnp.asarray(sort_key0, jnp.float32), 0.0)
        else:
            est = flat_pad(t_c * 0.0, 0.0)
        key = jnp.where(alive_f, est, jnp.float32(3e30))
        order = jnp.argsort(key, stable=True)
        arrs = [flat_pad(t_c, 0.0), alive_f, flat_pad(used, 0.0),
                flat_pad(escaped, False), flat_pad(d_prev, big),
                flat_pad(d_cur, big), flat_pad(o, 0.0),
                flat_pad(c, 0.0), flat_pad(tt, 0.0), flat_pad(tx, 0.0)]
        (t_s, al_s, us_s, es_s, dp_s, dc_s,
         o_s, c_s, tt_s, tx_s) = [a[order] for a in arrs]

        def march_chunk(args):
            t_k, al_k, us_k, es_k, dp_k, dc_k, o_k, c_k, tt_k, tx_k = args
            i_o, t_o, al_o, us_o, es_o, _, _ = cone_march(
                (jnp.int32(0), t_k, al_k, us_k, es_k, dp_k, dc_k),
                o_k, c_k, tt_k, tx_k, budget - head)
            return t_o, al_o, us_o, es_o, i_o

        t_o, al_o, us_o, es_o, it_o = lax.map(march_chunk, (
            t_s.reshape(k_cone, chunk), al_s.reshape(k_cone, chunk),
            us_s.reshape(k_cone, chunk), es_s.reshape(k_cone, chunk),
            dp_s.reshape(k_cone, chunk), dc_s.reshape(k_cone, chunk),
            o_s.reshape(k_cone, chunk, 3), c_s.reshape(k_cone, chunk, 3),
            tt_s.reshape(k_cone, chunk), tx_s.reshape(k_cone, chunk)))

        st["tail_iters"] = it_o                       # i32 [k_cone]
        st["tail_chunk_width"] = chunk

        def unsort(x, dtype):
            return jnp.zeros((n + pad,), dtype).at[order].set(
                x.reshape(-1))[:n]

        return (unsort(t_o, t_c.dtype), unsort(al_o, jnp.bool_),
                unsort(us_o, used.dtype), unsort(es_o, jnp.bool_))

    flat = lambda x: x.reshape((hc * wc,) + x.shape[2:])  # noqa: E731
    # Derive the zero carries from the (possibly shard-varying) geometry
    # so the while_loop carry types match the body outputs under
    # shard_map's check_vma (the sharded pixel renderer runs this prepass
    # per shard on a row-sliced camera).
    zeros_f = flat(t_start) * 0.0
    t_cone, alive_end, used, escaped = run_stage(
        flat(origins), flat(center), flat(tan_t), flat(t_exit_c),
        flat(t_start), flat(hits_c & (t_start < t_exit_c)), zeros_f,
        zeros_f < -1.0)
    hits_b = flat(hits_c)
    valid_from = jnp.where(hits_b, flat(t_start), jnp.float32(jnp.inf))
    out_f = f

    if cone_refine and int(cone_refine) >= f:
        # Silently no-opping here would hide a schedule typo (e.g.
        # cone_refine=16 with coarse_factor=8) — mirror the divisibility
        # ValueError below.
        raise ValueError(
            f"cone_refine={int(cone_refine)} must be smaller than "
            f"coarse_factor={f} (it is the FINER second-stage block size)")
    if cone_refine and int(cone_refine) < f:
        # HIERARCHICAL REFINEMENT: every parent block spawns
        # (f / rf)^2 sub-cones at block size rf that CONTINUE from the
        # parent's certified depth with a narrower angular radius — cones
        # that died pinched between the surface and their own radius
        # (tangency) get a second chance to certify deeper or escape.
        # Sound by composition: the parent certifies
        # [valid_from, t_parent] for every ray of the block; each child
        # starts AT t_parent (never later — starting past it would leave
        # an uncertified gap), so the union interval is contiguous and
        # the per-ray ``t_enter >= valid_from`` gate in sphere_trace is
        # unchanged. Children of escaped parents start dead (nothing left
        # to certify); children of parent-missed blocks stay uncertified.
        rf = int(cone_refine)
        if f % rf:
            raise ValueError(
                f"cone_refine={rf} must divide coarse_factor={f}")
        scale = f // rf
        wc2, hc2 = camera.width // rf, camera.height // rf
        center2, tan2 = block_geometry(rf)
        origins2 = jnp.broadcast_to(camera.pose[:3, 3], center2.shape)
        t_en2, t_ex2, hits2 = _clip_to_grid(sdf, origins2, center2)
        t_ex2 = jnp.minimum(t_ex2, jnp.float32(max_depth))

        def up(x):
            img = x.reshape(hc, wc)
            return jnp.repeat(jnp.repeat(img, scale, axis=0), scale,
                              axis=1).reshape(hc2 * wc2)

        def flat2(x):
            return x.reshape((hc2 * wc2,) + x.shape[2:])

        t_p = up(t_cone)
        esc_p = up(escaped)
        hits_p = up(hits_b)
        t0_2 = jnp.maximum(t_p, 0.0)
        alive2 = (flat2(hits2) & hits_p & ~esc_p
                  & (t0_2 < flat2(t_ex2)))
        # head_steps=0 + the parent's slowness as the sort key: children
        # jump straight into the compacted chunked tail, so children of
        # escaped parents (dead at birth) and fast-reconverging children
        # never occupy full-width lanes. The round-4 "cone_refine is a
        # net -4.4 ms" measurement came from the 8 full-width child head
        # steps this removes; per-child sample sequences are unchanged
        # for any chunking, so certificates still compose exactly.
        parent_slow = up(used + jnp.where(alive_end, jnp.float32(budget),
                                          0.0))
        t_cone, alive_end, used, escaped = run_stage(
            flat2(origins2), flat2(center2), flat2(tan2), flat2(t_ex2),
            t0_2, alive2, up(used), esc_p,
            head_steps=0, sort_key0=parent_slow)
        hits_b = hits_p
        valid_from = up(valid_from)
        out_f = rf

    t_cone = jnp.where(hits_b, t_cone, 0.0)
    # Blocks whose center ray misses the grid entirely are also certified
    # misses IF no fine ray can hit the grid either — conservatively leave
    # them uncertified (sphere_trace's own slab test retires them for one
    # full-width check, the same cost as before).
    escaped = escaped & hits_b
    # Slowness: cones that never died (silhouette grazers crawling at the
    # eps floor, or budget-capped deep cones) sort after everything else.
    slowness = used + jnp.where(alive_end, jnp.float32(budget), 0.0)
    # Upsample block images to the full image.
    hb, wb = camera.height // out_f, camera.width // out_f

    def up_img(x):
        img = x.reshape(hb, wb)
        return jnp.repeat(jnp.repeat(img, out_f, axis=0), out_f, axis=1)

    return (up_img(t_cone), up_img(valid_from), up_img(slowness),
            up_img(escaped))


def gather_rows_from_stats(stats: dict,
                           gathers_per_sample: float = 1.0) -> float:
    """Total gather/scatter ROWS a rendered frame issued, from the
    ``with_stats=True`` counters of :func:`render_depth`.

    Every march iteration issues exactly one SDF sample per lane of its
    phase width (one gather row with a :class:`sdf_query.CornerTable`,
    ``gathers_per_sample=8`` for the raw trilinear stencil, 1 for the
    lane-packed pair table); compaction permutes/scatters move one row
    per sort unit per array. Call OUTSIDE the timed section — reading the
    counters is a few 4-byte D2H transfers."""
    rows = 0.0
    for st in stats.get("cone_stages", []):
        rows += float(st["head_iters"]) * st["head_width"] \
            * gathers_per_sample
        if "tail_iters" in st:
            rows += float(jnp.sum(st["tail_iters"])) \
                * st["tail_chunk_width"] * gathers_per_sample
        if "sort_rows" in st:
            rows += st["sort_rows"] * st["sort_arrays"]
    rows += (float(stats.get("fine_head_iters", 0))
             * stats.get("fine_head_width", 0) * gathers_per_sample)
    if "fine_tail_iters" in stats:
        rows += (float(jnp.sum(stats["fine_tail_iters"]))
                 * stats["fine_tail_chunk_width"] * gathers_per_sample)
        rows += stats["fine_sort_blocks"] * stats["fine_sort_arrays"]
    rows += float(stats.get("final_sample_rows", 0)) * gathers_per_sample
    if "final_sort_blocks" in stats:  # sparse final sample's block permutes
        rows += stats["final_sort_blocks"] * stats["final_sort_arrays"]
    return rows


def block_relayout(height: int, width: int, factor: int,
                   batch: Optional[int] = None):
    """``(to_blocks, from_blocks)`` for the block-tail schedule: lay a
    ``[..., height, width, *rest]`` image out so each ``factor x factor``
    cone block is one contiguous run of rays (the ``sort_block`` unit of
    :func:`sphere_trace`), and back. One definition serves the single-view,
    batched, and sharded renderers — the layouts must stay mutually
    consistent with ``sort_block`` semantics."""
    f = int(factor)
    hb, wb = height // f, width // f
    if batch is None:
        def to_blocks(x):
            rest = x.shape[2:]
            return x.reshape(hb, f, wb, f, *rest).swapaxes(1, 2) \
                .reshape(hb * wb * f * f, *rest)

        def from_blocks(x):
            rest = x.shape[1:]
            return x.reshape(hb, wb, f, f, *rest).swapaxes(1, 2) \
                .reshape(height, width, *rest)
    else:
        b = int(batch)

        def to_blocks(x):
            rest = x.shape[3:]
            return x.reshape(b, hb, f, wb, f, *rest).swapaxes(2, 3) \
                .reshape(b * hb * wb * f * f, *rest)

        def from_blocks(x):
            rest = x.shape[1:]
            return x.reshape(b, hb, wb, f, f, *rest).swapaxes(2, 3) \
                .reshape(b, height, width, *rest)
    return to_blocks, from_blocks


def render_depth(sdf: SignedDistanceField, camera: PinholeCamera,
                 num_steps: int = 64, max_depth: float = 100.0,
                 surface_threshold: Optional[float] = None,
                 corner_table: Optional[_AnyCornerTable] = None,
                 early_exit: bool = False,
                 mip: Optional[SdfMip] = None,
                 coarse_factor: int = 0,
                 cone_steps: Optional[int] = None,
                 cone_tail_chunks: int = 1,
                 cone_refine: Optional[int] = None,
                 with_stats: bool = False,
                 **trace_kwargs):
    """Render an ``[H, W]`` depth image (differentiable in ``sdf.distances``
    and ``camera.pose``). See :func:`sphere_trace` for the performance
    knobs ``corner_table`` / ``early_exit`` / ``mip`` (plus ``coarse_steps``
    / ``head_steps`` / ``tail_chunks`` forwarded via kwargs).
    ``coarse_factor > 0`` runs the cone-traced prepass
    (:func:`_cone_prepass`, one cone per ``factor^2`` pixel block) and
    starts every fine ray at its block's certified-safe depth — rays skip
    the provably empty interior, so hits are a superset of the plain
    march's (never fewer) and converged depths agree within the
    convergence threshold (see :func:`sphere_trace`).
    ``cone_steps`` caps the cone march budget (shallower but cheaper
    certified starts), ``cone_tail_chunks > 1`` runs the cone march
    itself with a sorted chunked tail (bitwise-identical certificates),
    and ``cone_refine`` adds a hierarchical second cone stage at a finer
    block size — deeper starts and more escape certificates near
    silhouettes, where parent cones die pinched (see
    :func:`_cone_prepass`).
    ``with_stats=True`` returns ``(result, stats)`` where ``stats`` maps
    each phase to the while-loop iteration counts it actually executed
    and the static widths it ran at (see :func:`sphere_trace`); feed it
    to :func:`gather_rows_from_stats` for the frame's total gather-row
    count."""
    origins, dirs = camera_rays(camera)
    t_init = t_valid_from = sort_key = cert_miss = None
    stats = {} if with_stats else None
    if coarse_factor:
        if camera.width % coarse_factor or camera.height % coarse_factor:
            # Silent fallback here would be a multi-x throughput regression
            # with no signal; render_depth_batch already raises.
            raise ValueError(
                f"coarse_factor={coarse_factor} must divide the image "
                f"dimensions {camera.width}x{camera.height}")
        thresh = (0.25 * sdf.resolution if surface_threshold is None
                  else float(surface_threshold))
        t_init, t_valid_from, cone_slow, cert_miss = _cone_prepass(
            sdf, camera, coarse_factor, num_steps, thresh, max_depth,
            corner_table, max_cone_steps=cone_steps,
            cone_tail_chunks=cone_tail_chunks, cone_refine=cone_refine,
            stats=stats)
        # The certified start is CONTROL data, not a differentiable
        # quantity: within the certified-empty interval the march result
        # does not depend on where it starts, so the true gradient of the
        # depth w.r.t. voxels THROUGH t_init is zero — and the cone march
        # is a while_loop, which reverse-mode AD can't traverse anyway.
        t_init = lax.stop_gradient(t_init)
        t_valid_from = lax.stop_gradient(t_valid_from)
        cone_slow = lax.stop_gradient(cone_slow)
        cert_miss = lax.stop_gradient(cert_miss)
        if trace_kwargs.get("head_steps", 8) == 0:
            # head_steps=0 skips ALL full-width fine steps; the tail sort
            # then clusters slow rays by their block cone's own SLOWNESS
            # (steps the cone consumed, +budget if it never converged) —
            # silhouette-grazing cones crawl at the eps floor and score
            # highest, interior hits converge fast and score lowest. This
            # key comes free with the prepass march (an earlier cone-depth
            # edge-discontinuity key misclassified enough rays to measure
            # SLOWER than head=1 on the accelerator this was tuned on).
            sort_key = cone_slow
    if (early_exit and sort_key is not None
            and trace_kwargs.get("tail_chunks", 8) > 1):
        # Block-tail schedule: relayout rays BLOCK-major (each cone's
        # f x f pixels contiguous) so the tail compaction can sort and
        # permute whole cone blocks (`sort_block`) instead of single rays,
        # and retire miss-certified rays without marching them. Outputs
        # are relayouted back — semantics identical, the permute cost
        # drops ~f^2-fold and certified-miss blocks never enter the tail.
        f = int(coarse_factor)
        to_blocks, from_blocks = block_relayout(
            camera.height, camera.width, f)

        result = sphere_trace(
            sdf, to_blocks(origins), to_blocks(dirs), num_steps=num_steps,
            max_depth=max_depth, surface_threshold=surface_threshold,
            corner_table=corner_table, early_exit=True, mip=mip,
            t_init=to_blocks(t_init),
            t_init_valid_from=to_blocks(t_valid_from),
            sort_key=to_blocks(sort_key),
            certified_miss=to_blocks(cert_miss),
            sort_block=f * f, with_stats=with_stats, **trace_kwargs)
        if with_stats:
            result, trace_stats = result
            stats.update(trace_stats)
        result = RenderResult(*(from_blocks(v) for v in result))
        return (result, stats) if with_stats else result
    result = sphere_trace(sdf, origins, dirs, num_steps=num_steps,
                          max_depth=max_depth,
                          surface_threshold=surface_threshold,
                          corner_table=corner_table, early_exit=early_exit,
                          mip=mip, t_init=t_init,
                          t_init_valid_from=t_valid_from, sort_key=sort_key,
                          certified_miss=cert_miss,
                          with_stats=with_stats, **trace_kwargs)
    if with_stats:
        result, trace_stats = result
        stats.update(trace_stats)
        return result, stats
    return result


class PlainMarchAgreement(NamedTuple):
    """How a render agrees with the plain march (``early_exit=False``,
    ``coarse_factor=0``) of the same field and camera; see
    :func:`compare_with_plain_march`. Counts are pixels."""
    plain_hits: int
    other_hits: int
    skipped: int          # converged plain hits the other render missed
    off_depth: int        # common hits more than 2*thresh apart
    grazers: int          # divergent pixels exempt as tangent grazers
    unconverged: int      # plain hits that ran out of budget unconverged
    max_depth_err: float  # over the common hits the depth rule checks

    @property
    def ok(self) -> bool:
        return self.skipped == 0 and self.off_depth == 0

    def describe(self) -> str:
        return (f"hits plain {self.plain_hits} other {self.other_hits}; "
                f"skipped {self.skipped}, off depth {self.off_depth} "
                f"(max err {self.max_depth_err:.3g} m); exempt: grazers "
                f"{self.grazers}, unconverged plain hits {self.unconverged}")


# Half-width of the tangent-grazer band around the convergence threshold,
# in voxels. A grazer's query dips to within float noise of the threshold
# without crossing it; whether a sample lands in the dip depends on the
# sample sequence. The largest excursion measured on the 512^3 sphere was
# 0.0039 voxel (see _cone_prepass); the band is 20x that.
GRAZER_BAND_VOXELS = 0.08


def compare_with_plain_march(plain: RenderResult, other: RenderResult,
                             resolution: float,
                             surface_threshold: Optional[float] = None
                             ) -> PlainMarchAgreement:
    """The contract every faster render schedule keeps with the plain march
    (host-side, on NumPy copies of the two results).

    A certified start only moves a ray further along the monotone map
    ``t -> t + d(t)``, so for every ray whose query CROSSES the threshold:

    * every plain hit is a hit of the other render (no surface skipped);
    * on common hits both converge on the same root, so depths agree
      within twice the convergence threshold.

    Two classes of pixel are outside that argument; they are counted and
    exempt. Tangent grazers: the march that stopped nearer stopped with
    its query within ``GRAZER_BAND_VOXELS`` of the threshold, in a
    sub-threshold dip without a crossing, which another sample sequence
    steps over to miss or to meet a surface behind it. Unconverged plain
    hits: the plain march ran out of its step budget with the query
    between ``thresh + band`` and the hit rule's ``2 * thresh``; it found
    no surface, so there is nothing for the other render to keep."""
    thresh = (0.25 * resolution if surface_threshold is None
              else float(surface_threshold))
    band = GRAZER_BAND_VOXELS * resolution
    p_hit, o_hit = np.asarray(plain.hit), np.asarray(other.hit)
    p_dist, o_dist = np.asarray(plain.distance), np.asarray(other.distance)
    p_depth, o_depth = np.asarray(plain.depth), np.asarray(other.depth)
    unconverged = p_hit & (p_dist > thresh + band)
    converged = p_hit & ~unconverged
    missed = converged & ~o_hit
    missed_grazers = missed & (np.abs(p_dist - thresh) <= band)
    common = converged & o_hit
    err = np.abs(o_depth - p_depth)
    apart = common & (err > 2.0 * thresh + 1e-6)
    nearer_dist = np.where(p_depth <= o_depth, p_dist, o_dist)
    apart_grazers = apart & (np.abs(nearer_dist - thresh) <= band)
    return PlainMarchAgreement(
        plain_hits=int(p_hit.sum()), other_hits=int(o_hit.sum()),
        skipped=int((missed & ~missed_grazers).sum()),
        off_depth=int((apart & ~apart_grazers).sum()),
        grazers=int(missed_grazers.sum() + apart_grazers.sum()),
        unconverged=int(unconverged.sum()),
        max_depth_err=float(err[common & ~apart_grazers].max(initial=0.0)))


def render_depth_batch(sdf: SignedDistanceField, cameras: PinholeCamera,
                       num_steps: int = 64, max_depth: float = 100.0,
                       surface_threshold: Optional[float] = None,
                       corner_table: Optional[_AnyCornerTable] = None,
                       coarse_factor: int = 8,
                       cone_steps: Optional[int] = 32,
                       cone_tail_chunks: int = 8,
                       tail_chunks: int = 64,
                       **trace_kwargs) -> RenderResult:
    """Render ``B`` views in ONE march — a :class:`PinholeCamera` whose
    array leaves carry a leading batch axis (``pose [B,4,4]``, ``fx [B]``,
    ...; build with ``jax.tree.map(lambda *x: jnp.stack(x), *cams)``).
    Returns a :class:`RenderResult` of ``[B, H, W]`` images.

    Multi-camera rigs are the production shape of this library's domain
    (the reference fuses 2-8 depth cameras per cycle). Naive view batching
    through :func:`sphere_trace` measures SLOWER than per-view calls (the
    full-width early-exit wave couples to the worst ray across all views).
    This path avoids that coupling by construction: the cone prepass runs
    per view (vmapped — cones are ``rays/factor^2``), then ALL fine rays
    march under the block-tail schedule (``head_steps=0``), where the
    slowness-sorted chunks specialize by view automatically and there is
    no full-width phase to couple. Per-ray sample sequences equal the
    per-view :func:`render_depth` exactly. One march against four
    per-view calls: not measured on the H100.

    Inference-only (``early_exit``). ``coarse_factor`` must divide both
    image dimensions.
    """
    if not (coarse_factor and cameras.width % coarse_factor == 0
            and cameras.height % coarse_factor == 0):
        raise ValueError("render_depth_batch requires coarse_factor "
                         "dividing the image dimensions")
    f = int(coarse_factor)
    h, w = cameras.height, cameras.width
    hb, wb = h // f, w // f
    thresh = (0.25 * sdf.resolution if surface_threshold is None
              else float(surface_threshold))

    origins, dirs = jax.vmap(camera_rays)(cameras)        # [B,H,W,3]
    t_init, t_valid_from, cone_slow, cert_miss = jax.vmap(
        lambda c: _cone_prepass(sdf, c, f, num_steps, thresh, max_depth,
                                corner_table, max_cone_steps=cone_steps,
                                cone_tail_chunks=cone_tail_chunks))(cameras)
    t_init = lax.stop_gradient(t_init)
    t_valid_from = lax.stop_gradient(t_valid_from)
    sort_key = lax.stop_gradient(cone_slow)
    cert_miss = lax.stop_gradient(cert_miss)
    b = t_init.shape[0]
    to_blocks, from_blocks = block_relayout(h, w, f, batch=b)

    result = sphere_trace(
        sdf, to_blocks(origins), to_blocks(dirs), num_steps=num_steps,
        max_depth=max_depth, surface_threshold=surface_threshold,
        corner_table=corner_table, early_exit=True,
        head_steps=0, tail_chunks=tail_chunks,
        t_init=to_blocks(t_init), t_init_valid_from=to_blocks(t_valid_from),
        sort_key=to_blocks(sort_key), certified_miss=to_blocks(cert_miss),
        sort_block=f * f, **trace_kwargs)
    return RenderResult(*(from_blocks(v) for v in result))


def render_occupancy_image(sdf: SignedDistanceField, camera: PinholeCamera,
                           num_steps: int = 64, max_depth: float = 100.0,
                           softness: float = 1.0, **render_kwargs) -> Array:
    """Soft silhouette: sigmoid of the final SDF sample — a smooth hit mask
    whose gradients reach voxels even for near-miss rays.
    ``render_kwargs`` forward to :func:`render_depth` (``corner_table``,
    ``remat``, ``early_exit``, schedule knobs, ...) so silhouette fitting
    can use the fast sampling path and bound backward-pass memory like
    every other entry point."""
    result = render_depth(sdf, camera, num_steps=num_steps,
                          max_depth=max_depth, **render_kwargs)
    scale = jnp.float32(softness * sdf.resolution)
    d = jnp.where(jnp.isfinite(result.distance), result.distance,
                  10.0 * scale)
    return jax.nn.sigmoid(-d / scale)


def depth_to_pointcloud(result: RenderResult, camera: PinholeCamera,
                        max_range: Optional[float] = None):
    """Back-project a rendered depth image into a :class:`PointCloud` in the
    camera frame — closes the loop render -> sensor model -> carving."""
    from .voxelize import PointCloud
    origins, dirs = camera_rays(camera)
    pts_world = origins + dirs * result.depth[..., None]
    inv = transforms.invert_isometry(camera.pose)
    pts_cam = transforms.apply_isometry(inv, pts_world)
    pts = jnp.where(result.hit[..., None], pts_cam, jnp.nan)
    return PointCloud.create(
        pts.reshape(-1, 3), camera.pose,
        max_range=max_range if max_range is not None else jnp.inf)
