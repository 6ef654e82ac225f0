"""Sharded implementations of the dense passes (shard_map over a device mesh).

Strategy (SURVEY.md section 5, BASELINE.json north star):

* **EDT**: the grid is sharded by Z-slabs. The X and Y sweeps only need data
  within a slab, so they run locally. The Z sweep needs whole Z lines, so the
  grid is *transposed through the interconnect* with ``all_to_all`` (X-shards
  <-> Z-shards), swept locally, and transposed back — the all-to-all moves
  each element exactly twice, which beats halo-exchange envelope merging
  for the global lower-envelope pass.
* **Ray carving**: rays are sharded; every device scatter-adds its rays into
  a local full-size counter grid and a single ``psum`` fuses the per-camera
  tracking grids (the contention-free analogue of the reference's atomics
  across devices).
* **Rendering**: rays (pixels) are sharded; the SDF grid is replicated inside
  the shard (gather-heavy sampling wants local data); the loss/gradients
  ``psum`` back — gradient all-reduce handled by jit's partitioner.

Call these under ``jax.jit``. ``shard_map`` invoked outside jit executes
the mapped computation op by op eagerly, paying a dispatch per op.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from ..core import transforms
from ..core.grid import GridSpec
from ..core.maps import OccupancyMap, SignedDistanceField
from ..ops import edt as edt_ops
from ..ops import render as render_ops
from ..ops import voxelize as voxelize_ops

Array = jnp.ndarray


# -- Sharded EDT -------------------------------------------------------------


def _check_edt_sharding(shape, n_shards, backend):
    nx, _, nz = shape
    edt_ops._resolve_edt_backend(backend)  # rejects unknown names
    # The Z-pass all_to_all splits axis 0 (2*nx when both signed fields are
    # stacked) — nx % n keeps both the plain and stacked layouts valid.
    if nx % n_shards or nz % n_shards:
        raise ValueError(
            f"the mesh axis size {n_shards} must divide both "
            f"nx ({nx}) and nz ({nz})")


def sharded_squared_edt(seed: Array, mesh: Mesh, axis_name: str = "z",
                        block: int = 512, backend: str = "auto") -> Array:
    """Exact squared EDT over a Z-slab-sharded ``[nx, ny, nz]`` bool grid.

    ``backend`` selects the per-shard envelope implementation (see
    :func:`...ops.edt.squared_edt`); the default ``"auto"`` resolves to
    the Triton kernel on a GPU mesh and to the XLA fusion on virtual CPU
    meshes, so multi-card runs pick the fast kernel without every caller
    opting in."""
    n_shards = mesh.shape[axis_name]
    nx, ny, nz = seed.shape
    _check_edt_sharding(seed.shape, n_shards, backend)

    def local_edt(local_seed):
        # local_seed: [nx, ny, nz / n]; X pass (binary) + Y pass are local.
        d = jnp.moveaxis(
            edt_ops._binary_squared_dist_last(
                jnp.moveaxis(local_seed, 0, -1)), -1, 0)
        if ny > 1:
            d = edt_ops._envelope_axis(d, 1, block, backend)
        if nz > 1:
            # Transpose through the interconnect: X-shard the grid, full Z
            # locally.
            d = lax.all_to_all(d, axis_name, split_axis=0, concat_axis=2,
                               tiled=True)  # [nx/n, ny, nz]
            d = edt_ops._envelope_axis(d, 2, block, backend)
            d = lax.all_to_all(d, axis_name, split_axis=2, concat_axis=0,
                               tiled=True)  # [nx, ny, nz/n]
        return d

    fn = shard_map(local_edt, mesh=mesh,
                   in_specs=P(None, None, axis_name),
                   out_specs=P(None, None, axis_name))
    return fn(seed)


def sharded_signed_distance(is_filled: Array, resolution: float, mesh: Mesh,
                            axis_name: str = "z", block: int = 512,
                            backend: str = "auto",
                            dtype=jnp.float32) -> Array:
    """Sharded two-field signed combine (matches
    :func:`...ops.edt.signed_distance_from_filled_mask`).

    Mirrors the single-chip optimization (ops/edt.py:198-212) INSIDE the
    shard_map: the filled- and free-seeded fields are stacked along axis 0
    after the binary X pass, so each Y/Z envelope pass (and each of the two
    all_to_all transposes) runs ONCE over both fields — halving collective
    count and doubling the line count each kernel call amortizes over,
    instead of running two whole sharded EDTs back to back."""
    is_filled = jnp.asarray(is_filled, dtype=bool)
    n_shards = mesh.shape[axis_name]
    nx, ny, nz = is_filled.shape
    _check_edt_sharding(is_filled.shape, n_shards, backend)

    def local_signed(local_filled):
        # local_filled: [nx, ny, nz / n] bool.
        d_f = jnp.moveaxis(edt_ops._binary_squared_dist_last(
            jnp.moveaxis(local_filled, 0, -1)), -1, 0)
        d_e = jnp.moveaxis(edt_ops._binary_squared_dist_last(
            jnp.moveaxis(~local_filled, 0, -1)), -1, 0)
        d = jnp.concatenate([d_f, d_e], axis=0)  # [2nx, ny, lz]
        if ny > 1:
            d = edt_ops._envelope_axis(d, 1, block, backend)
        if nz > 1:
            d = lax.all_to_all(d, axis_name, split_axis=0, concat_axis=2,
                               tiled=True)  # [2nx/n, ny, nz]
            d = edt_ops._envelope_axis(d, 2, block, backend)
            d = lax.all_to_all(d, axis_name, split_axis=2, concat_axis=0,
                               tiled=True)  # [2nx, ny, lz]
        d2_filled = d[:nx].astype(dtype)
        d2_free = d[nx:].astype(dtype)
        res = jnp.asarray(resolution, dtype)
        return jnp.sqrt(d2_filled) * res - jnp.sqrt(d2_free) * res

    fn = shard_map(local_signed, mesh=mesh,
                   in_specs=P(None, None, axis_name),
                   out_specs=P(None, None, axis_name))
    return fn(is_filled)


def sharded_extract_sdf(occupancy: Array, spec: GridSpec, origin_transform,
                        mesh: Mesh, axis_name: str = "z", frame: str = "",
                        unknown_is_filled: bool = True,
                        oob_value: float = float("inf"),
                        block: int = 512,
                        backend: str = "auto") -> SignedDistanceField:
    # Fail fast like the single-chip entry point (ops/edt.py): a
    # non-uniform spec would otherwise compile+dispatch the whole sharded
    # EDT before SignedDistanceField.create rejects it.
    spec.enforce_uniform_voxel_size()
    mask = edt_ops.filled_mask_from_occupancy(occupancy, unknown_is_filled)
    values = sharded_signed_distance(mask, spec.resolution, mesh, axis_name,
                                     block, backend)
    return SignedDistanceField.create(
        spec=spec, distances=values, origin_transform=origin_transform,
        frame=frame, oob_value=oob_value, locked=True)


def sharded_extract_isosurface(sdf: SignedDistanceField, mesh: Mesh,
                               axis_name: str = "z", level: float = 0.0,
                               max_triangles_per_shard: int = 1 << 16,
                               frame: str = "world"):
    """X-slab-sharded isosurface extraction (``ops.isosurface``).

    Each device owns ``nx / n`` value planes plus ONE halo plane fetched
    from its +X neighbor by ``ppermute`` (the cube layer straddling the
    shard boundary belongs to the lower shard; the last shard masks its
    halo cube layer out), then runs the same slab sweep as the single-
    device extractor over its own cubes — per-triangle values are
    bitwise-identical, and concatenating the shards' valid triangles in
    shard order reproduces the single-device output exactly
    (tests/test_sharded.py).

    Returns ``(IsoMesh, shard_counts)``: the mesh's buffers are the
    concatenated per-shard buffers (capacity ``n * max_triangles_per_shard``
    with per-shard compaction, so valid rows are not globally contiguous —
    exactly what ``IsoMesh.valid`` masking and ``weld_vertices`` expect),
    and the mesh carries ``shard_counts`` so ``IsoMesh.overflowed`` (and
    the weld/statistics truncation guards) check each shard against its
    own buffer slice — a single shard dropping triangles is flagged even
    when the aggregate total stays under capacity."""
    from ..ops import isosurface as iso_ops

    d = iso_ops._validated_field(sdf, level, frame)
    spec = sdf.spec
    n_shards = mesh.shape[axis_name]
    nx = spec.num_x
    if nx % n_shards:
        raise ValueError(f"the mesh axis size {n_shards} must divide "
                         f"nx ({nx})")
    if nx // n_shards < 2:
        raise ValueError("shards need >= 2 planes each")
    cap = int(max_triangles_per_shard)

    def local_extract(d_local):
        sx = d_local.shape[0]
        idx = lax.axis_index(axis_name)
        halo = lax.ppermute(
            d_local[:1], axis_name,
            perm=[(s + 1, s) for s in range(n_shards - 1)])
        d_ext = jnp.concatenate([d_local, halo], axis=0)  # [sx + 1, ny, nz]
        n_valid = sx - (idx == n_shards - 1).astype(jnp.int32)
        x_base = (idx * sx).astype(jnp.float32)
        verts, valid, count = iso_ops._extract_planes(
            d_ext, sx, n_valid, x_base, spec.resolution, cap)
        return verts, valid, count[None]

    fn = shard_map(local_extract, mesh=mesh,
                   in_specs=P(axis_name),
                   out_specs=(P(axis_name), P(axis_name), P(axis_name)))
    verts, valid, counts = fn(d)
    verts = iso_ops._verts_to_frame(verts, sdf, frame)
    m = iso_ops.IsoMesh(vertices=verts, valid=valid,
                        num_triangles=jnp.sum(counts),
                        shard_counts=counts)
    return m, counts


# -- Sharded ray carving -------------------------------------------------------


def sharded_raycast_pointcloud(spec: GridSpec, grid_origin_transform: Array,
                               cloud: voxelize_ops.PointCloud, mesh: Mesh,
                               axis_name: str = "z",
                               max_steps: Optional[int] = None,
                               ray_chunk: int = 16384,
                               run_axis="auto",
                               reduce: str = "all"
                               ) -> voxelize_ops.TrackingGrid:
    """Carve one cloud with rays sharded across the mesh; per-device counter
    grids are fused with a single ``psum`` (replicated output).

    ``run_axis`` selects the column-marching carve's run direction
    (ops/voxelize.raycast_pointcloud_columns — bit-exact with the walk).
    The default ``"auto"`` resolves the cloud's dominant ray
    axis EAGERLY, so it only engages when this function is called with
    concrete points (e.g. per-frame from the backend layer, which jit-
    caches carve+filter after resolving options). Under an enclosing
    ``jax.jit`` the points are tracers, the probe cannot run, and auto
    falls back to the voxel walk — pass an explicit integer ``run_axis``
    (usually the camera's optical axis) or ``"split"`` (per-ray dominant
    axis, direction-independent cost) to keep the column carve in fully
    jitted pipelines. ``None`` forces the voxel walk.

    ``reduce`` selects how per-device tracking grids fuse:

    * ``"all"`` (default): ``psum`` — every device materializes the full
      fused grid (replicated output). Per-device collective work grows
      with TOTAL grid size; fine while one cloud's grid fits a chip.
    * ``"scatter"``: ``psum_scatter`` along the grid's z axis — each
      device keeps only ITS ``nz / n_shards`` slab of the fused grid
      (output sharded ``P(None, None, axis_name)``), so per-device
      collective traffic and result materialization scale with the SHARD,
      not the grid. Identical values
      (integer scatter-adds are order-independent); requires
      ``nz % n_shards == 0``. This is the right mode for pipelines that
      stay sharded (fusion filter + Z-slab EDT both consume slabs).
    """
    if isinstance(run_axis, str):
        if run_axis not in ("auto", "split"):
            raise ValueError(f"Unknown run_axis {run_axis!r}")
        if run_axis == "auto":
            try:
                run_axis = voxelize_ops.pick_run_axis(
                    cloud, grid_origin_transform)
            except jax.errors.TracerArrayConversionError:
                run_axis = None
    n_shards = mesh.shape[axis_name]
    if reduce not in ("all", "scatter"):
        raise ValueError(f"Unknown reduce mode {reduce!r}")
    if reduce == "scatter" and spec.counts[2] % n_shards:
        raise ValueError(
            f"reduce='scatter' needs the mesh axis size {n_shards} to "
            f"divide nz ({spec.counts[2]})")
    n_rays = cloud.points.shape[0]
    pad = (-n_rays) % n_shards
    points = jnp.pad(cloud.points, ((0, pad), (0, 0)),
                     constant_values=jnp.inf)

    def local_carve(local_points, origin_transform, max_range):
        local_cloud = voxelize_ops.PointCloud(
            points=local_points, origin_transform=origin_transform,
            max_range=max_range)
        if run_axis is None:
            grid = voxelize_ops.raycast_pointcloud(
                spec, grid_origin_transform, local_cloud,
                max_steps=max_steps, ray_chunk=ray_chunk)
        else:
            grid = voxelize_ops.raycast_pointcloud_columns(
                spec, grid_origin_transform, local_cloud,
                max_steps=max_steps, ray_chunk=ray_chunk,
                run_axis=run_axis if run_axis == "split"
                else int(run_axis))
        if reduce == "scatter":
            return (lax.psum_scatter(grid.seen_free, axis_name,
                                     scatter_dimension=2, tiled=True),
                    lax.psum_scatter(grid.seen_filled, axis_name,
                                     scatter_dimension=2, tiled=True))
        return (lax.psum(grid.seen_free, axis_name),
                lax.psum(grid.seen_filled, axis_name))

    out_spec = P(None, None, axis_name) if reduce == "scatter" else P()
    fn = shard_map(local_carve, mesh=mesh,
                   in_specs=(P(axis_name), P(), P()),
                   out_specs=(out_spec, out_spec))
    free, filled = fn(points, cloud.origin_transform, cloud.max_range)
    return voxelize_ops.TrackingGrid(free, filled)


def sharded_voxelize_pointclouds(
        static_environment: OccupancyMap,
        filter_options: voxelize_ops.FilterOptions,
        pointclouds: Sequence[voxelize_ops.PointCloud], mesh: Mesh,
        axis_name: str = "z", max_steps: Optional[int] = None,
        run_axis="auto") -> OccupancyMap:
    """Multi-device ``VoxelizePointClouds``: per-cloud sharded carving, then
    the fusion filter.

    When the mesh size divides ``nz`` the whole pipeline stays Z-slab
    sharded: each cloud's per-device tracking grids reduce-scatter to slab
    shards (``reduce="scatter"``) and the fusion filter — pointwise over
    voxels — runs on slabs inside one ``shard_map``, so no device ever
    materializes a full fused grid and per-device work scales with the
    shard. The returned occupancy is the same
    logical ``[nx, ny, nz]`` array, laid out ``P(None, None, z)`` — exactly
    what :func:`sharded_extract_sdf` consumes. Falls back to the replicated
    reduce when ``nz % n_shards != 0``."""
    filter_options.validate()
    spec = static_environment.spec
    n_shards = mesh.shape[axis_name]
    sharded_out = spec.counts[2] % n_shards == 0
    reduce = "scatter" if sharded_out else "all"
    grids = [sharded_raycast_pointcloud(
        spec, static_environment.origin_transform, c, mesh, axis_name,
        max_steps, run_axis=run_axis, reduce=reduce) for c in pointclouds]
    if grids:
        seen_free = jnp.stack([g.seen_free for g in grids])
        seen_filled = jnp.stack([g.seen_filled for g in grids])
    else:
        seen_free = jnp.zeros((0,) + spec.counts, jnp.int32)
        seen_filled = jnp.zeros((0,) + spec.counts, jnp.int32)
    if sharded_out:
        # The filter is pointwise over voxels (counts_seen_as + fuse), so
        # it runs on each device's slab; occupancy stays slab-sharded.
        fn = shard_map(
            lambda sf, sfi, occ: voxelize_ops.combine_and_filter(
                filter_options, sf, sfi, occ),
            mesh=mesh,
            in_specs=(P(None, None, None, axis_name),
                      P(None, None, None, axis_name),
                      P(None, None, axis_name)),
            out_specs=P(None, None, axis_name))
        occupancy = fn(seen_free, seen_filled,
                       static_environment.occupancy)
    else:
        occupancy = voxelize_ops.combine_and_filter(
            filter_options, seen_free, seen_filled,
            static_environment.occupancy)
    return static_environment.replace(occupancy=occupancy)


# -- Sharded rendering ---------------------------------------------------------


def sharded_render_depth(sdf: SignedDistanceField,
                         camera: render_ops.PinholeCamera, mesh: Mesh,
                         axis_name: str = "z", num_steps: int = 64,
                         max_depth: float = 100.0,
                         corner_table=None,
                         early_exit: bool = False,
                         head_steps: int = 8,
                         tail_chunks: int = 8,
                         coarse_factor: int = 0,
                         cone_steps: Optional[int] = None,
                         cone_tail_chunks: int = 1,
                         with_distance: bool = False):
    """Render with pixel rows sharded across devices (grid replicated).
    Returns the ``[H, W]`` depth image; with ``with_distance`` also the
    ``[H, W]`` final SDF sample of each ray (``RenderResult.distance``),
    which :func:`...ops.render.compare_with_plain_march` needs.

    ``corner_table`` / ``early_exit`` / ``head_steps`` / ``tail_chunks`` /
    ``coarse_factor`` are the single-chip fast-path knobs (ops/render.py);
    the table is replicated alongside the grid — gathers want device-local
    data — and each shard's early-exit wave, convergence-sorted tail, and
    cone-certified starting depths adapt to ITS pixels only
    (silhouette-heavy shards no longer stall the rest)."""
    n_shards = mesh.shape[axis_name]
    if camera.height % n_shards:
        raise ValueError(
            f"{n_shards} shards must divide camera height "
            f"{camera.height}")
    origins, dirs = render_ops.camera_rays(camera)

    t_init = t_valid_from = sort_key = cert_miss = None
    # The prepass needs f | W and f | H (raise like single-chip
    # render_depth — silent fallback is a multi-x regression with no
    # signal); the per-shard BLOCK relayout additionally needs
    # f | H/n_shards — when only that fails, keep the prepass and fall
    # back to per-ray tail sorting (sort_block=1) instead of dropping
    # everything.
    block_layout_ok = bool(
        coarse_factor
        and camera.height % (coarse_factor * n_shards) == 0)
    prepass_inside = False
    if coarse_factor:
        if camera.width % coarse_factor or camera.height % coarse_factor:
            raise ValueError(
                f"coarse_factor={coarse_factor} must divide the image "
                f"dimensions {camera.width}x{camera.height}")
        thresh = 0.25 * sdf.resolution
        if block_layout_ok:
            # Shard the prepass WITH the rays: cones are f x f pixel
            # blocks, so a shard owning whole block rows runs the prepass
            # on a row-sliced camera (same pose/focal, cy shifted by its
            # first row) — the per-block math is bitwise the full
            # camera's, so certificates are identical while the prepass
            # cost divides by the mesh instead of replicating (the
            # replicated form caps the scaling of cone-heavy schedules).
            prepass_inside = True
        else:
            # Fallback (f | H but not f | H/n_shards): replicated prepass,
            # outputs sharded with the rays. Control data:
            # stop_gradient'ed (ops/render.py).
            t_init, t_valid_from, cone_slow, cert_miss = \
                render_ops._cone_prepass(
                    sdf, camera, coarse_factor, num_steps, thresh,
                    max_depth, corner_table, max_cone_steps=cone_steps,
                    cone_tail_chunks=cone_tail_chunks)
            t_init = jax.lax.stop_gradient(t_init)
            t_valid_from = jax.lax.stop_gradient(t_valid_from)
            cert_miss = jax.lax.stop_gradient(cert_miss)
            if head_steps == 0:
                sort_key = jax.lax.stop_gradient(cone_slow)
            else:
                cert_miss = cert_miss if early_exit else None

    table_rows = corner_table.rows if corner_table is not None else None
    # Static table kind (both kinds are 8-lane rows since the pair table
    # went lane-packed — width no longer discriminates).
    from ..ops.sdf_query import CornerTable, CornerPairTable
    table_cls = (CornerPairTable
                 if isinstance(corner_table, CornerPairTable)
                 else CornerTable)

    def local_render(local_origins, local_dirs, distances, rows=None,
                     local_t_init=None, local_t_valid=None,
                     local_sort_key=None, local_cert_miss=None):
        local_sdf = sdf.replace(distances=distances)
        table = None
        if rows is not None:
            table = table_cls(rows=rows)
        if prepass_inside:
            # Row-sliced camera: rows [row0, row0 + lh) of the full
            # camera — (v - (cy - row0)) == ((v + row0) - cy), so ray and
            # cone-block math is bitwise the full camera's.
            lh = camera.height // n_shards
            row0 = (lax.axis_index(axis_name) * lh).astype(jnp.float32)
            cam_local = render_ops.PinholeCamera(
                pose=camera.pose, fx=camera.fx, fy=camera.fy,
                cx=camera.cx, cy=camera.cy - row0,
                width=camera.width, height=lh)
            local_t_init, local_t_valid, cone_slow_l, local_cert_miss = \
                render_ops._cone_prepass(
                    local_sdf, cam_local, coarse_factor, num_steps,
                    thresh, max_depth, table,
                    max_cone_steps=cone_steps,
                    cone_tail_chunks=cone_tail_chunks)
            local_t_init = lax.stop_gradient(local_t_init)
            local_t_valid = lax.stop_gradient(local_t_valid)
            local_cert_miss = lax.stop_gradient(local_cert_miss)
            if head_steps == 0:
                local_sort_key = lax.stop_gradient(cone_slow_l)
            elif not early_exit:
                local_cert_miss = None
        trace_kwargs = {}
        reshape_back = None
        if (block_layout_ok
                and early_exit and local_sort_key is not None
                and tail_chunks > 1
                and coarse_factor):
            # Block-tail schedule inside the shard (mirrors
            # ops/render.render_depth): relayout the shard's rays cone-
            # block-major so the tail sorts/permutes whole f x f blocks
            # (`sort_block`) — the permute cost drops ~f^2-fold and
            # miss-certified blocks retire without marching. The shard
            # owns whole pixel rows and f | local height (checked above),
            # so every cone block is shard-local; semantics identical.
            f = int(coarse_factor)
            lh, lw = local_origins.shape[:2]
            to_blocks, from_blocks = render_ops.block_relayout(lh, lw, f)

            local_origins = to_blocks(local_origins)
            local_dirs = to_blocks(local_dirs)
            local_t_init = to_blocks(local_t_init)
            local_t_valid = to_blocks(local_t_valid)
            local_sort_key = to_blocks(local_sort_key)
            if local_cert_miss is not None:
                local_cert_miss = to_blocks(local_cert_miss)
            trace_kwargs["sort_block"] = f * f
            reshape_back = from_blocks
        result = render_ops.sphere_trace(
            local_sdf, local_origins, local_dirs, num_steps=num_steps,
            max_depth=max_depth, corner_table=table, early_exit=early_exit,
            head_steps=head_steps, tail_chunks=tail_chunks,
            t_init=local_t_init, t_init_valid_from=local_t_valid,
            sort_key=local_sort_key, certified_miss=local_cert_miss,
            **trace_kwargs)
        out = (result.depth, result.distance)
        if reshape_back is not None:
            out = tuple(reshape_back(x) for x in out)
        return out if with_distance else out[0]

    # Optional operands ride a dict pytree — shard_map specs follow the
    # same keys, so adding an operand is one entry here and one kwarg
    # below (no positional index-shifting to keep consistent).
    args = {"o": origins, "d": dirs, "dist": sdf.distances}
    specs = {"o": P(axis_name), "d": P(axis_name), "dist": P()}
    if table_rows is not None:
        args["rows"], specs["rows"] = table_rows, P()
    if t_init is not None:
        args["t_i"], specs["t_i"] = t_init, P(axis_name)
        args["t_v"], specs["t_v"] = t_valid_from, P(axis_name)
    if sort_key is not None:
        args["s_k"], specs["s_k"] = sort_key, P(axis_name)
    if cert_miss is not None and early_exit:
        args["c_m"], specs["c_m"] = cert_miss, P(axis_name)

    def fn(a):
        return local_render(a["o"], a["d"], a["dist"], rows=a.get("rows"),
                            local_t_init=a.get("t_i"),
                            local_t_valid=a.get("t_v"),
                            local_sort_key=a.get("s_k"),
                            local_cert_miss=a.get("c_m"))

    out_spec = P(axis_name)
    mapped = shard_map(fn, mesh=mesh, in_specs=(specs,),
                       out_specs=(out_spec, out_spec) if with_distance
                       else out_spec)
    return mapped(args)


import dataclasses


@dataclasses.dataclass(frozen=True)
class SlabCornerTable:
    """Slab-local corner rows + the grid axis they were built along.

    The rows' shape is axis-independent on cubic grids, so an untagged
    array built along one axis and rendered along another would silently
    produce garbage depths — the tag lets the renderer reject the
    mismatch (round-5 review finding #2)."""
    rows: Array  # f32 [n_cells, 8], sharded P(axis_name) on axis 0
    grid_axis: int = dataclasses.field(metadata=dict(static=True))


SlabCornerTable = jax.tree_util.register_dataclass(
    SlabCornerTable, data_fields=["rows"], meta_fields=["grid_axis"])


def sharded_build_corner_table(sdf: SignedDistanceField, mesh: Mesh,
                               axis_name: str = "z",
                               grid_axis: int = 2) -> SlabCornerTable:
    """Slab-local corner-brick rows for
    :func:`sharded_render_depth_grid_sharded` — the grid-sharded analogue
    of :func:`...ops.sdf_query.build_corner_table` (without it
    the only render path for grids exceeding one chip's memory pays 8
    gathers per trilinear sample while the single-chip path pays one).

    Each device builds rows for the base cells IT owns from its slab plus
    the ONE halo plane the renderer already fetches (``ppermute`` from the
    +axis neighbor), so no device ever materializes more than
    ``8 x slab`` bytes — the table shards exactly like the grid. Row
    ``flat_local(b)`` (C-order over the PERMUTED local shape, slab axis
    major) holds the 8 corrected corner distances in the permuted order
    ``c = 4*d_ax + 2*d_o1 + d_o2``; the renderer's sampler re-orders lanes
    to the canonical ``4*dx + 2*dy + dz`` so its interpolation arithmetic
    is the exact single-chip :func:`estimate_location_distance_fast`
    expression. The last shard's top row (global base ``n_ax - 1``) is
    built from the WRAPPED halo and is garbage by construction — base
    cells clamp to ``n_ax - 2`` globally, so it is never gathered.

    Returns a :class:`SlabCornerTable` whose rows are one
    ``[n_cells, 8]`` array sharded ``P(axis_name)`` on axis 0 — pass it
    to the renderer's ``corner_rows`` (which checks the ``grid_axis``
    tag). Call under ``jax.jit``."""
    from ..ops.sdf_query import _pull_to_surface

    spec = sdf.spec
    n_shards = mesh.shape[axis_name]
    counts = spec.counts
    ax = int(grid_axis)
    if ax not in (0, 1, 2):
        raise ValueError(f"grid_axis must be 0, 1, or 2, got {grid_axis}")
    n_ax = counts[ax]
    if n_ax % n_shards:
        raise ValueError(
            f"{n_shards} shards must divide counts[{ax}] ({n_ax})")
    lsz = n_ax // n_shards
    other = [a for a in range(3) if a != ax]
    n1, n2 = counts[other[0]], counts[other[1]]
    d_dtype = jnp.asarray(sdf.distances).dtype
    half = d_dtype.type(sdf.resolution * 0.5)
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def local_build(local_d):
        halo = lax.ppermute(
            lax.slice_in_dim(local_d, 0, 1, axis=ax), axis_name, perm)
        ext = jnp.moveaxis(jnp.concatenate([local_d, halo], axis=ax),
                           ax, 0)  # [lsz + 1, n1, n2]

        def plane(a):
            # Correct + edge-pad per plane (mirrors build_corner_table:
            # whole-slab corrected copies as loop operands would double
            # the transient exactly at the scale this path serves).
            pl = _pull_to_surface(
                lax.dynamic_slice(ext, (a, 0, 0), (1, n1, n2))[0], half)
            pl = jnp.concatenate([pl, pl[-1:, :]], axis=0)
            return jnp.concatenate([pl, pl[:, -1:]], axis=1)

        rows0 = jnp.zeros((lsz * n1 * n2, 8), d_dtype)
        # Derive a shard-varying zero so the fori_loop carry's manual axes
        # match the body outputs under check_vma.
        rows0 = rows0 + local_d.ravel()[0] * 0

        def body(a, rows):
            p0 = plane(a)
            p1 = plane(a + 1)  # halo plane covers the slab's top stencil
            chans = [(p0 if da == 0 else p1)[d1:d1 + n1, d2:d2 + n2]
                     for da in (0, 1) for d1 in (0, 1) for d2 in (0, 1)]
            plane_rows = jnp.stack(chans, axis=-1).reshape(n1 * n2, 8)
            return lax.dynamic_update_slice(rows, plane_rows,
                                            (a * n1 * n2, 0))

        return lax.fori_loop(0, lsz, body, rows0)

    in_spec = [None, None, None]
    in_spec[ax] = axis_name
    fn = shard_map(local_build, mesh=mesh, in_specs=P(*in_spec),
                   out_specs=P(axis_name))
    return SlabCornerTable(rows=fn(sdf.distances), grid_axis=ax)


def sharded_render_depth_grid_sharded(
        sdf: SignedDistanceField, camera: render_ops.PinholeCamera,
        mesh: Mesh, axis_name: str = "z", num_steps: int = 64,
        max_depth: float = 100.0,
        surface_threshold: Optional[float] = None,
        steps_per_exchange: int = 8,
        grid_axis: int = 2,
        ray_chunks: int = 16,
        corner_rows: Optional["SlabCornerTable"] = None,
        coarse_factor: int = 0,
        cone_steps: Optional[int] = None,
        cone_tail_chunks: int = 1,
        with_distance: bool = False):
    """Render with the GRID slab-sharded (for grids too big for one chip);
    rays are replicated. Returns the ``[H, W]`` depth image, and with
    ``with_distance`` also each ray's final SDF sample, as
    :func:`sharded_render_depth` does.

    Each device holds a ``counts[grid_axis] / K`` slab plus ONE halo plane
    from its +axis neighbor (``ppermute``), enough for any trilinear
    stencil whose base cell lies in its slab. Marching is OWNER-ADVANCES
    in phases: each device advances only the rays whose stencil base it
    owns, locally, for up to ``steps_per_exchange`` steps (a ray freezes
    for the rest of the phase when it steps out of the slab; chunk loops
    exit early once every locally-active ray froze or converged), then ONE
    ``psum`` per phase reconciles (t, alive, step-count) deltas — each ray
    is advanced by exactly one device per phase, so the masked sums ARE
    the new state.

    Two levers make this SCALE instead of serializing:

    * **Owner compaction** (``ray_chunks``): each phase sorts rays so the
      device's owned-and-runnable rays are contiguous, then marches them
      in ``ray_chunks`` chunks under ``lax.map`` — chunks with no active
      ray exit after one alive-check, so per-device sampling cost per
      phase is ~(its resident rays), not the full replicated ray width.
      The round-3 formulation sampled ALL rays on EVERY device each inner
      step, which is where the K-fold serialization came from.
    * **Shard-axis choice** (``grid_axis``): shard the grid along an axis
      PERPENDICULAR to the dominant view direction. A depth camera looking
      along +z with ``grid_axis=0`` (X slabs) gives every ray a nearly
      constant x, so rays distribute evenly across devices by pixel
      column, almost never cross slabs, and ALL devices march their own
      resident rays concurrently — with ``grid_axis=2`` the same camera
      sweeps one Z slab at a time and the schedule is inherently serial
      no matter how rays are compacted. Default 2 matches the Z-slab EDT
      output layout; reshard (one all_to_all) or generate the SDF sharded
      along the render axis when rendering dominates.

    A ray's sample sequence ``t_{i+1} = t_i + d(t_i)`` does not depend on
    the schedule and each per-ray step budget is tracked explicitly, so
    the result is IDENTICAL to the single-device march for every
    (``steps_per_exchange``, ``ray_chunks``, ``grid_axis``) — same
    samples, same budget; the owner evaluates the full stencil locally.
    Inference path (``while_loop``).

    Fast-path knobs (without them this path would run none
    of the single-chip machinery and pay 8 gathers per sample):

    * ``corner_rows``: slab-local corner-brick rows from
      :func:`sharded_build_corner_table` (same mesh/axis/``grid_axis``) —
      each owned trilinear sample becomes ONE local row gather with the
      exact single-chip interpolation arithmetic (lane reorder from the
      permuted build order, then the canonical expression), so values
      match :func:`...ops.render.sphere_trace` with a
      :class:`CornerTable` bit for bit.
    * ``coarse_factor`` / ``cone_steps`` / ``cone_tail_chunks``: the cone
      prepass, run with REPLICATED arithmetic inside the shard_map — the
      cone wave is tiny (``rays / factor^2``) so every device marches the
      identical wave; only sample values ride a ``psum`` (one per cone
      step, slab owner contributes). Certificates are bit-identical to
      the single-chip prepass, so the contract is the same: certified
      starts skip the empty interior (fewer owner phases), escape-
      certified rays retire without marching, hits are a superset of the
      plain march's, and common depths agree within the convergence
      threshold. The per-block slowness key additionally orders the owner
      compaction so slow rays cluster in the same chunks.
    """
    spec = sdf.spec
    n_shards = mesh.shape[axis_name]
    counts = spec.counts
    ax = int(grid_axis)
    if ax not in (0, 1, 2):
        raise ValueError(f"grid_axis must be 0, 1, or 2, got {grid_axis}")
    n_ax = counts[ax]
    if n_ax % n_shards:
        raise ValueError(
            f"{n_shards} shards must divide counts[{ax}] ({n_ax})")
    lsz = n_ax // n_shards
    res = jnp.float32(spec.resolution)
    if surface_threshold is None:
        surface_threshold = 0.25 * spec.resolution
    thresh = jnp.float32(surface_threshold)
    eps = jnp.float32(1e-3 * spec.resolution)

    origins_img, dirs_img = render_ops.camera_rays(camera)
    img_shape = origins_img.shape[:-1]
    n = int(np.prod(img_shape))
    origins = origins_img.reshape(n, 3)
    dirs = dirs_img.reshape(n, 3)
    t_enter, t_exit, hits_grid = render_ops._clip_to_grid(sdf, origins, dirs)
    t0 = jnp.where(hits_grid, t_enter + eps, jnp.float32(max_depth))
    t_stop = jnp.minimum(t_exit, jnp.float32(max_depth))
    inv = sdf.inverse_origin_transform()

    counts_i = jnp.asarray(counts, jnp.int32)
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    k_ex = max(1, int(steps_per_exchange))
    kc = max(1, int(ray_chunks))
    pad = (-n) % kc
    chunk = (n + pad) // kc

    other = [a for a in range(3) if a != ax]
    n1, n2 = counts[other[0]], counts[other[1]]
    # Lane map from the slab table's PERMUTED corner order (slab axis
    # major, see sharded_build_corner_table) back to the canonical
    # c = 4*dx + 2*dy + dz the single-chip interpolation expression uses.
    lane_perm = np.zeros(8, np.int32)
    for cc in range(8):
        d3 = ((cc >> 2) & 1, (cc >> 1) & 1, cc & 1)
        lane_perm[cc] = 4 * d3[ax] + 2 * d3[other[0]] + d3[other[1]]
    if coarse_factor:
        if camera.width % coarse_factor or camera.height % coarse_factor:
            raise ValueError(
                f"coarse_factor={coarse_factor} must divide the image "
                f"dimensions {camera.width}x{camera.height}")
    if corner_rows is not None:
        if not isinstance(corner_rows, SlabCornerTable):
            raise TypeError(
                "corner_rows must be a SlabCornerTable from "
                "sharded_build_corner_table (the grid_axis tag is what "
                "catches an axis mismatch — raw rows built along one "
                "axis render silent garbage along another)")
        if corner_rows.grid_axis != ax:
            raise ValueError(
                f"corner_rows was built with grid_axis="
                f"{corner_rows.grid_axis} but the render shards along "
                f"grid_axis={ax}")
        n_cells = counts[0] * counts[1] * counts[2]
        if tuple(corner_rows.rows.shape) != (n_cells, 8):
            raise ValueError(
                f"corner_rows.rows shape {tuple(corner_rows.rows.shape)} "
                f"does not match this grid ({n_cells} cells)")
    # A distances-free shell for the prepass helpers (_clip_to_grid, the
    # clamp wrapper): capturing the real sharded distances leaf inside the
    # shard_map body would smuggle the FULL grid into every device.
    sdf_shell = sdf.replace(distances=jnp.zeros((1, 1, 1), jnp.float32))

    def local_render(local_d, local_rows=None):
        shard = lax.axis_index(axis_name)
        a_lo = shard * lsz
        half = res * 0.5
        if local_rows is None:
            # +axis halo plane from the next shard (the last shard's halo
            # is unused: base cells there are clamped to n_ax - 2, owned
            # by the last shard with its own planes; a zero plane keeps
            # shapes static).
            halo = lax.ppermute(
                lax.slice_in_dim(local_d, 0, 1, axis=ax), axis_name, perm)
            ext = jnp.concatenate([local_d, halo], axis=ax)
            corrected = jnp.where(ext >= 0.0, ext - half, ext + half)

        def base_cells(pos):
            """Stencil base cell, trilinear fractions, in-bounds flag, and
            ownership for flat ``[m, 3]`` world positions."""
            p_grid = transforms.apply_isometry(inv, pos)
            finite = jnp.all(jnp.isfinite(pos), axis=-1)
            p_g = jnp.where(finite[:, None], p_grid, 0.0)
            index = spec.location_in_grid_frame_to_grid_index(p_g)
            valid = finite & spec.check_grid_index_in_bounds(index)
            s = p_g / res - 0.5
            b = jnp.clip(jnp.floor(s).astype(jnp.int32), 0,
                         jnp.maximum(counts_i - 2, 0))
            frac = s - b.astype(jnp.float32)
            mine = (b[:, ax] >= a_lo) & (b[:, ax] < a_lo + lsz)
            return b, frac, valid, mine

        def sample_local(pos):
            """(value, valid, mine): value is correct only where mine."""
            b, frac, valid, mine = base_cells(pos)
            if local_rows is not None:
                # ONE local row gather + the exact single-chip
                # interpolation expression (corners lane-reordered from
                # the slab table's permuted build order) — values match
                # estimate_location_distance_fast bit for bit.
                flat = (jnp.where(mine, b[:, ax] - a_lo, 0) * (n1 * n2)
                        + b[:, other[0]] * n2 + b[:, other[1]])
                corners = local_rows[flat][:, lane_perm]
                tx = frac[:, 0:1]
                ty = frac[:, 1:2]
                tz = frac[:, 2:3]
                cx = corners[:, 0:4] * (1 - tx) + corners[:, 4:8] * tx
                cy = cx[:, 0:2] * (1 - ty) + cx[:, 2:4] * ty
                value = cy[:, 0] * (1 - tz[:, 0]) + cy[:, 1] * tz[:, 0]
                return value, valid, mine
            i0 = [b[:, 0], b[:, 1], b[:, 2]]
            i0[ax] = jnp.where(mine, b[:, ax] - a_lo, 0)
            i1 = [jnp.minimum(b[:, k] + 1, counts[k] - 1) for k in range(3)]
            i1[ax] = i0[ax] + 1  # halo plane covers the slab's top stencil

            def corner(ox, oy, oz):
                return corrected[i1[0] if ox else i0[0],
                                 i1[1] if oy else i0[1],
                                 i1[2] if oz else i0[2]]

            tx, ty, tz = frac[:, 0], frac[:, 1], frac[:, 2]
            c00 = corner(0, 0, 0) * (1 - tx) + corner(1, 0, 0) * tx
            c10 = corner(0, 1, 0) * (1 - tx) + corner(1, 1, 0) * tx
            c01 = corner(0, 0, 1) * (1 - tx) + corner(1, 0, 1) * tx
            c11 = corner(0, 1, 1) * (1 - tx) + corner(1, 1, 1) * tx
            c0 = c00 * (1 - ty) + c10 * ty
            c1 = c01 * (1 - ty) + c11 * ty
            return c0 * (1 - tz) + c1 * tz, valid, mine

        def sample_global(pos):
            value, valid, mine = sample_local(pos)
            value = lax.psum(jnp.where(mine, value, 0.0), axis_name)
            return value, valid

        def march_chunk(args):
            """March one ray chunk up to k_ex steps; all-frozen chunks cost
            one alive-check (the owner-compaction sort puts this device's
            runnable rays in the leading chunks)."""
            t_c, al_c, st_c, o_c, d_c, stop_c = args

            def inner_cond(carry):
                j, _, _, _, active = carry
                return (j < k_ex) & jnp.any(active)

            def inner_body(carry):
                j, t, alive, steps, _ = carry
                pos = o_c + d_c * t[..., None]
                d, valid, mine = sample_local(pos)
                active = mine & alive & (steps < num_steps)
                d = jnp.where(valid, d, thresh)
                converged = valid & (d <= thresh)
                adv = active & ~converged
                new_t = jnp.where(adv, t + jnp.maximum(d, eps), t)
                new_alive = jnp.where(
                    active, alive & ~converged & (new_t < stop_c), alive)
                new_steps = steps + active.astype(jnp.int32)
                # A ray stays active next inner step only if it advanced;
                # `mine` is re-derived from the new position at the loop
                # top, freezing rays that stepped out of the slab.
                return j + 1, new_t, new_alive, new_steps, adv

            _, t_o, al_o, st_o, _ = lax.while_loop(
                inner_cond, inner_body,
                (jnp.int32(0), t_c, al_c, st_c, al_c))
            return t_o, al_o, st_o

        # -- Cone prepass (replicated arithmetic, psum-composed samples) --
        t0_l, alive0 = t0, hits_grid
        slow_flat = None
        if coarse_factor:
            def raw_psum_sample(pos):
                v, valid, mine = sample_local(pos)
                v = lax.psum(jnp.where(mine, v, 0.0), axis_name)
                from ..ops.sdf_query import DistanceQuery
                return DistanceQuery(v, valid)

            t_i, t_v, cone_slow, c_m = render_ops._cone_prepass(
                sdf_shell, camera, int(coarse_factor), num_steps,
                float(surface_threshold), max_depth, None,
                max_cone_steps=cone_steps,
                cone_tail_chunks=cone_tail_chunks,
                raw_sample_fn=raw_psum_sample)
            t_i = lax.stop_gradient(t_i).reshape(n)
            t_v = lax.stop_gradient(t_v).reshape(n)
            slow_flat = lax.stop_gradient(cone_slow).reshape(n)
            c_m = lax.stop_gradient(c_m).reshape(n)
            # Mirror sphere_trace's certificate application exactly
            # (ops/render.py): retire rays whose whole in-grid span is
            # inside the certified-miss interval; start the rest at the
            # certified depth, gated on their own entry being covered.
            killed = c_m & (t_stop <= t_i) & (t_enter >= t_v)
            ti = jnp.minimum(t_i, t_stop)
            ti = jnp.where(t_enter >= t_v, ti, t0)
            t0_l = jnp.maximum(t0, ti)
            alive0 = hits_grid & ~killed

        def phase(t, alive, steps):
            """Advance owned rays locally up to k_ex steps; no collectives.
            Owner compaction: sort this device's owned-and-runnable rays to
            the front and march in chunks — per-phase sampling cost is the
            resident-ray count, not the full replicated width. With the
            prepass on, the cone slowness key additionally clusters slow
            (silhouette) rays into the same chunks — the single-chip tail
            sort's trick, applied within the owned group."""
            pos = origins + dirs * t[..., None]
            _, _, _, mine_now = base_cells(pos)
            runnable = alive & (steps < num_steps)
            key = (~(mine_now & runnable)).astype(jnp.float32) * 1e12
            if slow_flat is not None:
                key = key - slow_flat
            order = jnp.argsort(key, stable=True)

            def prep(x, fill):
                xs = x[order]
                cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
                xs = jnp.pad(xs, cfg, constant_values=fill)
                return xs.reshape((kc, chunk) + x.shape[1:])

            # The outer carry is replicated (psum-reconciled) but `order`
            # and the march outputs are device-varying — pcast so the
            # chunk while_loop carry types match under check_vma.
            t_v, al_v, st_v = (
                lax.pcast(x, (axis_name,), to="varying")
                for x in (t, alive, steps))
            t_o, al_o, st_o = lax.map(march_chunk, (
                prep(t_v, 0.0), prep(al_v, False), prep(st_v, num_steps),
                prep(origins, 0.0), prep(dirs, 0.0), prep(t_stop, 0.0)))

            def unsort(xc, ref):
                flat = xc.reshape(-1)[:n]
                return jnp.zeros((n,), ref.dtype).at[order].set(flat)

            return unsort(t_o, t), unsort(al_o, alive), unsort(st_o, steps)

        def cond(carry):
            t, alive, steps = carry
            runnable = alive & (steps < num_steps)
            return lax.psum(jnp.sum(runnable.astype(jnp.int32)),
                            axis_name) > 0

        def body(carry):
            t, alive, steps = carry
            t_n, alive_n, steps_n = phase(t, alive, steps)
            # Reconcile: each ray was advanced by at most one device (its
            # owner at each inner step), so summed deltas are exact.
            t = t + lax.psum(t_n - t, axis_name)
            killed = alive & ~alive_n
            alive = alive & ~(lax.psum(killed.astype(jnp.int32),
                                       axis_name) > 0)
            steps = steps + lax.psum(steps_n - steps, axis_name)
            return t, alive, steps

        steps0 = jnp.zeros(t0.shape, jnp.int32)
        t_final, _, _ = lax.while_loop(cond, body, (t0_l, alive0, steps0))

        points = origins + dirs * t_final[..., None]
        final_d, valid = sample_global(points)
        final_d = jnp.where(valid, final_d, jnp.inf)
        hit = hits_grid & valid & (final_d <= thresh * 2.0)
        refined = t_final + jnp.where(hit, final_d, 0.0)
        depth = jnp.where(hit, refined, jnp.float32(max_depth))
        if with_distance:
            return depth.reshape(img_shape), final_d.reshape(img_shape)
        return depth.reshape(img_shape)

    in_spec = [None, None, None]
    in_spec[ax] = axis_name
    args = {"dist": sdf.distances}
    specs = {"dist": P(*in_spec)}
    if corner_rows is not None:
        args["rows"], specs["rows"] = corner_rows.rows, P(axis_name)

    def fn_dict(a):
        return local_render(a["dist"], local_rows=a.get("rows"))

    fn = shard_map(fn_dict, mesh=mesh, in_specs=(specs,),
                   out_specs=(P(), P()) if with_distance else P())
    return fn(args)
