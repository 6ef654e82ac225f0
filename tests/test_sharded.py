"""Multi-device sharding tests on an 8-device virtual CPU mesh.

The determinism contract mirrors the reference's DegreeOfParallelism-
parameterized suites (SURVEY.md section 4): the sharded result must equal the
single-device result bit-for-bit for any shard count."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxelized_geometry_tools_tpu import GridSpec, OccupancyMap
from voxelized_geometry_tools_tpu.core import transforms
from voxelized_geometry_tools_tpu.ops import edt, render, voxelize
from voxelized_geometry_tools_tpu.parallel import mesh_utils, sharded


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return mesh_utils.make_mesh(("z",))


def test_sharded_edt_matches_single_device(mesh8):
    rng = np.random.default_rng(17)
    seed = rng.random((16, 8, 24)) < 0.15
    seed[3, 3, 3] = True
    single = np.asarray(jax.jit(edt.squared_edt)(jnp.asarray(seed)))
    multi = np.asarray(jax.jit(lambda m: sharded.sharded_squared_edt(
        m, mesh8))(jnp.asarray(seed)))
    np.testing.assert_array_equal(single, multi)


def test_sharded_sdf_matches_single_device(mesh8):
    rng = np.random.default_rng(23)
    occ = (rng.random((8, 8, 16)) < 0.2).astype(np.float32)
    spec = GridSpec.from_voxel_counts(0.25, occ.shape)
    single = jax.jit(lambda o: edt.extract_sdf_from_occupancy(
        o, spec, None))(jnp.asarray(occ))
    multi = jax.jit(lambda o: sharded.sharded_extract_sdf(
        o, spec, jnp.eye(4), mesh8))(jnp.asarray(occ))
    np.testing.assert_array_equal(np.asarray(single.distances),
                                  np.asarray(multi.distances))


def test_sharded_carve_matches_single_device(mesh8):
    spec = GridSpec.from_voxel_counts(0.25, (8, 8, 8))
    origin = transforms.isometry_from_translation((-1.0, -1.0, -1.0))
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.5, 1.5, size=(333, 3)).astype(np.float32)
    cloud = voxelize.PointCloud.create(pts, np.eye(4, dtype=np.float32))

    # jit both sides: shard_map outside jit executes op-by-op eagerly
    # (module docstring) - this test read 46 s of pure dispatch overhead
    # on the virtual mesh before it was jitted.
    single = jax.jit(lambda c: voxelize.raycast_pointcloud(
        spec, origin, c))(cloud)
    multi = jax.jit(lambda c: sharded.sharded_raycast_pointcloud(
        spec, origin, c, mesh8))(cloud)
    np.testing.assert_array_equal(np.asarray(single.seen_free),
                                  np.asarray(multi.seen_free))
    np.testing.assert_array_equal(np.asarray(single.seen_filled),
                                  np.asarray(multi.seen_filled))


@pytest.mark.slow
def test_sharded_render_matches_single_device(mesh8):
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16, focal=20.0)

    single = render.render_depth(sdf, camera, num_steps=32).depth
    multi = sharded.sharded_render_depth(sdf, camera, mesh8, num_steps=32)
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               atol=1e-6)


@pytest.mark.slow
def test_sharded_voxelize_pipeline(mesh8):
    spec = GridSpec.from_voxel_counts(0.25, (8, 8, 8))
    origin = transforms.isometry_from_translation((-1.0, -1.0, -1.0))
    env = OccupancyMap.create(spec, origin, "world")
    pts = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, 16),
                               np.linspace(-0.9, 0.9, 16),
                               indexing="ij"), -1)
    pts = np.concatenate([pts, np.full((16, 16, 1), 0.8)], -1).reshape(-1, 3)
    cloud = voxelize.PointCloud.create(pts.astype(np.float32),
                                       np.eye(4, dtype=np.float32))
    single = voxelize.voxelize_pointclouds(env, voxelize.FilterOptions(),
                                           [cloud])
    multi = sharded.sharded_voxelize_pointclouds(
        env, voxelize.FilterOptions(), [cloud], mesh8)
    np.testing.assert_array_equal(np.asarray(single.occupancy),
                                  np.asarray(multi.occupancy))


@pytest.mark.slow
def test_sharded_render_fast_path_matches(mesh8):
    from voxelized_geometry_tools_tpu.ops import sdf_query
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    table = sdf_query.build_corner_table(sdf)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16, focal=20.0)

    single = render.render_depth(sdf, camera, num_steps=32).depth
    multi = sharded.sharded_render_depth(
        sdf, camera, mesh8, num_steps=32, corner_table=table,
        early_exit=True)
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               atol=1e-5)


@pytest.mark.slow
def test_grid_sharded_render_matches_single_device(mesh8):
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16, focal=20.0)

    single = render.render_depth(sdf, camera, num_steps=32).depth
    # steps_per_exchange batches local owner-advances steps between psums,
    # ray_chunks sets the owner-compaction granularity, and grid_axis picks
    # the slab direction; the per-ray sample sequence and budget are
    # schedule-independent, so EVERY combination must reproduce the
    # single-device depths.
    for gax, k, rc in [(2, 1, 1), (2, 4, 16), (2, 8, 4),
                       (0, 8, 16), (0, 32, 4), (1, 8, 16)]:
        multi = sharded.sharded_render_depth_grid_sharded(
            sdf, camera, mesh8, num_steps=32, steps_per_exchange=k,
            grid_axis=gax, ray_chunks=rc)
        np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                                   atol=1e-4, err_msg=f"{gax} {k} {rc}")


@pytest.mark.slow
def test_sharded_render_cone_and_sorted_tail_matches(mesh8):
    """The cone prepass + convergence-sorted tail knobs through the sharded
    pixel renderer must equal the single-device render."""
    from voxelized_geometry_tools_tpu.ops import sdf_query
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    table = sdf_query.build_corner_table(sdf)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    # height 32 = 8 shards x 2 blocks of coarse_factor 2.
    camera = render.PinholeCamera.create(pose, width=24, height=32,
                                         focal=20.0)

    # Sharding invariance: same knobs on both sides. (A no-cone single
    # render is NOT the right oracle — a WORKING cone prepass changes the
    # sample sequence, so cone-on depths only agree with cone-off within
    # the convergence threshold; see tests/test_fast_render.py
    # _check_cone_equiv for that contract.)
    single = render.render_depth(sdf, camera, num_steps=32,
                                 corner_table=table, early_exit=True,
                                 head_steps=2, tail_chunks=4,
                                 coarse_factor=2).depth
    multi = sharded.sharded_render_depth(
        sdf, camera, mesh8, num_steps=32, corner_table=table,
        early_exit=True, head_steps=2, tail_chunks=4, coarse_factor=2)
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               atol=1e-5)
    # And the cone version must still satisfy the equivalence contract
    # against the plain march: no surface skipped.
    base = render.render_depth(sdf, camera, num_steps=32,
                               corner_table=table, early_exit=True)
    assert (np.asarray(base.hit)
            <= (np.asarray(multi) < 99.0)).all()


@pytest.mark.slow
def test_sharded_render_blocktail_cert_miss_matches(mesh8):
    """head_steps=0 through the sharded renderer: the cone-slowness sort
    key and the escape (certified-miss) retirement are threaded per shard.
    Chunk/shard assignment never changes a ray's sample sequence, so the
    sharded result equals the single-device block-tail render exactly."""
    from voxelized_geometry_tools_tpu.ops import sdf_query
    import voxelized_geometry_tools_tpu.ops.render as render_ops
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    table = sdf_query.build_corner_table(sdf)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=32,
                                         focal=20.0)
    single = render.render_depth(sdf, camera, num_steps=32,
                                 corner_table=table, early_exit=True,
                                 head_steps=0, tail_chunks=4,
                                 coarse_factor=2).depth
    multi = sharded.sharded_render_depth(
        sdf, camera, mesh8, num_steps=32, corner_table=table,
        early_exit=True, head_steps=0, tail_chunks=4, coarse_factor=2)
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               atol=1e-5)
    # The escape certificate must actually fire on this frame (most rays
    # fly past the small box), or the test is vacuous.
    _, _, _, esc = render_ops._cone_prepass(
        sdf, camera, 2, 32, 0.25 * sdf.resolution, 100.0, table)
    assert float(np.asarray(esc).mean()) > 0.1


def test_sharded_column_carve_matches(mesh8):
    """Column-marching carve under shard_map equals the single-device walk
    bit-for-bit (the determinism contract extends to the new carve)."""
    rng = np.random.default_rng(31)
    spec = GridSpec.from_voxel_counts(0.1, (16, 16, 16))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.8, 0.8, -0.5)
    pts = rng.uniform(-0.6, 2.2, (1600, 3)).astype(np.float32)
    cloud = voxelize.PointCloud.create(pts, pose)
    single = voxelize.raycast_pointcloud(spec, jnp.eye(4), cloud)
    multi = sharded.sharded_raycast_pointcloud(
        spec, jnp.eye(4), cloud, mesh8, run_axis=2)
    np.testing.assert_array_equal(np.asarray(single.seen_free),
                                  np.asarray(multi.seen_free))
    np.testing.assert_array_equal(np.asarray(single.seen_filled),
                                  np.asarray(multi.seen_filled))


def test_sharded_isosurface_matches_single_device(mesh8):
    """Concatenating the shards' valid triangles in shard order must equal
    the single-device extraction bit-for-bit (same cubes, same ops; only
    the slab partitioning differs)."""
    from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
    from voxelized_geometry_tools_tpu.ops import isosurface

    n, res = 32, 0.1
    spec = GridSpec.from_voxel_counts(res, (n, n, n))
    ax = jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0
    r = jnp.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                 + ax[None, None, :] ** 2)
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = (0.5, -1.0, 2.0)
    sdf = SignedDistanceField.create(spec, (r - 8.0) * res,
                                     jnp.asarray(shift), locked=True)

    single = isosurface.extract_isosurface(sdf, max_triangles=16384)
    multi, counts = jax.jit(
        lambda s: sharded.sharded_extract_isosurface(
            s, mesh8, max_triangles_per_shard=2048))(sdf)

    counts = np.asarray(counts)
    assert counts.shape == (8,)
    assert (counts <= 2048).all(), "per-shard capacity exceeded"
    assert int(multi.num_triangles) == int(single.num_triangles) \
        == int(counts.sum())
    v_single = np.asarray(single.vertices)[np.asarray(single.valid)]
    v_multi = np.asarray(multi.vertices)[np.asarray(multi.valid)]
    np.testing.assert_array_equal(v_multi, v_single)

    # Per-shard overflow must be detectable even when the TOTAL fits.
    small, small_counts = jax.jit(
        lambda s: sharded.sharded_extract_isosurface(
            s, mesh8, max_triangles_per_shard=8))(sdf)
    assert (np.asarray(small_counts) > 8).any()
    assert int(small.num_triangles) == int(single.num_triangles)
    # A single shard overflowing must trip the mesh's own overflow flag
    # (shard_counts-aware) and hence the weld truncation guard — the
    # aggregate total alone would NOT: 7344 < 8 * 8 is false here, but
    # construct the dangerous case explicitly below.
    assert bool(small.overflowed)
    with pytest.raises(ValueError, match="overflowed"):
        from voxelized_geometry_tools_tpu.ops import isosurface as iso
        iso.weld_vertices(small)
    # Dangerous case: totals fit the aggregate capacity, one shard drops.
    skewed = small._replace(
        num_triangles=jnp.int32(20),
        shard_counts=jnp.asarray([20, 0, 0, 0, 0, 0, 0, 0], jnp.int32))
    assert int(skewed.num_triangles) < skewed.capacity
    assert bool(skewed.overflowed)


@pytest.mark.slow
def test_sharded_render_pair_table_matches(mesh8):
    """The sharded renderer's static table-kind dispatch (z-pair vs brick)
    must give the same depths as the brick table and the plain render."""
    from voxelized_geometry_tools_tpu.ops import sdf_query
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    pair = sdf_query.build_corner_pair_table(sdf)
    assert pair.rows.shape == (16 * 16 * 16 // 4, 8)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16,
                                         focal=20.0)
    single = render.render_depth(sdf, camera, num_steps=32).depth
    multi = sharded.sharded_render_depth(
        sdf, camera, mesh8, num_steps=32, corner_table=pair,
        early_exit=True)
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               atol=1e-5)


def test_sharded_carve_reduce_scatter_matches(mesh8):
    """reduce='scatter' (psum_scatter to Z-slab-sharded tracking grids —
    per-device collective work scales with the shard) must produce the same logical grids as the replicated reduce and
    the single-device carve, for both a fixed run_axis and 'split'."""
    rng = np.random.default_rng(41)
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.0, 2.0, -1.0)
    pts = rng.uniform(-1.0, 5.0, (1500, 3)).astype(np.float32)
    cloud = voxelize.PointCloud.create(pts, pose, max_range=8.0)
    single = jax.jit(lambda c: voxelize.raycast_pointcloud(
        spec, jnp.eye(4), c))(cloud)
    for ra in (2, "split"):
        sc = jax.jit(lambda c, ra=ra: sharded.sharded_raycast_pointcloud(
            spec, jnp.eye(4), c, mesh8, run_axis=ra,
            reduce="scatter"))(cloud)
        np.testing.assert_array_equal(np.asarray(single.seen_free),
                                      np.asarray(sc.seen_free))
        np.testing.assert_array_equal(np.asarray(single.seen_filled),
                                      np.asarray(sc.seen_filled))
    # Indivisible nz fails fast instead of silently mispartitioning.
    odd = GridSpec.from_voxel_counts(0.25, (16, 16, 15))
    with pytest.raises(ValueError, match="divide nz"):
        sharded.sharded_raycast_pointcloud(
            odd, jnp.eye(4), cloud, mesh8, run_axis=2, reduce="scatter")


def test_sharded_voxelize_slab_pipeline_matches(mesh8):
    """The end-to-end sharded VoxelizePointClouds (scatter-reduced carve +
    slab-local fusion filter) equals the single-device pipeline exactly."""
    rng = np.random.default_rng(43)
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.0, 2.0, -1.0)
    clouds = [voxelize.PointCloud.create(
        rng.uniform(-1.0, 5.0, (700, 3)).astype(np.float32), pose,
        max_range=8.0) for _ in range(2)]
    env = OccupancyMap.create(spec, default_occupancy=0.5)
    opts = voxelize.FilterOptions(0.5, 1, 1)
    # run_axis=2 keeps the pipeline jittable (the eager 'auto' probe is
    # covered by test_sharded_carve_run_axis_auto_eager); un-jitted this
    # test read 103 s of eager shard_map dispatch.
    single = jax.jit(lambda cs: voxelize.voxelize_pointclouds(
        env, opts, cs))(clouds)
    multi = jax.jit(lambda cs: sharded.sharded_voxelize_pointclouds(
        env, opts, cs, mesh8, run_axis=2))(clouds)
    np.testing.assert_array_equal(np.asarray(single.occupancy),
                                  np.asarray(multi.occupancy))


@pytest.mark.slow
def test_sharded_carve_run_axis_auto_eager(mesh8):
    """run_axis='auto' with CONCRETE points (the backend layer's calling
    convention) must resolve to the column carve and stay bit-exact with
    both the explicit-axis column carve and the voxel walk."""
    rng = np.random.default_rng(31)
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    pts = np.stack([rng.uniform(0.5, 3.5, 200), rng.uniform(0.5, 3.5, 200),
                    np.full(200, 3.4)], -1).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.0, 2.0, 0.2)
    cloud = voxelize.PointCloud.create(pts, pose)
    auto = sharded.sharded_raycast_pointcloud(
        spec, jnp.eye(4), cloud, mesh8)  # run_axis defaults to "auto"
    explicit = sharded.sharded_raycast_pointcloud(
        spec, jnp.eye(4), cloud, mesh8, run_axis=2)
    walk = sharded.sharded_raycast_pointcloud(
        spec, jnp.eye(4), cloud, mesh8, run_axis=None)
    np.testing.assert_array_equal(np.asarray(auto.seen_free),
                                  np.asarray(explicit.seen_free))
    np.testing.assert_array_equal(np.asarray(auto.seen_free),
                                  np.asarray(walk.seen_free))
    np.testing.assert_array_equal(np.asarray(auto.seen_filled),
                                  np.asarray(walk.seen_filled))


@pytest.mark.slow
def test_grid_sharded_slab_table_matches_single_device(mesh8):
    """Slab-local corner table: the grid-sharded
    renderer with ``corner_rows`` must reproduce the single-chip
    corner-table march (ulp tolerance — different XLA programs fuse the
    identical interpolation expression differently), for slab axes both
    parallel and perpendicular to the view, and must be bit-invariant
    across its own (steps_per_exchange, ray_chunks) schedules."""
    from voxelized_geometry_tools_tpu.ops import sdf_query
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    table = sdf_query.build_corner_table(sdf)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16,
                                         focal=20.0)
    single = render.sphere_trace(
        sdf, *render.camera_rays(camera), num_steps=32,
        corner_table=table, early_exit=True, tail_chunks=1).depth
    for gax in (0, 2):
        rows = jax.jit(lambda d, gax=gax: sharded.sharded_build_corner_table(
            sdf.replace(distances=d), mesh8, grid_axis=gax))(sdf.distances)
        outs = []
        for k, rc in [(32, 1), (4, 16), (8, 4)]:
            multi = jax.jit(
                lambda d, r, gax=gax, k=k, rc=rc:
                sharded.sharded_render_depth_grid_sharded(
                    sdf.replace(distances=d), camera, mesh8, grid_axis=gax,
                    num_steps=32, steps_per_exchange=k, ray_chunks=rc,
                    corner_rows=r))(sdf.distances, rows)
            outs.append(np.asarray(multi))
        np.testing.assert_allclose(outs[0], np.asarray(single), atol=1e-5,
                                   err_msg=f"gax={gax}")
        for o in outs[1:]:  # schedule invariance stays bit-exact
            np.testing.assert_array_equal(outs[0], o)


@pytest.mark.slow
def test_grid_sharded_cone_prepass_contract(mesh8):
    """The replicated psum-sampled cone prepass inside the grid-sharded
    renderer obeys the single-chip prepass contract: hits are a superset
    of the plain march's, common depths agree within the convergence
    band, and the hit mask equals the single-chip prepass render's."""
    from voxelized_geometry_tools_tpu.ops import sdf_query
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    table = sdf_query.build_corner_table(sdf)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16,
                                         focal=20.0)
    plain = render.sphere_trace(
        sdf, *render.camera_rays(camera), num_steps=32,
        corner_table=table, early_exit=True, tail_chunks=1).depth
    rows = jax.jit(lambda d: sharded.sharded_build_corner_table(
        sdf.replace(distances=d), mesh8, grid_axis=0))(sdf.distances)
    multi = jax.jit(lambda d, r: sharded.sharded_render_depth_grid_sharded(
        sdf.replace(distances=d), camera, mesh8, grid_axis=0, num_steps=32,
        corner_rows=r, coarse_factor=8, cone_steps=16,
        cone_tail_chunks=4))(sdf.distances, rows)
    plain, multi = np.asarray(plain), np.asarray(multi)
    base_hit, cone_hit = plain < 99.0, multi < 99.0
    assert (base_hit <= cone_hit).all(), "prepass skipped a surface"
    m = base_hit & cone_hit
    atol = 2.0 * 0.25 * sdf.resolution + 1e-6
    np.testing.assert_allclose(multi[m], plain[m], atol=atol)
    single_cone = render.render_depth(
        sdf, camera, num_steps=32, corner_table=table, early_exit=True,
        coarse_factor=8, head_steps=0, tail_chunks=8, cone_steps=16,
        cone_tail_chunks=4)
    np.testing.assert_array_equal(np.asarray(single_cone.hit), cone_hit)


def test_grid_sharded_slab_table_guards(mesh8):
    """A slab table is axis-tagged (SlabCornerTable): rows built along one
    axis have the same shape as any other axis's on a cubic grid, so an
    untagged mix-up would render silent garbage — the renderer must
    reject both an axis mismatch and an untagged raw array."""
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16,
                                         focal=20.0)
    table = sharded.sharded_build_corner_table(sdf, mesh8, grid_axis=0)
    assert table.grid_axis == 0
    with pytest.raises(ValueError, match="grid_axis"):
        sharded.sharded_render_depth_grid_sharded(
            sdf, camera, mesh8, grid_axis=2, corner_rows=table)
    with pytest.raises(TypeError, match="SlabCornerTable"):
        sharded.sharded_render_depth_grid_sharded(
            sdf, camera, mesh8, grid_axis=0, corner_rows=table.rows)


@pytest.mark.parametrize("grid_sharded", [False, True])
def test_sharded_render_with_distance(mesh8, grid_sharded):
    """``with_distance`` adds each ray's final SDF sample, so a sharded
    render can be held to ``render.compare_with_plain_march``; the depth
    is the one the call returns without it."""
    from voxelized_geometry_tools_tpu.ops import sdf_query
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    filled = np.zeros(spec.counts, bool)
    filled[6:10, 6:10, 6:10] = True
    sdf = edt.extract_signed_distance_field(filled, spec, None)
    pose = transforms.isometry_from_translation((2.0, 2.0, -3.0))
    camera = render.PinholeCamera.create(pose, width=24, height=16,
                                         focal=20.0)
    if grid_sharded:
        rows = sharded.sharded_build_corner_table(sdf, mesh8, grid_axis=0)

        def run(**kw):
            return sharded.sharded_render_depth_grid_sharded(
                sdf, camera, mesh8, grid_axis=0, num_steps=32,
                corner_rows=rows, **kw)
        single = render.sphere_trace(
            sdf, *render.camera_rays(camera), num_steps=32,
            corner_table=sdf_query.build_corner_table(sdf),
            early_exit=True, tail_chunks=1)
    else:
        def run(**kw):
            return sharded.sharded_render_depth(sdf, camera, mesh8,
                                                num_steps=32, **kw)
        single = render.render_depth(sdf, camera, num_steps=32)
    depth, distance = jax.jit(lambda: run(with_distance=True))()
    assert depth.shape == distance.shape == (16, 24)
    np.testing.assert_array_equal(np.asarray(depth),
                                  np.asarray(jax.jit(run)()))
    hit = np.asarray(depth) < 99.0
    np.testing.assert_array_equal(hit, np.asarray(single.hit))
    np.testing.assert_allclose(np.asarray(distance)[hit],
                               np.asarray(single.distance)[hit], atol=1e-6)
    agreement = render.compare_with_plain_march(
        single, render.RenderResult(depth, hit, None, distance),
        spec.resolution)
    assert agreement.ok, agreement.describe()
