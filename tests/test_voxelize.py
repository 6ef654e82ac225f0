"""Pointcloud voxelization tests.

Ports the reference oracles:

* the two-synthetic-camera fusion scene with exact expected occupancy per
  region (/root/reference/test/pointcloud_voxelization_test.cpp:160-295),
* the empty-clouds case (everything above the floor stays unknown), and
* the DDA count-invariant property test over 1000 random rays
  (/root/reference/test/voxel_raycasting_test.cpp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxelized_geometry_tools_tpu import GridSpec, OccupancyMap
from voxelized_geometry_tools_tpu.core import transforms
from voxelized_geometry_tools_tpu.ops import voxelize


def _rotz(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rotx(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _iso(rotation=None, translation=(0.0, 0.0, 0.0)):
    m = np.eye(4)
    if rotation is not None:
        m[:3, :3] = rotation
    m[:3, 3] = translation
    return m


def make_scene():
    """The pointcloud_voxelization_test scene (cpp:164-235)."""
    X_WG = _iso(translation=(-1.0, -1.0, -1.0))
    spec = GridSpec.from_grid_sizes(0.25, (2.0, 2.0, 2.0))
    static_env = OccupancyMap.create(spec, X_WG.astype(np.float32), "world")
    occ = np.asarray(static_env.occupancy).copy()
    occ[:, :, 0] = 1.0  # bottom layer filled
    static_env = static_env.replace(occupancy=jnp.asarray(occ))

    # Physical -> optical frame rotation (cpp:192-194).
    X_CO = _iso(rotation=_rotz(-np.pi / 2) @ _rotx(-np.pi / 2))

    xs = np.arange(-2.0, 2.0 + 1e-9, 0.03125)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")

    def make_cloud(X_WC, z_rule):
        z = z_rule(gx)
        pts = np.stack([gx.ravel(), gy.ravel(), z.ravel()], axis=-1)
        return voxelize.PointCloud.create(
            pts.astype(np.float32),
            (X_WC @ X_CO).astype(np.float32))

    cam1 = make_cloud(_iso(translation=(-2.0, 0.0, 0.0)),
                      lambda x: np.where(x <= 0.0, 2.125, 4.0))
    cam2 = make_cloud(_iso(rotation=_rotz(np.pi / 2),
                           translation=(0.0, -2.0, 0.0)),
                      lambda x: np.where(x >= 0.0, 2.125, 4.0))
    cam3 = voxelize.PointCloud.create(
        np.zeros((0, 3), np.float32), (_iso() @ X_CO).astype(np.float32))
    return static_env, [cam1, cam2, cam3]


def check_voxelization(occ: np.ndarray):
    """check_voxelization (cpp:113-158)."""
    nx, ny, nz = occ.shape
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                v = occ[x, y, z]
                if z == 0:
                    assert v == 1.0, (x, y, z, v)
                if x == 3 and y >= 3 and z >= 1:
                    assert v == 0.0, (x, y, z, v)
                if x >= 3 and y == 3 and z >= 1:
                    assert v == 0.0, (x, y, z, v)
                if x == 4 and y >= 4 and z >= 1:
                    assert v == 1.0, (x, y, z, v)
                if x >= 4 and y == 4 and z >= 1:
                    assert v == 1.0, (x, y, z, v)
                if x > 4 and y > 4 and z >= 1:
                    assert v == 0.5, (x, y, z, v)


def check_empty_voxelization(occ: np.ndarray):
    """check_empty_voxelization (cpp:84-111)."""
    assert np.all(occ[:, :, 0] == 1.0)
    assert np.all(occ[:, :, 1:] == 0.5)


def test_empty_voxelization():
    static_env, _ = make_scene()
    options = voxelize.FilterOptions(1.0, 1, 1)
    result = voxelize.voxelize_pointclouds(static_env, options, [])
    check_empty_voxelization(np.asarray(result.occupancy))


def test_two_camera_voxelization():
    static_env, clouds = make_scene()
    options = voxelize.FilterOptions(1.0, 1, 1)
    runtimes = []
    result = voxelize.voxelize_pointclouds(
        static_env, options, clouds, runtime_log_fn=runtimes.append)
    check_voxelization(np.asarray(result.occupancy))
    assert len(runtimes) == 1
    assert runtimes[0].raycasting_time >= 0.0
    assert runtimes[0].filtering_time >= 0.0


def test_chunking_invariance():
    static_env, clouds = make_scene()
    spec = static_env.spec
    a = voxelize.raycast_pointcloud(
        spec, static_env.origin_transform, clouds[0], ray_chunk=1000)
    b = voxelize.raycast_pointcloud(
        spec, static_env.origin_transform, clouds[0], ray_chunk=16384)
    np.testing.assert_array_equal(np.asarray(a.seen_free),
                                  np.asarray(b.seen_free))
    np.testing.assert_array_equal(np.asarray(a.seen_filled),
                                  np.asarray(b.seen_filled))


def test_filter_options_validation():
    with pytest.raises(ValueError):
        voxelize.FilterOptions(0.0, 1, 1).validate()
    with pytest.raises(ValueError):
        voxelize.FilterOptions(1.0, 0, 1).validate()
    with pytest.raises(ValueError):
        voxelize.FilterOptions(1.0, 1, 0).validate()


def test_counts_seen_as_rule():
    opts = voxelize.FilterOptions(0.5, 2, 1)
    free = jnp.array([0, 3, 0, 1, 3])
    filled = jnp.array([0, 0, 5, 1, 3])
    seen = np.asarray(voxelize.counts_seen_as(opts, free, filled))
    # filled=1 < outlier threshold 2 -> treated as 0.
    assert list(seen) == [int(voxelize.SeenAs.UNKNOWN),
                          int(voxelize.SeenAs.FREE),
                          int(voxelize.SeenAs.FILLED),
                          int(voxelize.SeenAs.FREE),
                          int(voxelize.SeenAs.FREE)]  # 3/6 = 0.5 >= 0.5


@pytest.mark.slow
def test_raycast_count_invariants():
    """voxel_raycasting_test.cpp: every voxel sees each ray at most once as
    free, at most once as filled, and never both."""
    spec = GridSpec.from_voxel_counts(0.125, (40, 40, 40))
    origin_transform = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(42)

    n_iters = 200
    origins = rng.uniform(-2.0, 7.0, size=(n_iters, 3))
    targets = rng.uniform(-2.0, 7.0, size=(n_iters, 3))

    for origin, target in zip(origins[:40], targets[:40]):
        grid = voxelize.raycast_single_point(
            spec, origin_transform, origin, target, max_range=10.0)
        free = np.asarray(grid.seen_free)
        filled = np.asarray(grid.seen_filled)
        assert free.min() >= 0 and free.max() <= 1
        assert filled.min() >= 0 and filled.max() <= 1
        assert not np.any((free > 0) & (filled > 0))


def test_raycast_straight_line():
    """A simple axis-aligned ray marks the expected cells."""
    spec = GridSpec.from_voxel_counts(1.0, (8, 1, 1))
    eye = np.eye(4, dtype=np.float32)
    grid = voxelize.raycast_single_point(
        spec, eye, (0.5, 0.5, 0.5), (6.5, 0.5, 0.5))
    free = np.asarray(grid.seen_free)[:, 0, 0]
    filled = np.asarray(grid.seen_filled)[:, 0, 0]
    np.testing.assert_array_equal(free, [1, 1, 1, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(filled, [0, 0, 0, 0, 0, 0, 1, 0])


def test_raycast_from_outside_grid():
    """Rays starting outside the grid clip to the entry point."""
    spec = GridSpec.from_voxel_counts(1.0, (4, 4, 4))
    eye = np.eye(4, dtype=np.float32)
    grid = voxelize.raycast_single_point(
        spec, eye, (-3.5, 2.5, 2.5), (2.5, 2.5, 2.5))
    free = np.asarray(grid.seen_free)
    filled = np.asarray(grid.seen_filled)
    np.testing.assert_array_equal(free[:, 2, 2], [1, 1, 0, 0])
    np.testing.assert_array_equal(filled[:, 2, 2], [0, 0, 1, 0])
    # A ray that misses entirely marks nothing.
    grid2 = voxelize.raycast_single_point(
        spec, eye, (-3.5, 10.0, 2.5), (2.5, 10.0, 2.5))
    assert np.asarray(grid2.seen_free).sum() == 0
    assert np.asarray(grid2.seen_filled).sum() == 0


def test_max_range_clipping():
    """Clipped rays mark their final voxel seen-free, not filled
    (cpu_pointcloud_voxelization.cpp:371-375)."""
    spec = GridSpec.from_voxel_counts(1.0, (8, 1, 1))
    eye = np.eye(4, dtype=np.float32)
    grid = voxelize.raycast_single_point(
        spec, eye, (0.5, 0.5, 0.5), (6.5, 0.5, 0.5), max_range=3.0)
    free = np.asarray(grid.seen_free)[:, 0, 0]
    filled = np.asarray(grid.seen_filled)[:, 0, 0]
    assert filled.sum() == 0
    # Endpoint at 3.5 -> cell 3 marked free by the clip rule.
    assert free[3] == 1


# -- Column-marching carve (the scatter-volume-reduced accelerator path) ----


def _compare_grids(a, b):
    np.testing.assert_array_equal(np.asarray(a.seen_free),
                                  np.asarray(b.seen_free))
    np.testing.assert_array_equal(np.asarray(a.seen_filled),
                                  np.asarray(b.seen_filled))


@pytest.mark.parametrize("accumulate", ["rows", "diff"])
def test_columns_bit_exact_vs_walk(accumulate):
    """raycast_pointcloud_columns must equal the voxel walk on every voxel
    (both use closed-form t with permutation-mapped tie priorities), in
    both accumulation modes."""
    rng = np.random.default_rng(42)
    spec = GridSpec.from_voxel_counts(0.05, (20, 24, 28))
    o = rng.uniform(0.2, 0.9, 3)
    pts_world = rng.uniform(-0.3, 1.6, (1500, 3))
    cloud = voxelize.PointCloud.create(
        (pts_world - o).astype(np.float32),
        transforms.isometry_from_translation(o), max_range=3.0)
    walk = voxelize.raycast_pointcloud(spec, jnp.eye(4), cloud)
    for axis in (0, 1, 2):
        cols = voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud,
                                                   run_axis=axis,
                                                   accumulate=accumulate)
        _compare_grids(walk, cols)


@pytest.mark.parametrize("accumulate", ["rows", "diff"])
def test_columns_bit_exact_clipped_and_origin(accumulate):
    """Range-clipped rays + non-identity grid origin, all run axes. Also
    covers final voxels beyond the grid (the edge-clamp-over-final rule)
    and mixed-sign z marches (the B- diff buckets)."""
    rng = np.random.default_rng(3)
    spec = GridSpec.from_voxel_counts(0.04, (25, 25, 25))
    origin = transforms.isometry_from_translation((0.2, -0.1, 0.05))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rotz(0.4).astype(np.float32)
    pose[:3, 3] = (-0.4, 0.5, 0.5)
    pts = rng.uniform(-0.2, 1.8, (1200, 3)).astype(np.float32)
    cloud = voxelize.PointCloud.create(pts, pose, max_range=1.1)
    walk = voxelize.raycast_pointcloud(spec, origin, cloud)
    for axis in (0, 1, 2):
        cols = voxelize.raycast_pointcloud_columns(spec, origin, cloud,
                                                   run_axis=axis,
                                                   accumulate=accumulate)
        _compare_grids(walk, cols)


def test_columns_bit_exact_camera_inside():
    """Camera inside the grid: rays march both z directions at once."""
    rng = np.random.default_rng(8)
    spec = GridSpec.from_voxel_counts(0.05, (24, 24, 24))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.6, 0.6, 0.55)
    pts = rng.uniform(-1.2, 1.2, (1500, 3)).astype(np.float32)
    cloud = voxelize.PointCloud.create(pts, pose)
    walk = voxelize.raycast_pointcloud(spec, jnp.eye(4), cloud)
    for accumulate in ("rows", "diff"):
        cols = voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud,
                                                   accumulate=accumulate)
        _compare_grids(walk, cols)


def test_columns_split_bit_exact_vs_walk():
    """run_axis='split' (each ray carved along its own dominant axis — the
    direction-independent oblique-camera path) must equal the voxel walk
    exactly, eagerly and under jit, including range clipping and a rotated
    camera so all three axis groups are populated."""
    rng = np.random.default_rng(7)
    spec = GridSpec.from_voxel_counts(0.05, (20, 24, 28))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rotz(0.7).astype(np.float32)
    pose[:3, 3] = (-0.3, -0.3, -0.3)
    # Omnidirectional targets: every dominant axis occurs.
    pts = rng.uniform(-1.5, 3.0, (1800, 3)).astype(np.float32)
    cloud = voxelize.PointCloud.create(pts, pose, max_range=2.0)
    walk = voxelize.raycast_pointcloud(spec, jnp.eye(4), cloud)
    split = voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud,
                                                run_axis="split")
    _compare_grids(walk, split)
    jitted = jax.jit(lambda p: voxelize.raycast_pointcloud_columns(
        spec, jnp.eye(4),
        voxelize.PointCloud(points=p, origin_transform=cloud.origin_transform,
                            max_range=cloud.max_range),
        run_axis="split"))
    _compare_grids(walk, jitted(cloud.points))
    with pytest.raises(ValueError, match="Unknown run_axis"):
        voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud,
                                            run_axis="bogus")


def test_columns_two_camera_oracle():
    """The two-camera oracle through a column-carve pipeline
    (pointcloud_voxelization_test.cpp:275-295 one-oracle-many-backends)."""
    static_env, clouds = make_scene()
    spec = static_env.spec
    options = voxelize.FilterOptions(1.0, 1, 1)
    grids = [voxelize.raycast_pointcloud_columns(
        spec, static_env.origin_transform, c,
        run_axis=voxelize.dominant_ray_axis(
            c, static_env.origin_transform)) for c in clouds]
    occupancy = voxelize.combine_and_filter(
        options, jnp.stack([g.seen_free for g in grids]),
        jnp.stack([g.seen_filled for g in grids]),
        static_env.occupancy)
    check_voxelization(np.asarray(occupancy))


@pytest.mark.parametrize("max_steps", [5, 100])
def test_columns_bit_exact_with_max_steps(max_steps):
    """A user max_steps is a per-ray VOXEL budget on both paths (the walk's
    DDA step budget); the column path truncates runs at the exact voxel the
    walk's budget would expire at, including the walk's round-up to whole
    64-step segments)."""
    rng = np.random.default_rng(17)
    spec = GridSpec.from_voxel_counts(0.05, (20, 24, 28))
    o = rng.uniform(0.2, 0.9, 3)
    pts_world = rng.uniform(-0.3, 1.6, (800, 3))
    cloud = voxelize.PointCloud.create(
        (pts_world - o).astype(np.float32),
        transforms.isometry_from_translation(o), max_range=3.0)
    walk = voxelize.raycast_pointcloud(spec, jnp.eye(4), cloud,
                                       max_steps=max_steps)
    for axis in (0, 1, 2):
        cols = voxelize.raycast_pointcloud_columns(
            spec, jnp.eye(4), cloud, max_steps=max_steps, run_axis=axis)
        _compare_grids(walk, cols)
    with pytest.raises(ValueError):
        voxelize.raycast_pointcloud_columns(
            spec, jnp.eye(4), cloud, max_steps=max_steps, accumulate="diff")


def test_columns_chunking_and_sorting_invariance():
    """Ray chunk size (and the in-chunk m-sort it triggers) must not change
    the counts."""
    rng = np.random.default_rng(9)
    spec = GridSpec.from_voxel_counts(0.05, (16, 16, 16))
    pts = rng.uniform(-0.5, 1.3, (3000, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.4, 0.4, -0.5)
    cloud = voxelize.PointCloud.create(pts, pose)
    a = voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud,
                                            ray_chunk=512)
    b = voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud,
                                            ray_chunk=65536)
    _compare_grids(a, b)


def test_huge_finite_sentinel_points_carve_correctly():
    """Depth sensors emit large finite sentinels (1e9 / FLT_MAX) instead of
    inf; with max_range unset these previously saturated the int32 index
    math, flipping the DDA step sign (free marks on the WRONG side of the
    camera) and breaking walk/column bit-exactness. The far-endpoint clamp
    bounds the endpoint at the grid's far corner, which is semantically
    interchangeable (out of grid either way; same in-grid span)."""
    spec = GridSpec.from_voxel_counts(1.0, (8, 8, 8))
    for cam_z, want_z in [(4.5, [0, 1, 2, 3, 4]), (0.5, [0])]:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (4.5, 4.5, cam_z)
        # 1e10 exercises int32 index saturation; ~FLT_MAX also overflows
        # the f32 norm (the clamp must normalize by max-abs first).
        pts = np.array([[0.0, 0.0, -1e10],
                        [0.0, 1e-6, -3.4e38]], np.float32)
        cloud = voxelize.PointCloud.create(pts, pose)  # max_range = inf
        walk = voxelize.raycast_pointcloud(spec, jnp.eye(4), cloud)
        cols = voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud)
        wf = np.asarray(walk.seen_free)
        marked_z = sorted(np.argwhere(wf > 0)[:, 2].tolist())
        assert marked_z == want_z, (cam_z, marked_z)
        assert int(np.asarray(walk.seen_filled).sum()) == 0
        np.testing.assert_array_equal(wf, np.asarray(cols.seen_free))
        np.testing.assert_array_equal(np.asarray(walk.seen_filled),
                                      np.asarray(cols.seen_filled))
