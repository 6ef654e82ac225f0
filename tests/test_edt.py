"""SDF generation golden tests.

Ports the oracle fixtures from /root/reference/test/sdf_generation_test.cpp:
degenerate fully-filled/empty grids, center/corner/face obstacles with
hand-computed extrema (tolerance 1e-4, sdf_generation_test.cpp:22), and the
exact Linear/Planar/Cube fixtures (:587-1056). A brute-force O(n^2) numpy EDT
provides an independent full-field oracle.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest

from voxelized_geometry_tools_tpu import GridSpec
from voxelized_geometry_tools_tpu.ops import edt

TOL = 1e-4


def brute_force_sdf(filled: np.ndarray, resolution: float) -> np.ndarray:
    """O(V^2) reference: distance to nearest filled minus nearest free."""
    shape = filled.shape
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    filled_pts = coords[filled.reshape(-1)]
    free_pts = coords[~filled.reshape(-1)]

    def min_dist(points):
        if len(points) == 0:
            return np.full(coords.shape[0], np.inf)
        d2 = ((coords[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        return np.sqrt(d2.min(axis=1))

    sdf = (min_dist(filled_pts) - min_dist(free_pts)) * resolution
    return sdf.reshape(shape)


def make_test_grid():
    # 1.0 x 2.0 x 3.0 m at 0.25 m -> 4 x 8 x 12 voxels
    # (sdf_generation_test.cpp:267-272).
    return GridSpec.from_grid_sizes(0.25, (1.0, 2.0, 3.0))


def test_grid_sizes_from_physical():
    spec = make_test_grid()
    assert spec.counts == (4, 8, 12)


def test_fully_filled():
    spec = make_test_grid()
    filled = np.ones(spec.counts, dtype=bool)
    sdf = edt.signed_distance_from_filled_mask(filled, spec.resolution)
    assert np.all(np.asarray(sdf) == -np.inf)


def test_fully_empty():
    spec = make_test_grid()
    filled = np.zeros(spec.counts, dtype=bool)
    sdf = edt.signed_distance_from_filled_mask(filled, spec.resolution)
    assert np.all(np.asarray(sdf) == np.inf)


def test_center_obstacle():
    # sdf_generation_test.cpp:370-443.
    spec = make_test_grid()
    filled = np.zeros(spec.counts, dtype=bool)
    filled[1:3, 2:6, 3:9] = True
    sdf = np.asarray(
        edt.signed_distance_from_filled_mask(filled, spec.resolution))
    res = spec.resolution
    expected_max = np.sqrt(res ** 2 + (2 * res) ** 2 + (3 * res) ** 2)
    assert abs(sdf.min() - (-0.25)) < TOL
    assert abs(sdf.max() - expected_max) < TOL
    # Sign consistency (cpp:231-256).
    assert np.all(sdf[filled] < 0)
    assert np.all(sdf[~filled] > 0)
    # Full-field agreement with brute force.
    np.testing.assert_allclose(sdf, brute_force_sdf(filled, res), atol=TOL)


def test_corner_obstacle():
    # sdf_generation_test.cpp:445-513.
    spec = make_test_grid()
    filled = np.zeros(spec.counts, dtype=bool)
    filled[0:2, 0:4, 0:6] = True
    sdf = np.asarray(
        edt.signed_distance_from_filled_mask(filled, spec.resolution))
    assert abs(sdf.min() - (-0.5)) < TOL
    assert abs(sdf.max() - 1.8708) < 1e-3
    np.testing.assert_allclose(sdf, brute_force_sdf(filled, spec.resolution),
                               atol=TOL)


def test_face_obstacle():
    # sdf_generation_test.cpp:515-585.
    spec = make_test_grid()
    filled = np.zeros(spec.counts, dtype=bool)
    filled[:, :, 0] = True
    sdf = np.asarray(
        edt.signed_distance_from_filled_mask(filled, spec.resolution))
    assert abs(sdf.min() - (-0.25)) < TOL
    assert abs(sdf.max() - 2.75) < TOL


def test_linear_exact():
    # 1x1x4 grid, cells 0-1 filled -> [-2, -1, 1, 2]
    # (sdf_generation_test.cpp:587-702).
    filled = np.zeros((1, 1, 4), dtype=bool)
    filled[0, 0, 0:2] = True
    sdf = np.asarray(edt.signed_distance_from_filled_mask(filled, 1.0))
    np.testing.assert_allclose(sdf[0, 0], [-2.0, -1.0, 1.0, 2.0], rtol=1e-6)


def test_planar_exact():
    # 1x4x4 grid, y,z in [0,2) filled (sdf_generation_test.cpp:704-903).
    filled = np.zeros((1, 4, 4), dtype=bool)
    filled[0, 0:2, 0:2] = True
    sdf = np.asarray(edt.signed_distance_from_filled_mask(filled, 1.0))
    expected = np.array([
        [-2.0, -1.0, 1.0, 2.0],
        [-1.0, -1.0, 1.0, 2.0],
        [1.0, 1.0, np.sqrt(2.0), np.sqrt(5.0)],
        [2.0, 2.0, np.sqrt(5.0), np.sqrt(8.0)],
    ])
    np.testing.assert_allclose(sdf[0], expected, rtol=1e-6)


def test_cube_exact():
    # 2x2x2 grid, single corner voxel filled
    # (sdf_generation_test.cpp:905-1056).
    filled = np.zeros((2, 2, 2), dtype=bool)
    filled[0, 0, 0] = True
    sdf = np.asarray(edt.signed_distance_from_filled_mask(filled, 1.0))
    expected = np.array([
        [[-1.0, 1.0], [1.0, np.sqrt(2.0)]],
        [[1.0, np.sqrt(2.0)], [np.sqrt(2.0), np.sqrt(3.0)]],
    ])
    np.testing.assert_allclose(sdf, expected, rtol=1e-6)


def test_random_vs_brute_force():
    rng = np.random.default_rng(7)
    filled = rng.random((6, 7, 9)) < 0.3
    filled[0, 0, 0] = True  # guarantee both classes exist
    filled[5, 6, 8] = False
    sdf = np.asarray(edt.signed_distance_from_filled_mask(filled, 0.5))
    np.testing.assert_allclose(sdf, brute_force_sdf(filled, 0.5), atol=TOL)


def test_block_size_invariance():
    rng = np.random.default_rng(3)
    filled = rng.random((5, 16, 33)) < 0.2
    filled[2, 3, 4] = True
    a = np.asarray(edt.signed_distance_from_filled_mask(filled, 1.0, block=8))
    b = np.asarray(edt.signed_distance_from_filled_mask(filled, 1.0, block=64))
    np.testing.assert_array_equal(a, b)


def test_virtual_border():
    # With a virtual border, every outside-facing free cell sees the border as
    # filled, so the max distance is bounded by distance to the walls.
    filled = np.zeros((4, 4, 4), dtype=bool)
    sdf = np.asarray(edt.signed_distance_with_virtual_border(filled, 1.0))
    # Grid is empty -> all positive; center cells are 2 voxels from border.
    assert sdf.max() <= 2.0 + TOL
    assert np.all(sdf > 0)
    # A fully filled grid with virtual border: interior negative.
    sdf2 = np.asarray(
        edt.signed_distance_with_virtual_border(np.ones((4, 4, 4), bool), 1.0))
    assert np.all(sdf2 <= 0)


def test_extract_sdf_from_occupancy_unknown_handling():
    spec = GridSpec.from_voxel_counts(1.0, (1, 1, 4))
    occ = np.array([1.0, 0.5, 0.0, 0.0], np.float32).reshape(1, 1, 4)
    sdf_u_filled = edt.extract_sdf_from_occupancy(
        occ, spec, None, unknown_is_filled=True)
    sdf_u_free = edt.extract_sdf_from_occupancy(
        occ, spec, None, unknown_is_filled=False)
    d1 = np.asarray(sdf_u_filled.distances)[0, 0]
    d2 = np.asarray(sdf_u_free.distances)[0, 0]
    np.testing.assert_allclose(d1, [-2.0, -1.0, 1.0, 2.0], rtol=1e-6)
    np.testing.assert_allclose(d2, [-1.0, 1.0, 2.0, 3.0], rtol=1e-6)
    # Locked min/max caching.
    assert sdf_u_filled.locked
    assert float(sdf_u_filled.minimum) == -2.0
    assert float(sdf_u_filled.maximum) == 2.0


@pytest.mark.slow
def test_streamed_edt_bit_exact():
    """The slab-streamed pipeline (the 1024^3 single-chip path) must be
    bit-identical to the dense one: same per-line envelope math, only the
    slab scheduling differs. Covers non-divisible slab targets (divisor
    fallback) and the virtual-border variant."""
    rng = np.random.default_rng(11)
    seed = rng.random((20, 24, 28)) < 0.02
    dense = np.asarray(edt.squared_edt(jnp.asarray(seed), backend="xla"))
    for slab in (3, 7, 28):
        streamed = np.asarray(edt.squared_edt_streamed(
            jnp.asarray(seed), slab=slab, backend="xla"))
        np.testing.assert_array_equal(dense, streamed)

    res = 0.05
    dense_sdf = np.asarray(edt.signed_distance_from_filled_mask(
        jnp.asarray(seed), res))
    streamed_sdf = np.asarray(edt.signed_distance_from_filled_mask_streamed(
        jnp.asarray(seed), res, slab=5))
    np.testing.assert_array_equal(dense_sdf, streamed_sdf)

    spec = GridSpec.from_voxel_counts(res, seed.shape)
    for border in (False, True):
        a = edt.extract_signed_distance_field(
            jnp.asarray(seed), spec, None, add_virtual_border=border,
            streaming=False)
        b = edt.extract_signed_distance_field(
            jnp.asarray(seed), spec, None, add_virtual_border=border,
            streaming=True)
        np.testing.assert_array_equal(np.asarray(a.distances),
                                      np.asarray(b.distances))


def test_non_uniform_spec_rejected():
    """Cubic-only ops raise on non-uniform voxel sizes instead of silently
    mixing per-axis index math with scalar-resolution scaling (the
    reference enforces uniformity on map construction,
    signed_distance_field.hpp:612-615)."""
    from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
    from voxelized_geometry_tools_tpu.ops import voxelize

    spec = GridSpec.from_voxel_sizes((0.5, 1.0, 2.0), (2, 2, 2))
    with pytest.raises(ValueError, match="uniform"):
        SignedDistanceField.create(spec, np.zeros((2, 2, 2), np.float32))
    with pytest.raises(ValueError, match="uniform"):
        edt.extract_sdf_from_occupancy(np.zeros((2, 2, 2), np.float32),
                                       spec, None)
    cloud = voxelize.PointCloud.create(
        np.ones((4, 3), np.float32), np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="uniform"):
        voxelize.raycast_pointcloud(spec, jnp.eye(4), cloud)
    with pytest.raises(ValueError, match="uniform"):
        voxelize.raycast_pointcloud_columns(spec, jnp.eye(4), cloud)


def test_double_scalar_type():
    """Float + double instantiations (signed_distance_field.hpp:1268-1269;
    sdf_generation_test.cpp runs both scalar types, 295-313)."""
    import jax

    spec = GridSpec.from_voxel_counts(0.125, (1, 1, 4))
    occ = np.array([1.0, 1.0, 0.0, 0.0], np.float32).reshape(1, 1, 4)
    with jax.enable_x64():
        sdf64 = edt.extract_sdf_from_occupancy(occ, spec, None,
                                               dtype=jnp.float64)
        assert np.asarray(sdf64.distances).dtype == np.float64
        assert np.asarray(sdf64.minimum).dtype == np.float64
        np.testing.assert_allclose(
            np.asarray(sdf64.distances)[0, 0],
            np.array([-0.25, -0.125, 0.125, 0.25], np.float64), rtol=0,
            atol=0)

        # Serialization round-trip preserves the double scalar tag.
        from voxelized_geometry_tools_tpu.core import serialization
        from voxelized_geometry_tools_tpu.io import messages
        blob = serialization.to_file_bytes(sdf64)
        loaded = serialization.from_file_bytes(blob)
        assert np.asarray(loaded.distances).dtype == np.float64
        np.testing.assert_array_equal(np.asarray(loaded.distances),
                                      np.asarray(sdf64.distances))
        msg = messages.get_message_representation(sdf64)
        assert msg["scalar_type"] == messages.SCALAR_TYPE_DOUBLE

    # Without x64, requesting float64 raises instead of silently
    # downcasting (JAX emits its truncation UserWarning on the way to the
    # detected downcast — expected here, asserted so it can't leak into the
    # suite output as noise).
    sdf32 = edt.extract_sdf_from_occupancy(occ, spec, None)
    assert np.asarray(sdf32.distances).dtype == np.float32
    with pytest.raises(ValueError, match="float64"), \
            pytest.warns(UserWarning, match="truncated"):
        edt.extract_sdf_from_occupancy(occ, spec, None, dtype=jnp.float64)

    # A double file loads as float32 when x64 is off (graceful degradation).
    with jax.enable_x64():
        from voxelized_geometry_tools_tpu.core import serialization
        blob = serialization.to_file_bytes(
            edt.extract_sdf_from_occupancy(occ, spec, None,
                                           dtype=jnp.float64))
    from voxelized_geometry_tools_tpu.core import serialization
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        loaded32 = serialization.from_file_bytes(blob)
    assert np.asarray(loaded32.distances).dtype == np.float32


def test_streamed_edt_prime_and_anisotropic_shapes():
    """Prime dimensions take the PAD schedule (a divisor-poor axis must not
    serialize into slab=1 loops), and anisotropic grids slab over their
    LARGEST perpendicular axis — both must stay bit-identical to dense."""
    rng = np.random.default_rng(13)
    for shape in [(13, 17, 19), (4, 40, 6), (40, 4, 6), (6, 4, 40)]:
        seed = rng.random(shape) < 0.05
        seed[tuple(s // 2 for s in shape)] = True
        dense = np.asarray(edt.squared_edt(jnp.asarray(seed),
                                           backend="xla"))
        streamed = np.asarray(edt.squared_edt_streamed(
            jnp.asarray(seed), slab=8, backend="xla"))
        np.testing.assert_array_equal(dense, streamed)
    # The pad branch is actually exercised for a prime axis: 8 has no
    # divisor of 13/17/19 above 8//2.
    assert edt._slab_schedule(13, 8) == (8, 3)
    assert edt._slab_schedule(16, 8) == (8, 0)
    assert edt._slab_schedule(20, 8) == (5, 0)
