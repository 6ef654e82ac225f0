"""Checks that only mean something on a GPU; they skip elsewhere.

Run on a machine with a card (from the repository root)::

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxelized_geometry_tools_tpu.core import transforms
from voxelized_geometry_tools_tpu.models import fusion_pipeline
from voxelized_geometry_tools_tpu.ops import isosurface, voxelize

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {platform!r}")


def _random_isometry(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.linalg.det(q))
    m = np.eye(4)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-3.0, 3.0, 3)
    return m


def _se3_exp_f64(tangent):
    w, t = tangent[:3], tangent[3:]
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    th = np.linalg.norm(w)
    m = np.eye(4)
    m[:3, :3] = (np.eye(3) + np.sin(th) / th * k
                 + (1 - np.cos(th)) / th ** 2 * k @ k)
    m[:3, 3] = t
    return m


def _sites(rng):
    """``(name, jax_fn, args, float64 reference)`` for each float32 product
    on the pose and carve path, each through the function the library
    itself calls."""
    a, b = _random_isometry(rng), _random_isometry(rng)
    perm = (1, 2, 0)                      # run_axis=0 of the column carve
    p4 = np.zeros((4, 4))
    p4[[0, 1, 2, 3], [1, 2, 0, 3]] = 1.0
    tangent = rng.uniform(-0.3, 0.3, 6)
    grad_minv = rng.standard_normal((6, 3, 3))
    dv = rng.standard_normal((6, 3, 64, 64))
    return [
        ("transforms.invert_isometry", transforms.invert_isometry, (a,),
         np.linalg.inv(a)),
        ("transforms.compose", transforms.compose, (a, b), a @ b),
        ("voxelize.grid_from_camera", voxelize.grid_from_camera, (a, b),
         np.linalg.inv(a) @ b),
        ("voxelize._permuted_grid_origin",
         lambda g: voxelize._permuted_grid_origin(g, perm), (a,),
         a @ p4.T),
        ("fusion_pipeline.se3_exp", fusion_pipeline.se3_exp, (tangent,),
         _se3_exp_f64(tangent)),
        ("fusion_pipeline.perturb_pose", fusion_pipeline.perturb_pose,
         (a, tangent), _se3_exp_f64(tangent) @ a),
        ("isosurface.winding_gradient", isosurface.winding_gradient,
         (grad_minv, dv), np.einsum("tij,tjyz->tiyz", grad_minv, dv)),
    ]


@pytest.mark.parametrize("index", range(7))
def test_float32_products_keep_float32_precision(gpu, index):
    """A float32 product on the card may run as TF32 (about 3 decimal
    digits); each site must agree with float64 to 1e-6 of its scale."""
    name, fn, args, want = _sites(np.random.default_rng(index))[index]
    got = np.asarray(jax.jit(fn)(*[jnp.asarray(x, jnp.float32)
                                   for x in args]), np.float64)
    err = np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))
    assert err <= 1e-6, f"{name}: relative error {err:.3g}"


@pytest.mark.parametrize("run_axis", [0, 1])
def test_permuted_column_carve_matches_voxel_walk(gpu, run_axis):
    """The column carve in a permuted grid frame (both pose products of the
    carve inside one jitted program) stays bit-exact with the voxel walk on
    the card; a TF32 product would move the permuted origin and break the
    tie-for-tie agreement."""
    from voxelized_geometry_tools_tpu import GridSpec
    from voxelized_geometry_tools_tpu.utils.workcell import WorkcellScene
    scene = WorkcellScene.make(64, 0)
    spec = GridSpec.from_voxel_counts(scene.resolution, (64, 64, 64))
    origin = jnp.eye(4, dtype=jnp.float32)
    pose = scene.camera_poses()[run_axis]
    cloud = voxelize.PointCloud.create(
        scene.depth_points(pose, 128, 96, 104.0), pose)
    cols = jax.jit(lambda c: voxelize.raycast_pointcloud_columns(
        spec, origin, c, run_axis=run_axis))(cloud)
    walk = jax.jit(lambda c: voxelize.raycast_pointcloud(
        spec, origin, c))(cloud)
    for field in ("seen_free", "seen_filled"):
        np.testing.assert_array_equal(np.asarray(getattr(cols, field)),
                                      np.asarray(getattr(walk, field)))


@pytest.mark.parametrize("axis", [1, 2])
def test_triton_envelope_matches_xla_on_card(gpu, axis):
    from voxelized_geometry_tools_tpu.kernels import edt_triton
    from voxelized_geometry_tools_tpu.ops import edt
    rng = np.random.default_rng(axis)
    shape = (64, 256, 200)
    f = np.where(rng.random(shape) < 0.3, np.inf,
                 rng.integers(0, 4000, shape)).astype(np.float32)
    got = edt_triton.envelope_along_axis(jnp.asarray(f), axis)
    want = edt._envelope_axis(jnp.asarray(f), axis, 512, "xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
