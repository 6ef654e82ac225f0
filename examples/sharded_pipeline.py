"""Multi-device sharded pipeline: carve -> fuse -> EDT -> render on a mesh.

The reference is a single-process library (SURVEY.md section 2's
parallelism inventory: OpenMP loops and one GPU); this example shows the
Accelerator-native scaling story that replaces it — a `jax.sharding.Mesh` over
which:

* rays are sharded for the carve, with per-camera tracking grids fused by
  one `psum` (`parallel/sharded.py::sharded_raycast_pointcloud`),
* the grid is sharded by Z-slabs for the EDT, with the Z sweep transposed
  through the interconnect via `all_to_all` (`sharded_squared_edt`; on a
  GPU mesh each shard's envelope passes run the Triton kernel),
* pixels are sharded for the differentiable render
  (`sharded_render_depth`).

Runs anywhere: with fewer than 8 real devices it builds an 8-device
virtual CPU mesh (`--xla_force_host_platform_device_count`), the same
environment the test suite uses. Every sharded result is bit-identical to
the single-device path — the determinism contract that replaces the
reference's DegreeOfParallelism-invariance tests.
"""

# Allow running as `python examples/<name>.py` from a source checkout
# without installing the package.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os

if __name__ == "__main__":
    # Must happen before any jax backend initializes: append the virtual
    # device-count flag (setdefault would lose it when XLA_FLAGS is already
    # set in the environment).
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax
import jax.numpy as jnp

from voxelized_geometry_tools_tpu import GridSpec, OccupancyMap
from voxelized_geometry_tools_tpu.core import transforms
from voxelized_geometry_tools_tpu.ops import edt, render, voxelize
from voxelized_geometry_tools_tpu.parallel import mesh_utils, sharded


def main():
    print(f"devices: {jax.device_count()} x {jax.devices()[0].platform}")
    mesh = mesh_utils.make_mesh(("z",))
    n_dev = mesh.shape["z"]

    # --- Scene: a box room with a pillar, observed by two depth cameras ---
    spec = GridSpec.from_voxel_counts(0.125, (32, 32, 16))
    origin = transforms.isometry_from_translation((-2.0, -2.0, 0.0))
    env = OccupancyMap.create(spec, origin, "world")

    u, v = np.meshgrid(np.linspace(-0.6, 0.6, 64),
                       np.linspace(-0.45, 0.45, 48), indexing="ij")
    depth = 2.0 + 0.3 * np.exp(-((u / 0.2) ** 2 + (v / 0.2) ** 2))
    pts = np.stack([u * depth, v * depth, depth], -1).reshape(-1, 3)
    pose1 = np.eye(4, dtype=np.float32)
    pose1[:3, 3] = (0.0, 0.0, 1.0)
    pose2 = np.eye(4, dtype=np.float32)
    pose2[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    pose2[:3, 3] = (-1.8, 0.0, 1.0)
    clouds = [voxelize.PointCloud.create(pts.astype(np.float32), pose1),
              voxelize.PointCloud.create(pts.astype(np.float32), pose2)]
    options = voxelize.FilterOptions(1.0, 1, 1)

    # --- 1. Ray-sharded carving + fusion ---------------------------------
    # Everything below runs under jax.jit: shard_map invoked OUTSIDE jit
    # executes the mapped computation op by op eagerly — minutes of per-op
    # dispatch even on the virtual CPU mesh (parallel/sharded.py module
    # docstring).
    fused = jax.jit(lambda cs: sharded.sharded_voxelize_pointclouds(
        env, options, cs, mesh, run_axis=2))(clouds)
    occ = np.asarray(fused.occupancy)
    print(f"carved over {n_dev} ray shards: "
          f"{int((occ == 1.0).sum())} filled / {int((occ == 0.0).sum())} "
          f"free / {int((occ == 0.5).sum())} unknown")

    # --- 2. Z-slab-sharded EDT -------------------------------------------
    sdf = jax.jit(lambda o, tr: sharded.sharded_extract_sdf(
        o, spec, tr, mesh, frame="world"))(fused.occupancy,
                                           fused.origin_transform)
    single = edt.extract_sdf_from_occupancy(fused.occupancy, spec,
                                            fused.origin_transform)
    same = bool(jnp.array_equal(sdf.distances, single.distances))
    print(f"sharded EDT == single-device EDT: {same}")

    # --- 3. Pixel-sharded differentiable render --------------------------
    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[:3, 3] = (0.0, 0.0, 3.5)
    cam_pose[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]],
                                np.float32)
    camera = render.PinholeCamera.create(cam_pose, 64, 48, focal=60.0)
    depth_img = jax.jit(lambda d: sharded.sharded_render_depth(
        sdf.replace(distances=d), camera, mesh, num_steps=48))(
            sdf.distances)
    hits = np.asarray(depth_img) < 99.0
    print(f"rendered {hits.sum()} / {hits.size} hit pixels over "
          f"{n_dev} pixel shards")

    # --- 4. GRID-sharded render (grids too big to replicate) --------------
    # Shard the grid along an axis PERPENDICULAR to the view direction so
    # rays distribute across devices and almost never cross slabs (this
    # camera looks -z, so X slabs): every device then marches its own
    # resident rays concurrently instead of the slab wavefront
    # serializing. Depths are schedule-independent — identical to the
    # pixel-sharded render for any (grid_axis, steps_per_exchange,
    # ray_chunks).
    depth_gs = jax.jit(lambda d: sharded.sharded_render_depth_grid_sharded(
        sdf.replace(distances=d), camera, mesh, num_steps=48, grid_axis=0,
        steps_per_exchange=32, ray_chunks=16))(sdf.distances)
    same_render = bool(np.allclose(np.asarray(depth_img),
                                   np.asarray(depth_gs), atol=1e-4))
    print(f"grid-sharded render == pixel-sharded render: {same_render}")
    print("...done")


if __name__ == "__main__":
    main()
