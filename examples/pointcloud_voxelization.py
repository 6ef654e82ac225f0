"""Pointcloud voxelization example: two-camera fusion on every backend.

Accelerator-native analogue of the reference's example/pointcloud_voxelization.cpp:
164-370: a 2 m^3 8-cell/axis grid with a filled floor, two synthetic depth
cameras whose analytic planes shadow opposite halves of the volume, fused
with percent_seen_free=1.0, then voxelized with EVERY available backend
(accelerator-jit / native-cpu / xla-interpret replace the reference's
CUDA / OpenCL / CPU) and cross-checked for identical results.
"""

# Allow running as `python examples/<name>.py` from a source checkout
# without installing the package.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

import voxelized_geometry_tools_tpu as vgt
from voxelized_geometry_tools_tpu.ops import backends, voxelize
from voxelized_geometry_tools_tpu.io import viz


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
    """The reference scene (pointcloud_voxelization.cpp:166-226)."""
    X_WG = _iso(translation=(-1.0, -1.0, -1.0))
    spec = vgt.GridSpec.from_grid_sizes(0.25, (2.0, 2.0, 2.0))
    static_env = vgt.OccupancyMap.create(spec, X_WG.astype(np.float32),
                                         "world")
    occ = np.asarray(static_env.occupancy).copy()
    occ[:, :, 0] = 1.0  # filled floor
    static_env = static_env.replace(occupancy=jnp.asarray(occ))

    X_CO = _iso(rotation=_rotz(-np.pi / 2) @ _rotx(-np.pi / 2))
    xs = np.arange(-2.0, 2.0 + 1e-9, 0.03125)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")

    def make_cloud(X_WC, z_rule):
        z = z_rule(gx)
        pts = np.stack([gx.ravel(), gy.ravel(), z.ravel()], axis=-1)
        return voxelize.PointCloud.create(
            pts.astype(np.float32), (X_WC @ X_CO).astype(np.float32))

    cam1 = make_cloud(_iso(translation=(-2.0, 0.0, 0.0)),
                      lambda x: np.where(x <= 0.0, 2.125, 4.0))
    cam2 = make_cloud(_iso(rotation=_rotz(np.pi / 2),
                           translation=(0.0, -2.0, 0.0)),
                      lambda x: np.where(x >= 0.0, 2.125, 4.0))
    return static_env, [cam1, cam2]


def check_voxelization(occ):
    """Expected-region oracle (pointcloud_voxelization.cpp:113-158)."""
    nx, ny, nz = occ.shape
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                v = occ[x, y, z]
                assert z != 0 or v == 1.0, (x, y, z, v)
                if z >= 1:
                    if (x == 3 and y >= 3) or (x >= 3 and y == 3):
                        assert v == 0.0, (x, y, z, v)
                    if (x == 4 and y >= 4) or (x >= 4 and y == 4):
                        assert v == 1.0, (x, y, z, v)
                    if x > 4 and y > 4:
                        assert v == 0.5, (x, y, z, v)


def main():
    static_env, clouds = make_scene()
    # 100% of points must see through for free; one camera suffices
    # (cpp:227-235).
    filter_options = voxelize.FilterOptions(
        percent_seen_free=1.0, outlier_points_threshold=1,
        num_cameras_seen_free=1)

    results = {}
    for available in backends.get_available_backends():
        name = available.device_name()
        print(f"Trying {name} voxelizer...")
        voxelizer = backends.make_pointcloud_voxelizer(
            available, logging_fn=print)

        def log_runtime(rt, name=name):
            print(f"  raycasting {rt.raycasting_time:.4f}s, "
                  f"filtering {rt.filtering_time:.4f}s")

        voxelized = voxelizer.voxelize_pointclouds(
            static_env, filter_options, clouds, runtime_log_fn=log_runtime)
        results[name] = np.asarray(voxelized.occupancy)
        marker = viz.export_occupancy_for_display(
            voxelized, collision_color=(0.25, 0.0, 0.0, 0.5),
            free_color=(0.0, 0.25, 0.0, 0.5),
            unknown_color=(0.0, 0.0, 0.25, 0.5))
        print(f"  display: {marker.num_cells} cells")

    # Validate each backend against the analytic oracle, like the
    # reference example (pointcloud_voxelization.cpp:113-158): exact
    # cross-backend equality is NOT required on voxels the oracle leaves
    # unconstrained (boundary-grazing rays are float-rounding sensitive,
    # exactly as between the reference's CPU-double and CUDA-float paths).
    for name, occ in results.items():
        check_voxelization(occ)
        print(f"{name}: oracle check PASSED")

    # Best-available selection (cpp:92-147 fallback order).
    backends.make_best_available_pointcloud_voxelizer(logging_fn=print)
    print("...done")


if __name__ == "__main__":
    main()
