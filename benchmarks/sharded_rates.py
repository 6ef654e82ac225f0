"""Sharded-path rates: EDT / carve / render under shard_map.

Records (a) the scaling shape on a virtual CPU mesh (relative numbers —
collective overhead and load balance, not throughput) and (b) GPU numbers
on meshes of 1, 2 and 4 cards as far as the machine has them, beside the
plain single-card path. Run:

  CPU virtual mesh:  python benchmarks/sharded_rates.py cpu
  GPU meshes:        python benchmarks/sharded_rates.py gpu
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from anywhere

import dataclasses
import json
import sys
import time

import jax


def _setup(mode):
    if mode == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    else:
        from voxelized_geometry_tools_tpu.utils.compile_cache import (
            enable_compile_cache)
        enable_compile_cache()


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    _setup(mode)

    import jax.numpy as jnp
    import numpy as np

    from voxelized_geometry_tools_tpu import GridSpec
    from voxelized_geometry_tools_tpu.core import transforms
    from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
    from voxelized_geometry_tools_tpu.ops import edt, render, voxelize
    from voxelized_geometry_tools_tpu.parallel import mesh_utils, sharded

    def timeit(fn, *args, iters=3):
        jax.block_until_ready(fn(*args))
        t0 = time.monotonic()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.monotonic() - t0) / iters

    n = 128 if mode == "cpu" else 512
    res = 0.01
    spec = GridSpec.from_voxel_counts(res, (n, n, n))
    ax = (jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0) ** 2
    mask = (ax[:, None, None] + ax[None, :, None]
            + ax[None, None, :]) <= (n / 4.0) ** 2
    _force(mask)

    rng = np.random.default_rng(0)
    # Config2-shaped cloud: 640x480 depth camera looking +z into the grid.
    w, h = 640, 480
    uv = np.stack(np.meshgrid(
        (np.arange(w) - w / 2) / 600.0, (np.arange(h) - h / 2) / 600.0,
        indexing="xy"), -1)
    depth = (0.55 * n * res) * (1.0 + 0.1 * rng.standard_normal((h, w)))
    pts = np.concatenate([uv * depth[..., None], depth[..., None]],
                         -1).reshape(-1, 3).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (n * res / 2, n * res / 2, -0.2 * n * res)
    cloud = voxelize.PointCloud.create(pts, pose, max_range=2.0 * n * res)

    sizes = [k for k in (1, 2, 4, 8) if k <= len(jax.devices())]
    results = {"mode": mode, "n": n}
    for k in sizes:
        mesh = mesh_utils.make_mesh(("z",), (k,), jax.devices()[:k])
        # jit every sharded call: shard_map invoked OUTSIDE jit executes
        # the mapped computation op by op eagerly.
        edt_fn = jax.jit(lambda m: sharded.sharded_signed_distance(
            m, res, mesh))
        t_edt = timeit(edt_fn, mask)
        carve_fn = jax.jit(lambda p: sharded.sharded_raycast_pointcloud(
            spec, jnp.eye(4),
            dataclasses.replace(cloud, points=p), mesh,
            run_axis=2).seen_free)
        t_carve = timeit(carve_fn, cloud.points)
        # reduce='scatter' keeps the fused tracking grid Z-slab sharded
        # (psum_scatter): per-device collective work scales with the shard
        # instead of the full grid.
        carve_sc_fn = jax.jit(lambda p: sharded.sharded_raycast_pointcloud(
            spec, jnp.eye(4),
            dataclasses.replace(cloud, points=p), mesh,
            run_axis=2, reduce="scatter").seen_free)
        t_carve_sc = timeit(carve_sc_fn, cloud.points)
        values = edt_fn(mask)
        sdf = SignedDistanceField.create(spec, values, locked=True)
        size = n * res
        cpose = np.eye(4, dtype=np.float32)
        cpose[:3, 3] = (size / 2, size / 2, -1.2 * size)
        cam = render.PinholeCamera.create(cpose, 256, 256, focal=300.0)
        render_fn = jax.jit(lambda d: sharded.sharded_render_depth(
            sdf.replace(distances=d), cam, mesh, early_exit=True,
            head_steps=2, tail_chunks=16, coarse_factor=4))
        t_render = timeit(render_fn, sdf.distances)
        render_gs_fn = jax.jit(
            lambda d: sharded.sharded_render_depth_grid_sharded(
                sdf.replace(distances=d), cam, mesh, steps_per_exchange=8))
        t_render_gs = timeit(render_gs_fn, sdf.distances)
        # Scaling mode: shard the grid PERPENDICULAR to the view
        # (grid_axis=0 for this +z-looking camera: rays distribute across
        # X slabs by pixel column and almost never cross) with owner
        # compaction (ray_chunks) so per-device sampling cost tracks its
        # resident rays. steps_per_exchange=32: crossings are rare, so
        # fewer phases — the inner chunk loops early-exit anyway.
        # ray_chunks=64: finer chunks track the 1/K resident fraction.
        render_gsx_fn = jax.jit(
            lambda d: sharded.sharded_render_depth_grid_sharded(
                sdf.replace(distances=d), cam, mesh, steps_per_exchange=32,
                grid_axis=0, ray_chunks=64))
        t_render_gsx = timeit(render_gsx_fn, sdf.distances)
        results[f"mesh{k}"] = {
            "edt_s": t_edt, "carve_s": t_carve,
            "carve_scatter_s": t_carve_sc,
            "render_pixel_sharded_s": t_render,
            "render_grid_sharded_s": t_render_gs,
            "render_grid_sharded_xaxis_s": t_render_gsx,
        }
        print(f"mesh={k}: EDT {t_edt:.3f}s  carve {t_carve:.3f}s  "
              f"carve(scatter) {t_carve_sc:.3f}s  "
              f"render(pixel) {t_render:.3f}s  render(grid,z) "
              f"{t_render_gs:.3f}s  render(grid,x+compact) "
              f"{t_render_gsx:.3f}s")

    if mode == "gpu":
        # Single-card plain-path numbers for the overhead comparison.
        t_edt1 = timeit(jax.jit(
            lambda m: edt.signed_distance_from_filled_mask(m, res)), mask)
        plain_carve = jax.jit(lambda p: voxelize.raycast_pointcloud_columns(
            spec, jnp.eye(4),
            dataclasses.replace(cloud, points=p)).seen_free)
        t_carve1 = timeit(plain_carve, cloud.points)
        print(f"plain single-card: EDT {t_edt1:.3f}s  carve {t_carve1:.3f}s")
        results["plain"] = {"edt_s": t_edt1, "carve_s": t_carve1}

    print(json.dumps(results))


if __name__ == "__main__":
    main()
