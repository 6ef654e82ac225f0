"""Oblique-camera carve generality measurement.

The column-marching carve degrades toward one scatter row per voxel when
rays run orthogonal to ``run_axis``; the reference's DDA cost is direction-
independent (cpu_pointcloud_voxelization.cpp:292-435). This measures a
camera at 45 degrees to ALL grid axes — the worst case for any single run
axis — for the walk and the column carve at each run_axis, plus the
``dominant_ray_axis`` pick, to document the crossover guidance.

Run on a GPU: ``python benchmarks/carve_oblique.py``.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from anywhere

import dataclasses
import json
import time

import jax

from voxelized_geometry_tools_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)
enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from voxelized_geometry_tools_tpu import GridSpec
from voxelized_geometry_tools_tpu.ops import voxelize


def _force(x):
    return jax.block_until_ready(x)


def timed(fn, iters=5):
    out = fn()
    _force(out)
    t0 = time.monotonic()
    for _ in range(iters):
        out = fn()
    _force(out)
    return (time.monotonic() - t0) / iters


def make_cloud(direction):
    """640x480 depth camera looking along `direction` through the grid
    center (config2 scale: 128^3 at 0.02 m)."""
    direction = np.asarray(direction, np.float64)
    fwd = direction / np.linalg.norm(direction)
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.9:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    u, v = np.meshgrid(np.linspace(-0.5, 0.5, 640),
                       np.linspace(-0.4, 0.4, 480), indexing="ij")
    depth = 2.2 + 0.2 * np.sin(6 * u) * np.cos(6 * v)
    pts = np.stack([u * depth, v * depth, depth], -1).reshape(-1, 3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, down, fwd
    center = np.full(3, 1.28)
    pose[:3, 3] = center - 1.8 * fwd
    return voxelize.PointCloud.create(pts.astype(np.float32), pose)


def main():
    spec = GridSpec.from_voxel_counts(0.02, (128, 128, 128))
    eye = jnp.eye(4)
    n_rays = 640 * 480
    results = {}
    for name, direction in [("axis_aligned_z", (0, 0, 1)),
                            ("oblique_45_all_axes", (1, 1, 1))]:
        cloud = make_cloud(direction)
        row = {}
        # jit the whole carve: eager per-op dispatch would be timed
        # otherwise.
        walk_fn = jax.jit(lambda p: voxelize.raycast_pointcloud(
            spec, eye, dataclasses.replace(cloud, points=p)).seen_free)
        t = timed(lambda: walk_fn(cloud.points))
        row["walk_ms"] = t * 1e3
        for ax in (0, 1, 2):
            col_fn = jax.jit(
                lambda p, a=ax: voxelize.raycast_pointcloud_columns(
                    spec, eye, dataclasses.replace(cloud, points=p),
                    run_axis=a).seen_free)
            t = timed(lambda: col_fn(cloud.points))
            row[f"columns_axis{ax}_ms"] = t * 1e3
        split_fn = jax.jit(
            lambda p: voxelize.raycast_pointcloud_columns(
                spec, eye, dataclasses.replace(cloud, points=p),
                run_axis="split").seen_free)
        t = timed(lambda: split_fn(cloud.points))
        row["columns_split_ms"] = t * 1e3
        row["dominant_axis"] = voxelize.dominant_ray_axis(cloud, np.eye(4))
        row["pick_run_axis"] = voxelize.pick_run_axis(cloud, np.eye(4))
        results[name] = row
        best = min(row[f"columns_axis{a}_ms"] for a in (0, 1, 2))
        print(f"{name}: walk {row['walk_ms']:.1f} ms "
              f"({n_rays / row['walk_ms'] * 1e3 / 1e6:.2f} M rays/s); "
              f"columns per-axis "
              + ", ".join(f"a{a}={row[f'columns_axis{a}_ms']:.1f}"
                          for a in (0, 1, 2))
              + f" ms (best {n_rays / best * 1e3 / 1e6:.2f} M rays/s); "
              f"split {row['columns_split_ms']:.1f} ms "
              f"({n_rays / row['columns_split_ms'] * 1e3 / 1e6:.2f} "
              f"M rays/s); dominant_ray_axis -> {row['dominant_axis']}, "
              f"pick_run_axis -> {row['pick_run_axis']}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
