"""Grid-sharded render benchmark.

Measures, on one GPU with a 1-device mesh (collectives are free, so this
isolates the grid-sharded SCHEDULE cost — the owner-advances phases,
compaction, and sampling path — from the interconnect):

* 512^3: single-card z-pair-table render (the comparison bar),
  then the grid-sharded path with the slab-local corner table +
  replicated cone prepass, sweeping (steps_per_exchange, ray_chunks).
* 1024^3: the grid-sharded path with the cone prepass over the 8-gather
  sampler (a 1024^3 slab table at 1 shard is 34 GiB — the slab table fits
  per-device from 2+ shards, where each holds 1/K of it).

Run on a GPU from the repo root: ``python
benchmarks/gridshard_render.py [512|1024|all]`` (``JAX_PLATFORMS=cpu``
smoke-tests it on the CPU backend).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

from voxelized_geometry_tools_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)
enable_compile_cache()

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from voxelized_geometry_tools_tpu import GridSpec
from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
from voxelized_geometry_tools_tpu.ops import edt, render, sdf_query
from voxelized_geometry_tools_tpu.parallel import sharded
F = jax.block_until_ready

IMG_W, IMG_H = 640, 480
N_RAYS = IMG_W * IMG_H


def build_scene(n):
    spec = GridSpec.from_voxel_counts(0.01, (n, n, n))
    xs, ys, zs = np.meshgrid(*[np.arange(n)] * 3, indexing="ij",
                             sparse=True)
    c, r = n / 2.0, n / 4.0
    filled = ((xs - c) ** 2 + (ys - c) ** 2 + (zs - c) ** 2) <= r * r
    edt_fn = (edt.signed_distance_from_filled_mask_streamed if n >= 640
              else edt.signed_distance_from_filled_mask)
    vals = jax.jit(lambda m: edt_fn(m, spec.resolution))(jnp.asarray(filled))
    F(vals)
    sdf = SignedDistanceField.create(spec, vals, None, "bench", locked=True)
    sizes = np.asarray(spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.2 * sizes[2]])
    cam = render.PinholeCamera.create(pose, IMG_W, IMG_H, focal=600.0)
    return sdf, cam


def timeit(fn, *args, iters=5):
    out = fn(*args)
    F(out)
    t0 = time.monotonic()
    for _ in range(iters):
        out = fn(*args)
    F(out)
    return (time.monotonic() - t0) / iters


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("z",))
    num_steps = 96
    results = {}

    if which in ("512", "all"):
        sdf, cam = build_scene(512)
        pair = jax.jit(sdf_query.build_corner_pair_table)(sdf)
        dt = timeit(jax.jit(lambda d, t: render.render_depth(
            sdf.replace(distances=d), cam, num_steps=num_steps,
            corner_table=t, early_exit=True, coarse_factor=8,
            head_steps=0, tail_chunks=32, cone_steps=32,
            cone_tail_chunks=8).depth), sdf.distances, pair)
        results["512_singlechip_pair_ms"] = dt * 1e3
        print(f"512^3 single-chip pair table: {dt*1e3:.1f} ms "
              f"({N_RAYS/dt/1e6:.2f} M rays/s)", flush=True)
        del pair

        rows = jax.jit(lambda d: sharded.sharded_build_corner_table(
            sdf.replace(distances=d), mesh, grid_axis=0))(sdf.distances)
        F(rows)
        tb = timeit(jax.jit(lambda d: sharded.sharded_build_corner_table(
            sdf.replace(distances=d), mesh, grid_axis=0).rows.ravel()[:1]),
            sdf.distances, iters=3)
        results["512_slab_table_build_ms"] = tb * 1e3
        print(f"512^3 slab table build: {tb*1e3:.1f} ms", flush=True)
        for k_ex, rc in [(96, 32), (96, 64), (32, 32), (16, 32)]:
            dt = timeit(jax.jit(
                lambda d, r, k_ex=k_ex, rc=rc:
                sharded.sharded_render_depth_grid_sharded(
                    sdf.replace(distances=d), cam, mesh, grid_axis=0,
                    num_steps=num_steps, steps_per_exchange=k_ex,
                    ray_chunks=rc, corner_rows=r, coarse_factor=8,
                    cone_steps=32, cone_tail_chunks=8)),
                sdf.distances, rows)
            key = f"512_gridshard_table_cone_kex{k_ex}_rc{rc}_ms"
            results[key] = dt * 1e3
            print(f"512^3 grid-sharded table+cone k_ex={k_ex} rc={rc}: "
                  f"{dt*1e3:.1f} ms ({N_RAYS/dt/1e6:.2f} M rays/s)",
                  flush=True)
        del rows, sdf

    if which in ("1024", "all"):
        sdf, cam = build_scene(1024)
        for k_ex, rc in [(96, 64)]:
            dt = timeit(jax.jit(
                lambda d, k_ex=k_ex, rc=rc:
                sharded.sharded_render_depth_grid_sharded(
                    sdf.replace(distances=d), cam, mesh, grid_axis=0,
                    num_steps=num_steps, steps_per_exchange=k_ex,
                    ray_chunks=rc, coarse_factor=8,
                    cone_steps=32, cone_tail_chunks=8)),
                sdf.distances, iters=3)
            results[f"1024_gridshard_cone_kex{k_ex}_rc{rc}_ms"] = dt * 1e3
            print(f"1024^3 grid-sharded 8-gather+cone k_ex={k_ex} "
                  f"rc={rc}: {dt*1e3:.1f} ms "
                  f"({N_RAYS/dt/1e6:.2f} M rays/s)", flush=True)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
