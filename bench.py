"""Benchmark: prints the card's name and power limit, then ONE JSON line
with the headline metric.

Headline (BASELINE.json): rays/sec for sphere-traced raycasting over a
512^3-voxel SDF (640x480 depth image, 64 march steps budget), plus EDT
voxels/sec, the corner-table build, a cluttered second scene, and the
column carve as secondary fields. The reference publishes no numbers, so
there is no baseline ratio. Every timed section ends in
``jax.block_until_ready``; the output names the device, and the script
fails without a GPU.
"""

import json
import time

import numpy as np

GRID_N = 512
IMG_W, IMG_H = 640, 480
NUM_STEPS = 64


def main():
    import jax
    import jax.numpy as jnp
    from voxelized_geometry_tools_tpu.utils.compile_cache import (
        enable_compile_cache)
    from voxelized_geometry_tools_tpu.utils.gpu import card_line, require_gpu
    require_gpu("bench.py")
    print(card_line(), flush=True)
    enable_compile_cache()
    _force = jax.block_until_ready
    from voxelized_geometry_tools_tpu import GridSpec
    from voxelized_geometry_tools_tpu.ops import edt, render, sdf_query

    spec = GridSpec.from_voxel_counts(0.01, (GRID_N, GRID_N, GRID_N))
    xs, ys, zs = np.meshgrid(*[np.arange(GRID_N)] * 3, indexing="ij",
                             sparse=True)
    c = GRID_N / 2.0
    r = GRID_N / 4.0
    filled = ((xs - c) ** 2 + (ys - c) ** 2 + (zs - c) ** 2) <= r * r

    # --- EDT benchmark -------------------------------------------------
    edt_fn = jax.jit(
        lambda m: edt.signed_distance_from_filled_mask(m, spec.resolution))
    mask = jnp.asarray(filled)
    sdf_values = edt_fn(mask)
    _force(sdf_values)  # compile + warmup
    edt_iters = 5
    t0 = time.monotonic()
    for _ in range(edt_iters):
        sdf_values = edt_fn(mask)
    _force(sdf_values)
    edt_time = (time.monotonic() - t0) / edt_iters
    edt_voxels_per_sec = spec.num_total / edt_time

    from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
    sdf = SignedDistanceField.create(spec, sdf_values, None, "bench",
                                     locked=True)

    # --- Acceleration structure (built once per locked SDF) ------------
    # No mip: an exact SDF already self-skips empty space (sphere-trace
    # steps equal the true distance), so the coarse phase only adds gather
    # cost — measured slower on this scene. Mip stays available for
    # truncated/occupancy-derived fields.
    table_fn = jax.jit(sdf_query.build_corner_table)
    table = table_fn(sdf)
    _force(table.rows)
    t0 = time.monotonic()
    table = table_fn(sdf)
    _force(table.rows)
    accel_build_time = time.monotonic() - t0

    # --- Raycast benchmark ----------------------------------------------
    sizes = np.asarray(spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.2 * sizes[2]])
    camera = render.PinholeCamera.create(pose, IMG_W, IMG_H, focal=520.0)

    # Shipped schedule: one cone per 8x8 pixel block (32-step budget, its
    # own 8-chunk sorted tail), no full-width fine steps — the tail sorts
    # whole cone blocks by the cone's own march slowness and retires
    # escape-certified rays without marching them. Tuned on the earlier
    # accelerator; not re-tuned on the H100.
    render_fn = jax.jit(lambda d, t: render.render_depth(
        sdf.replace(distances=d), camera, num_steps=NUM_STEPS,
        corner_table=t, early_exit=True, coarse_factor=8,
        head_steps=0, tail_chunks=32, cone_steps=32,
        cone_tail_chunks=8).depth)
    depth = render_fn(sdf.distances, table)
    _force(depth)  # compile + warmup

    n_rays = IMG_W * IMG_H
    iters = 10
    t0 = time.monotonic()
    for _ in range(iters):
        depth = render_fn(sdf.distances, table)
    _force(depth)
    render_time = (time.monotonic() - t0) / iters
    rays_per_sec = n_rays / render_time

    hit_frac = float((np.asarray(depth) < 99.0).mean())

    # --- Cluttered second scene -----------------------------------------
    # The reference's production shape is multi-camera fused clutter
    # (example/pointcloud_voxelization.cpp:166-226), so also render
    # scattered spheres over a floor slab with the same schedule. Grid and
    # image shapes are identical, so the compiled executables are reused.
    rng = np.random.default_rng(42)
    clutter = np.zeros((GRID_N, GRID_N, GRID_N), bool)
    clutter[:, :, :24] = True  # floor slab (+z is up in grid frame)
    for _ in range(14):
        cc = rng.uniform(0.15, 0.85, 3) * GRID_N
        cr = rng.uniform(20.0, 60.0)
        clutter |= ((xs - cc[0]) ** 2 + (ys - cc[1]) ** 2
                    + (zs - cc[2]) ** 2) <= cr * cr
    clutter_vals = edt_fn(jnp.asarray(clutter))
    clutter_sdf = SignedDistanceField.create(spec, clutter_vals, None,
                                             "clutter", locked=True)
    clutter_table = table_fn(clutter_sdf)
    cdepth = render_fn(clutter_vals, clutter_table)
    _force(cdepth)  # warm (cache hit — same shapes)
    t0 = time.monotonic()
    for _ in range(iters):
        cdepth = render_fn(clutter_vals, clutter_table)
    _force(cdepth)
    clutter_render_time = (time.monotonic() - t0) / iters
    clutter_rays_per_sec = n_rays / clutter_render_time
    clutter_hit_frac = float((np.asarray(cdepth) < 99.0).mean())

    # --- Reference-equivalent CPU baseline -----------------------------
    # The native C++ runtime reimplements the reference's F-H EDT exactly
    # (native/vgt_native.cpp); measuring it on this host gives the honest
    # same-machine CPU number the reference would post (no published
    # numbers exist). 128^3 keeps the bench fast; the
    # per-voxel rate is scale-stable for this O(n) transform.
    native_edt_rate = None
    try:
        from voxelized_geometry_tools_tpu import native
        if native.available():
            n_small = 128
            ax = np.arange(n_small)
            sx, sy, sz = np.meshgrid(ax, ax, ax, indexing="ij", sparse=True)
            small = (((sx - 64) ** 2 + (sy - 64) ** 2 + (sz - 64) ** 2)
                     <= 32 * 32).astype(np.uint8)
            native.edt_sdf(small, 0.01)  # warm the code path
            # Median-of-3: the host CPU comparators wobbled 13-19 M
            # voxels/s across rounds from single-run host-load noise.
            times = []
            for _ in range(3):
                t0 = time.monotonic()
                native.edt_sdf(small, 0.01)
                times.append(time.monotonic() - t0)
            native_edt_rate = n_small ** 3 / sorted(times)[1]
    except Exception:
        pass

    # --- Carve benchmark (config2: 640x480 depth camera -> 128^3) -------
    # Column-marching carve (ops/voxelize.raycast_pointcloud_columns) vs
    # the reference-equivalent native CPU DDA on this host.
    carve_rays_per_sec = None
    native_carve_rays_per_sec = None
    try:
        import dataclasses
        from voxelized_geometry_tools_tpu import GridSpec as _GS
        from voxelized_geometry_tools_tpu.ops import voxelize as _vx
        cspec = _GS.from_voxel_counts(0.02, (128, 128, 128))
        cu, cv = np.meshgrid(np.linspace(-0.5, 0.5, 640),
                             np.linspace(-0.4, 0.4, 480), indexing="ij")
        cdep = 2.2 + 0.2 * np.sin(6 * cu) * np.cos(6 * cv)
        cpts = np.stack([cu * cdep, cv * cdep, cdep], -1).reshape(-1, 3)
        cpose = np.eye(4, dtype=np.float32)
        cpose[:3, 3] = (1.28, 1.28, -1.0)
        ccloud = _vx.PointCloud.create(cpts.astype(np.float32), cpose)
        carve_fn = jax.jit(lambda p: _vx.raycast_pointcloud_columns(
            cspec, jnp.eye(4), dataclasses.replace(ccloud, points=p),
            run_axis=2).seen_free)
        out = carve_fn(ccloud.points)
        _force(out)
        carve_iters = 5
        t0 = time.monotonic()
        for _ in range(carve_iters):
            out = carve_fn(ccloud.points)
        _force(out)
        carve_rays_per_sec = (carve_iters * cpts.shape[0]
                              / (time.monotonic() - t0))
        from voxelized_geometry_tools_tpu import native
        if native.available():
            times = []
            for _ in range(3):  # median-of-3, same rationale as native EDT
                t0 = time.monotonic()
                native.raycast(cpose[:3, 3].astype(np.float32),
                               (cpts + cpose[:3, 3]).astype(np.float32),
                               float("inf"), cspec.counts, cspec.resolution,
                               0)
                times.append(time.monotonic() - t0)
            native_carve_rays_per_sec = cpts.shape[0] / sorted(times)[1]
    except Exception:
        pass

    device = jax.devices()[0]
    print(json.dumps({
        "metric": "rays_per_sec_512cube_sdf_raycast",
        "value": rays_per_sec,
        "unit": "rays/s",
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "extras": {
            "edt_voxels_per_sec": edt_voxels_per_sec,
            "edt_time_s_512cube": edt_time,
            "render_time_s_640x480": render_time,
            "accel_build_time_s": accel_build_time,
            "num_march_steps": NUM_STEPS,
            "hit_fraction": hit_frac,
            "clutter_rays_per_sec": clutter_rays_per_sec,
            "clutter_render_time_s": clutter_render_time,
            "clutter_hit_fraction": clutter_hit_frac,
            "native_cpu_edt_voxels_per_sec": native_edt_rate,
            "carve_rays_per_sec_config2": carve_rays_per_sec,
            "native_cpu_carve_rays_per_sec_config2":
                native_carve_rays_per_sec,
        },
    }))


if __name__ == "__main__":
    main()
