"""Beyond-512^3 on one card: slab-streamed EDT + renders at 768/1024^3.

The slab-streamed pipeline (ops/edt.squared_edt_streamed) bounds
transients to one field + a slab. This script produces a 1024^3 two-field
SDF end-to-end on one card, renders a depth image from it (8-gather sample
path and the z-pair table), and prints the rates.

Run on a GPU: ``python benchmarks/large_grid.py [n ...]``.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from anywhere

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from voxelized_geometry_tools_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)
enable_compile_cache()

from voxelized_geometry_tools_tpu import GridSpec
from voxelized_geometry_tools_tpu.ops import edt, render


def _force(x):
    return jax.block_until_ready(x)


def sphere_mask(n):
    """Centered sphere of radius n/4, built on device."""
    r2 = (n / 4.0) ** 2
    ax = (jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0) ** 2
    return (ax[:, None, None] + ax[None, :, None]
            + ax[None, None, :]) <= r2


def run(n, streaming=True, slab=128, do_render=True):
    res = 0.01
    spec = GridSpec.from_voxel_counts(res, (n, n, n))
    out = {"n": n, "streaming": streaming}

    mask = sphere_mask(n)
    _force(mask)

    def build(m):
        return edt._sdf_values_from_mask(m, res, streaming=streaming)

    t0 = time.monotonic()
    values = build(mask)
    _force(values)
    out["edt_first_s"] = time.monotonic() - t0
    print(f"n={n}: EDT first call {out['edt_first_s']:.1f}s")

    # Free the first result before re-timing: at 1024^3 the 4 GiB output
    # plus a second build's ~8-9 GiB working set exceeds HBM.
    values.delete()
    t0 = time.monotonic()
    values = build(mask)
    _force(values)
    dt = time.monotonic() - t0
    out["edt_warm_s"] = dt
    out["edt_voxels_per_s"] = 2 * n ** 3 / dt  # two fields
    print(f"n={n} streamed={streaming}: EDT warm {dt:.2f}s "
          f"({2 * n ** 3 / dt / 1e6:.0f} M voxels/s incl. both fields)")

    # Sanity: center is deep inside (-r*res-ish), corner far outside.
    center = float(values[n // 2, n // 2, n // 2])
    corner = float(values[0, 0, 0])
    assert center < 0 < corner, (center, corner)
    out["sdf_center"] = center

    if do_render:
        from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
        from voxelized_geometry_tools_tpu.ops import sdf_query
        sdf = SignedDistanceField.create(spec, values, locked=True)
        size = n * res
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (size / 2, size / 2, -1.2 * size)
        cam = render.PinholeCamera.create(pose, 640, 480, focal=600.0)
        rays = 640 * 480

        # Two sample paths at large n: the raw 8-gather path (no extra
        # memory) and the z-pair table (2x grid memory, 4 gathers/sample —
        # an 8x corner BRICK table is 34 GiB at 1024^3 and cannot fit, but
        # grid + pair table is ~13 GiB and does).
        # The shipped schedule: head=0 block-tail with certificate
        # retirement + chunked cone tail.
        def render_raw(s):
            return render.render_depth(
                s, cam, num_steps=96, early_exit=True, coarse_factor=8,
                head_steps=0, tail_chunks=32, cone_steps=32,
                cone_tail_chunks=8).depth

        fn = jax.jit(render_raw)
        t0 = time.monotonic()
        depth = fn(sdf)
        _force(depth)
        out["render_first_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        depth = fn(sdf)
        _force(depth)
        dt = time.monotonic() - t0
        out["render_warm_s"] = dt
        out["render_rays_per_s"] = rays / dt
        print(f"n={n}: render (8-gather path) {dt * 1e3:.1f} ms "
              f"({rays / dt / 1e6:.2f} M rays/s)")
        depth.delete()

        pair = jax.jit(sdf_query.build_corner_pair_table)(sdf)
        _force(pair.rows)

        def render_pair(s, t):
            return render.render_depth(
                s, cam, num_steps=96, corner_table=t, early_exit=True,
                coarse_factor=8, head_steps=0, tail_chunks=32,
                cone_steps=32, cone_tail_chunks=8).depth

        pfn = jax.jit(render_pair)
        depth = pfn(sdf, pair)
        _force(depth)
        t0 = time.monotonic()
        depth = pfn(sdf, pair)
        _force(depth)
        dt = time.monotonic() - t0
        out["render_pair_warm_s"] = dt
        out["render_pair_rays_per_s"] = rays / dt
        print(f"n={n}: render (z-pair table) {dt * 1e3:.1f} ms "
              f"({rays / dt / 1e6:.2f} M rays/s)")
        pair.rows.delete()
    return out


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [768, 1024]
    results = []
    for n in sizes:
        results.append(run(n))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
