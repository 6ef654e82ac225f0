"""Isosurface extraction rate (ops/isosurface.py) on device.

Measures marching-tetrahedra level-set extraction end-to-end (slab sweep +
scatter append) on sphere scenes at several grid sizes, reporting voxels/s
and triangles/s, plus the host-side weld cost. Run on a GPU:
``python benchmarks/isosurface_rate.py [n ...]`` (``JAX_PLATFORMS=cpu``
smoke-tests it on the CPU backend).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from anywhere

import json
import os
import sys
import time

import jax

from voxelized_geometry_tools_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)
enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from voxelized_geometry_tools_tpu import GridSpec
from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
from voxelized_geometry_tools_tpu.ops import isosurface


def _force(x):
    return jax.block_until_ready(x)


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [128, 256, 384]
    res = 0.01
    out = {}
    for n in sizes:
        spec = GridSpec.from_voxel_counts(res, (n, n, n))
        ax = (jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0)
        r = jnp.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                     + ax[None, None, :] ** 2)
        sdf = SignedDistanceField.create(spec, (r - n / 4.0) * res,
                                         locked=True)
        # Sphere surface ~= pi * (n/2)^2 cells, ~4 tris each.
        cap = 1 << max(18, int(np.ceil(np.log2(4 * np.pi * (n / 2) ** 2))))
        fn = jax.jit(lambda d, s=sdf, c=cap: isosurface.extract_isosurface(
            s.replace(distances=d), max_triangles=c))
        m = fn(sdf.distances)
        _force(m.num_triangles)
        t0 = time.monotonic()
        iters = 5
        for _ in range(iters):
            m = fn(sdf.distances)
        _force(m.num_triangles)
        dt = (time.monotonic() - t0) / iters
        ntri = int(m.num_triangles)
        assert ntri <= cap, "capacity overflow — raise cap"
        t0 = time.monotonic()
        verts, faces = isosurface.weld_vertices(m)
        weld_s = time.monotonic() - t0
        out[n] = {"extract_s": dt, "mvoxels_per_s": n ** 3 / dt / 1e6,
                  "triangles": ntri, "mtris_per_s": ntri / dt / 1e6,
                  "weld_s": weld_s, "welded_verts": len(verts)}
        print(f"n={n}: extract {dt*1e3:.1f} ms ({n**3/dt/1e6:.0f} M "
              f"voxels/s, {ntri} tris -> {ntri/dt/1e6:.2f} M tris/s), "
              f"weld {weld_s*1e3:.0f} ms -> {len(verts)} verts", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
