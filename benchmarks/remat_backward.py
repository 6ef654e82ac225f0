"""Remat benchmark: backward-pass cost of the differentiable march.

Reverse-mode over the ``sphere_trace`` scan path stores every step's
activations (gathered corner rows + trilinear weights + positions —
roughly 50-60 B/ray/step after XLA DCE); at 640x480x64 that is ~1 GB of
HBM traffic written forward and read back in the backward sweep.
``remat=True`` wraps the step in ``jax.checkpoint``: the backward pass
recomputes each step's single gather instead of loading activations.

This measures value+grad wall time for both paths at the bench scene
(512^3 SDF, 640x480, 64 steps, voxel gradients through a table rebuilt
inside the loss) and prints one JSON line. Run on a GPU.
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
from voxelized_geometry_tools_tpu.ops import edt, render, sdf_query


def _force(x):
    return jax.block_until_ready(x)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    width = int(sys.argv[2]) if len(sys.argv) > 2 else 640
    height = int(sys.argv[3]) if len(sys.argv) > 3 else 480
    res = 0.01
    spec = GridSpec.from_voxel_counts(res, (n, n, n))
    ax = (jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0) ** 2
    mask = (ax[:, None, None] + ax[None, :, None]
            + ax[None, None, :]) <= (n / 4.0) ** 2
    values = edt._sdf_values_from_mask(mask, res)
    sdf = SignedDistanceField.create(spec, values, locked=True)

    size = n * res
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (size / 2, size / 2, -1.2 * size)
    cam = render.PinholeCamera.create(pose, width, height,
                                      focal=520.0 * width / 640.0)

    results = {}
    for steps in (24, 64):
        for rm in (False, True):
            def loss(dists):
                s = sdf.replace(distances=dists)
                t = sdf_query.build_corner_table(s)
                r = render.render_depth(s, cam, num_steps=steps,
                                        corner_table=t, remat=rm)
                return jnp.nansum(jnp.where(r.hit, r.depth, 0.0))

            fn = jax.jit(jax.value_and_grad(loss))
            try:
                v, g = fn(sdf.distances)
                _force(g)
            except Exception as e:  # RESOURCE_EXHAUSTED is a result here
                results[f"steps{steps}_remat{rm}"] = {
                    "error": type(e).__name__}
                print(f"steps={steps} remat={rm}: {type(e).__name__}",
                      flush=True)
                continue
            t0 = time.monotonic()
            for _ in range(3):
                v, g = fn(sdf.distances)
            _force(g)
            dt = (time.monotonic() - t0) / 3
            nz = None  # counting nonzeros would pull 512MB D2H; skip
            results[f"steps{steps}_remat{rm}"] = {
                "value_and_grad_s": dt, "loss": float(v)}
            print(f"steps={steps} remat={rm}: {dt*1e3:.1f} ms "
                  f"(loss {float(v):.1f})", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
