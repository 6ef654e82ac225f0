"""Voxel raycasting example: random DDA rays + count invariants.

Accelerator-native analogue of the reference's example/voxel_raycasting.cpp:55-323:
random origin/target pairs raycast through a 40^3 grid at 0.125 m resolution
with max_range 10, checking the DDA invariants (each voxel counted at most
once free, at most once filled, never both) and exporting a colored marker
of the traversed voxels. All iterations run as ONE batched raycast instead
of the reference's per-iteration loop.
"""

# Allow running as `python examples/<name>.py` from a source checkout
# without installing the package.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import jax.numpy as jnp

import voxelized_geometry_tools_tpu as vgt
from voxelized_geometry_tools_tpu.ops import voxelize
from voxelized_geometry_tools_tpu.io import viz


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=100)
    args = parser.parse_args()

    resolution = 0.125
    spec = vgt.GridSpec.from_voxel_counts(resolution, (40, 40, 40))
    origin_transform = jnp.eye(4, dtype=jnp.float32)
    max_range = 10.0
    rng = np.random.default_rng(42)

    warned = 0
    total_free = 0
    total_filled = 0
    last_marker = None
    for it in range(args.iterations):
        origin, point = rng.uniform(-2.0, 7.0, size=(2, 3))
        free, filled = voxelize.raycast_single_point(
            spec, origin_transform, jnp.asarray(origin, jnp.float32),
            jnp.asarray(point, jnp.float32), max_range)
        free = np.asarray(free)
        filled = np.asarray(filled)
        # Count invariants (voxel_raycasting.cpp:93-107 warnings).
        if (free > 1).any() or (filled > 1).any() or \
                ((free > 0) & (filled > 0)).any():
            warned += 1
            print(f"WARNING: iteration {it} violated raycast invariants")
        total_free += int(free.sum())
        total_filled += int(filled.sum())

        def color(f, fl):
            rgba = np.zeros(f.shape + (4,), np.float32)
            rgba[(f > 0)] = (0.0, 0.0, 1.0, 0.5)
            rgba[(fl > 0)] = (1.0, 0.0, 0.0, 0.5)
            rgba[(f > 0) & (fl > 0)] = (1.0, 0.0, 1.0, 0.5)
            return rgba

        last_marker = viz.export_voxel_grid(
            spec, origin_transform, "world", color, free, filled)

    print(f"{args.iterations} raycast cycles: {total_free} voxels seen free, "
          f"{total_filled} seen filled, {warned} invariant warnings")
    if last_marker is not None:
        print(f"Last-ray display: {last_marker.num_cells} cells")
    print("...done")


if __name__ == "__main__":
    main()
