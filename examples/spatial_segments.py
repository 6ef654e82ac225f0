"""Spatial segmentation example: tagged map -> SDF watershed -> segments.

Accelerator-native analogue of the reference's example/spatial_segments.cpp:39-310:
a 100x100x50 tagged-object map with border walls (object 1) and a center
block (object 2) split by empty cross-channels, segmented with
`update_spatial_segments` at connected_threshold=1.75 both without and with
a virtual border, then per-(object, segment) display exports.

Note: the reference's grid is 100x100x50 at res 1.0; this example defaults to
a 50x50x25 version of the same scene (same structure, quarter the voxels) so
it runs quickly on CPU too — pass --full for the reference size.
"""

# Allow running as `python examples/<name>.py` from a source checkout
# without installing the package.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import jax.numpy as jnp

import voxelized_geometry_tools_tpu as vgt
from voxelized_geometry_tools_tpu.ops import map_ops
from voxelized_geometry_tools_tpu.io import viz


def build_scene(nx: int, ny: int, nz: int):
    spec = vgt.GridSpec.from_voxel_counts(1.0, (nx, ny, nz))
    tocmap = vgt.TaggedObjectOccupancyComponentMap.create(
        spec, None, "world")
    wall = max(1, nx // 10)
    occ = np.zeros(spec.counts, np.float32)
    obj = np.zeros(spec.counts, np.uint32)
    xs, ys, _ = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                            indexing="ij")
    border = (xs < wall) | (ys < wall) | (xs >= nx - wall) | (ys >= ny - wall)
    occ[border] = 1.0
    obj[border] = 1
    block = ((xs >= int(0.4 * nx)) & (xs < int(0.6 * nx))
             & (ys >= int(0.4 * ny)) & (ys < int(0.6 * ny)))
    occ[block & ~border] = 1.0
    obj[block & ~border] = 2
    channel = (((xs >= int(0.45 * nx)) & (xs < int(0.55 * nx)))
               | ((ys >= int(0.45 * ny)) & (ys < int(0.55 * ny))))
    occ[channel] = 0.0
    obj[channel] = 0
    return tocmap.replace(occupancy=jnp.asarray(occ),
                          object_id=jnp.asarray(obj))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--full", action="store_true",
                        help="reference-size 100x100x50 grid")
    args = parser.parse_args()
    nx, ny, nz = (100, 100, 50) if args.full else (50, 50, 25)

    tocmap = build_scene(nx, ny, nz)
    env_marker = viz.export_occupancy_for_display(tocmap)
    print(f"Environment display: {env_marker.num_cells} cells")

    connected_threshold = 1.75

    for add_virtual_border in (False, True):
        t0 = time.monotonic()
        tocmap = map_ops.update_spatial_segments(
            tocmap.replace(spatial_segments_valid=False),
            connected_threshold, add_virtual_border=add_virtual_border)
        n_segments = tocmap.number_of_spatial_segments
        label = ("virtual border" if add_virtual_border else "manual border")
        print(f"Spatial segments ({label}): {int(n_segments)} segments in "
              f"{time.monotonic() - t0:.3f}s")
        seg_marker = viz.export_spatial_segments_for_display(tocmap)
        print(f"  segment display: {seg_marker.num_cells} cells")

        # Per-(object, segment) cell counts, mirroring the reference's
        # per-segment ExportSpatialSegmentForDisplay loop (cpp:122-133).
        seg = np.asarray(tocmap.spatial_segment)
        obj = np.asarray(tocmap.object_id)
        for object_id in range(0, 3):
            for segment in range(1, int(n_segments) + 1):
                count = int(((obj == object_id) & (seg == segment)).sum())
                if count:
                    print(f"  object {object_id} segment {segment}: "
                          f"{count} voxels")
    print("...done")


if __name__ == "__main__":
    main()
