"""Isosurface export: occupancy -> SDF -> triangle mesh -> OBJ file.

An accelerator-native addition with no reference analogue (the reference displays
voxel CUBE_LIST markers only; /root/reference/include/voxelized_geometry_tools/
ros_interface.hpp:92-148): extract the zero level set of a signed distance
field as a watertight triangle mesh (marching tetrahedra, ops/isosurface.py),
pack it as a TRIANGLE_LIST display marker, weld it into an indexed mesh, and
write a Wavefront OBJ any mesh tool can open. Also demonstrates the round
trip back through the mesh rasterizer (ops/mesh.py).
"""

# Allow running as `python examples/<name>.py` from a source checkout
# without installing the package.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import sys
import tempfile

import numpy as np
import jax
import jax.numpy as jnp

import voxelized_geometry_tools_tpu as vgt
from voxelized_geometry_tools_tpu.ops import edt, isosurface, mesh
from voxelized_geometry_tools_tpu.io import viz


def main():
    # A 5 m^3 grid with a 2 m box and a sphere poking out of its top.
    resolution = 0.125
    spec = vgt.GridSpec.from_grid_sizes(resolution, (5.0, 5.0, 5.0))
    omap = vgt.OccupancyMap.create(spec, frame="world")
    occ = np.zeros(spec.counts, np.float32)
    occ[8:24, 8:24, 8:24] = 1.0
    ii = np.arange(spec.num_x)
    r2 = ((ii[:, None, None] - 16) ** 2 + (ii[None, :, None] - 16) ** 2
          + (ii[None, None, :] - 28) ** 2)
    occ[r2 <= 64] = 1.0
    omap = omap.replace(occupancy=jnp.asarray(occ))

    sdf = edt.extract_sdf_from_occupancy(
        omap.occupancy, spec, omap.origin_transform, frame="world")

    # Extract the zero level set (jit-compatible; capacity is static).
    m = jax.jit(lambda s: isosurface.extract_isosurface(
        s, max_triangles=1 << 15))(sdf)
    print(f"extracted {int(m.num_triangles)} triangles "
          f"(overflowed={bool(m.overflowed)})")

    # Display marker (the TRIANGLE_LIST analogue of the CUBE_LIST export).
    marker = viz.export_isosurface_for_display(m, "world")
    print(f"TRIANGLE_LIST marker: {marker.num_triangles} triangles, "
          f"{marker.points.shape[0]} points")

    # Welded OBJ export.
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        tempfile.gettempdir(), "vgt_isosurface.obj")
    n_faces = isosurface.save_obj(out, m)
    verts, faces = isosurface.weld_vertices(m)
    print(f"wrote {out}: {len(verts)} vertices, {n_faces} faces")

    # Round trip: rasterizing the mesh back marks the SDF's surface shell.
    omap2 = vgt.OccupancyMap.create(spec, frame="world")
    back = mesh.rasterize_mesh(
        omap2, marker.points,
        np.arange(marker.points.shape[0]).reshape(-1, 3))
    marked = np.asarray(back.occupancy) > 0.5
    d = np.asarray(sdf.distances)
    # Voxelized-EDT boundary cells sit at exactly +-1 voxel of distance.
    near = np.abs(d) <= 1.0 * resolution
    assert near.any()
    print(f"round trip: {int(marked.sum())} voxels marked; surface-shell "
          f"coverage {float(marked[near].mean()):.3f} over {int(near.sum())}"
          " shell voxels")


if __name__ == "__main__":
    main()
