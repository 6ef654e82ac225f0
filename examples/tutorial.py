"""Tutorial: occupancy map -> connected components -> SDF -> queries.

Accelerator-native analogue of the reference's example/tutorial.cpp:22-278: builds a
10 m^3 quarter-filled OccupancyComponentMap centered at the origin, computes
connected components, extracts a signed distance field, and runs
index/location distance and gradient queries — printing the same kinds of
values and timings the reference prints. Display output goes to a
VoxelMarker summary instead of an RViz publisher.
"""

# Allow running as `python examples/<name>.py` from a source checkout
# without installing the package.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time

import numpy as np
import jax.numpy as jnp

import voxelized_geometry_tools_tpu as vgt
from voxelized_geometry_tools_tpu.ops import map_ops, sdf_query
from voxelized_geometry_tools_tpu.io import viz


def main():
    resolution = 0.25
    spec = vgt.GridSpec.from_grid_sizes(resolution, (10.0, 10.0, 10.0))
    origin = np.eye(4, dtype=np.float32)
    origin[:3, 3] = (-5.0, -5.0, -5.0)  # center the grid around the origin
    omap = vgt.OccupancyComponentMap.create(spec, origin, "tutorial_frame")

    # Fill the bottom corner (low x, low y, low z) as an obstacle
    # (tutorial.cpp:92-108) — as an array op instead of a triple loop.
    occ = np.zeros(spec.counts, np.float32)
    nx, ny, nz = spec.counts
    occ[: nx // 2, : ny // 2, : nz // 2] = 1.0
    omap = omap.set_occupancy(jnp.asarray(occ))

    # Query by index and by location (tutorial.cpp:112-144).
    idx_val = float(omap.occupancy[10, 10, 10])
    print(f"Index query result - stored value {idx_val} (occupancy)")
    loc_index = np.asarray(
        omap.location_to_grid_index(jnp.asarray([0.0, 0.0, 0.0])))
    loc_val = float(omap.occupancy[tuple(loc_index)])
    print(f"Location query result - stored value {loc_val} (occupancy)")

    # Connected components (tutorial.cpp:146-154).
    t0 = time.monotonic()
    omap = map_ops.update_connected_components(omap)
    n_components = int(omap.number_of_components)
    print(f"Connected components took {time.monotonic() - t0:.4f} seconds")
    print(f"There are {n_components} connected components")

    # Display exports (tutorial.cpp:157-211) — marker payload summaries.
    occ_marker = viz.export_occupancy_for_display(omap)
    cc_marker = viz.export_connected_components_for_display(omap)
    print(f"Occupancy display: {occ_marker.num_cells} cells; "
          f"components display: {cc_marker.num_cells} cells")

    # SDF generation (tutorial.cpp:213-224).
    t0 = time.monotonic()
    sdf = map_ops.extract_signed_distance_field(omap)
    mn, mx = sdf.get_minimum_maximum()
    print(f"SDF generation took {time.monotonic() - t0:.4f} seconds")
    print(f"Maximum distance in the SDF: {float(mx):.6f}")
    print(f"Minimum distance in the SDF: {float(mn):.6f}")

    # Distance + gradient queries (tutorial.cpp:226-262).
    q_index = sdf_query.estimate_index_distance(
        sdf, jnp.asarray([10, 10, 10]))
    print(f"Index query result - estimated distance {float(q_index.value):.6f}"
          f" (valid: {bool(q_index.valid)})")
    q_loc = sdf_query.estimate_location_distance(
        sdf, jnp.asarray([0.0, 0.0, 0.0]))
    print(f"Location query result - estimated distance "
          f"{float(q_loc.value):.6f} (valid: {bool(q_loc.valid)})")
    g_index = sdf_query.get_index_coarse_gradient(
        sdf, jnp.asarray([10, 10, 10]), enable_edge_gradients=True)
    print(f"Index gradient query result - gradient "
          f"{np.asarray(g_index.gradient)}")
    g_loc = sdf_query.get_location_coarse_gradient(
        sdf, jnp.asarray([0.0, 0.0, 0.0]), enable_edge_gradients=True)
    print(f"Location gradient query result - gradient "
          f"{np.asarray(g_loc.gradient)}")
    print("...done")


if __name__ == "__main__":
    main()
