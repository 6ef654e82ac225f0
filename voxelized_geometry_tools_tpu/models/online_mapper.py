"""Incremental online mapping: stream depth frames into a live map + SDF.

The reference library's primary production use is exactly this loop — each
sensor frame is carved into the current occupancy map
(`VoxelizePointClouds` with the running map as the static environment,
pointcloud_voxelization_interface.hpp:246-292), and consumers query the
refreshed SDF. This model packages that loop natively for the accelerator:

* the occupancy state lives on device between frames (no host round trips),
* the per-frame integrate step is jit-compiled once per cloud shape and
  replayed (like the reference's prebuilt device kernels),
* a whole recorded sequence can be folded in ONE compiled program with
  ``lax.scan`` (``integrate_frames``) — the sequential filled-latching fuse
  is the scan carry,
* the SDF is recomputed lazily and cached until the next integration,
* ``localize`` closes the loop with render-based pose fitting against the
  live SDF (gradients through the differentiable renderer).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from ..core.grid import GridSpec
from ..core.maps import OccupancyMap, SignedDistanceField
from ..ops import edt, render, voxelize

Array = jnp.ndarray


class OnlineMapper:
    """Streaming occupancy mapper with a lazily-refreshed SDF."""

    def __init__(self, spec: GridSpec, origin_transform=None,
                 frame: str = "world",
                 filter_options: voxelize.FilterOptions =
                 voxelize.FilterOptions(),
                 max_steps: Optional[int] = None,
                 carve_run_axis: Optional[int] = None):
        """``carve_run_axis``: grid axis for the column-marching carve
        (ops/voxelize.raycast_pointcloud_columns — bit-exact, ~4x); by
        default it is picked from the FIRST integrated cloud's dominant ray
        direction (a mapper's camera orientation is stable across frames).
        Pass ``-1`` to force the plain voxel walk."""
        filter_options.validate()
        self._map = OccupancyMap.create(spec, origin_transform, frame)
        self._options = filter_options
        self._max_steps = max_steps
        self._run_axis = carve_run_axis
        self._sdf_cache = {}
        self._frames_integrated = 0

        # jax.jit's own aval-keyed cache handles per-shape (and per-scan-
        # length) specialization; one jitted callable per code path suffices.
        def integrate_one(occupancy, origin_transform, cloud):
            if self._run_axis is None or self._run_axis < 0:
                grid = voxelize.raycast_pointcloud(
                    spec, origin_transform, cloud, self._max_steps)
            else:
                grid = voxelize.raycast_pointcloud_columns(
                    spec, origin_transform, cloud, self._max_steps,
                    run_axis=self._run_axis)
            return voxelize.combine_and_filter(
                self._options, grid.seen_free[None],
                grid.seen_filled[None], occupancy)

        def integrate_seq(occupancy, origin_transform, frames):
            def step(occ, frame):
                return integrate_one(occ, origin_transform, frame), None

            occ, _ = lax.scan(step, occupancy, frames)
            return occ

        self._integrate_one = jax.jit(integrate_one)
        self._integrate_seq = jax.jit(integrate_seq)

    # -- state ------------------------------------------------------------

    @property
    def occupancy_map(self) -> OccupancyMap:
        return self._map

    @property
    def frames_integrated(self) -> int:
        return self._frames_integrated

    # -- integration --------------------------------------------------------

    def _resolve_run_axis(self, cloud: voxelize.PointCloud):
        # Auto-pick the column-carve axis from the first frame, BEFORE the
        # first jit trace bakes it in (attr reads are trace-time constants).
        if self._run_axis is None:
            self._run_axis = voxelize.dominant_ray_axis(
                cloud, self._map.origin_transform)

    def integrate(self, cloud: voxelize.PointCloud) -> OccupancyMap:
        """Carve one depth frame into the running map (filled cells latch,
        per the ``CountsSeenAs`` fuse over the current occupancy)."""
        self._resolve_run_axis(cloud)
        occ = self._integrate_one(self._map.occupancy,
                                  self._map.origin_transform, cloud)
        self._map = self._map.replace(occupancy=occ)
        self._sdf_cache.clear()
        self._frames_integrated += 1
        return self._map

    def integrate_frames(self, clouds: Sequence[voxelize.PointCloud]
                         ) -> OccupancyMap:
        """Fold a recorded sequence in one compiled program: ``lax.scan``
        over stacked frames with the fused occupancy as the carry. All
        clouds must share a point count (depth cameras do)."""
        if not clouds:
            return self._map
        shapes = {tuple(c.points.shape) for c in clouds}
        if len(shapes) != 1:
            raise ValueError(
                f"integrate_frames needs uniform cloud shapes, got {shapes}")
        stacked = voxelize.PointCloud(
            points=jnp.stack([c.points for c in clouds]),
            origin_transform=jnp.stack(
                [c.origin_transform for c in clouds]),
            max_range=jnp.stack([jnp.asarray(c.max_range, jnp.float32)
                                 for c in clouds]))

        self._resolve_run_axis(clouds[0])
        occ = self._integrate_seq(self._map.occupancy,
                                  self._map.origin_transform, stacked)
        self._map = self._map.replace(occupancy=occ)
        self._sdf_cache.clear()
        self._frames_integrated += len(clouds)
        return self._map

    # -- derived products ----------------------------------------------------

    def sdf(self, unknown_is_filled: bool = True,
            add_virtual_border: bool = False) -> SignedDistanceField:
        """Current SDF; cached until the next integration."""
        key = (unknown_is_filled, add_virtual_border)
        cached = self._sdf_cache.get(key)
        if cached is None:
            cached = edt.extract_sdf_from_occupancy(
                self._map.occupancy, self._map.spec,
                self._map.origin_transform, frame=self._map.frame,
                unknown_is_filled=unknown_is_filled,
                add_virtual_border=add_virtual_border)
            self._sdf_cache[key] = cached
        return cached

    def render_depth(self, camera: render.PinholeCamera,
                     **kwargs) -> render.RenderResult:
        """Render the live map's SDF from a camera."""
        return render.render_depth(self.sdf(), camera, **kwargs)

    def extract_mesh(self, level: float = 0.0,
                     max_triangles: int = 1 << 18, frame: str = "world"):
        """Extract the live map's surface as a triangle mesh
        (:func:`..ops.isosurface.extract_isosurface` on the cached SDF) —
        the meshed-output stage of the online-mapping loop."""
        from ..ops import isosurface
        return isosurface.extract_isosurface(
            self.sdf(), level=level, max_triangles=max_triangles,
            frame=frame)

    def localize(self, camera_guess: render.PinholeCamera,
                 target_depth: Array, num_iters: int = 50,
                 learning_rate: float = 0.01, **render_kwargs):
        """Refine a camera pose against an observed depth image by
        render-and-compare on the live SDF (gradient descent through the
        differentiable renderer)."""
        from .fusion_pipeline import fit_camera_pose
        return fit_camera_pose(self.sdf(), camera_guess, target_depth,
                               num_iters=num_iters,
                               learning_rate=learning_rate, **render_kwargs)
