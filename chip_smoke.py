"""Smoke test of the fusion frame on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, on a
seeded synthetic workcell (a floor slab plus scattered spheres) in a 512^3
grid at 1 cm, seen by four 640x480 depth cameras from four sides:

1. carve + filter with the accelerator voxelizer, checked bit-exact against
   the voxel walk and counted against the native C++ reference;
2. the two-field EDT (``backend="auto"``), equal to the XLA min-plus and
   within 1e-5 of the native EDT;
3. the corner table and the shipped render schedule, held to the plain
   march's hit-superset and depth-band contract
   (``render.compare_with_plain_march``);
4. 131,072 planner queries (fast against raw 8-corner) and fine gradients
   (GPU against the same code on the host CPU);
5. three pose-fit steps, the pose gradient against central differences.

Each phase prints one line: set-up seconds (first call, compile included),
the median wall time of warm calls ending in ``block_until_ready``, the
device's peak bytes in use so far, and the comparison with its tolerance.
The last line is one JSON object naming the device.

Run from the repository root on a machine with a GPU::

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded path on four cards

It exits non-zero without a GPU, and whenever a comparison fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from voxelized_geometry_tools_tpu.utils.gpu import card_line, require_gpu
from voxelized_geometry_tools_tpu.utils.workcell import EXTENT_M, WorkcellScene

GRID_N = 512
IMG_W, IMG_H = 640, 480
NUM_STEPS = 64
# The render schedule bench.py ships.
FAST_RENDER = dict(early_exit=True, coarse_factor=8, head_steps=0,
                   tail_chunks=32, cone_steps=32, cone_tail_chunks=8)


# -- Phases ------------------------------------------------------------------


@dataclasses.dataclass
class PhaseResult:
    name: str
    setup_s: float
    median_s: float
    check: str
    ok: bool
    peak_bytes: Optional[int] = None

    def line(self) -> str:
        return (f"phase {self.name}: setup_s={self.setup_s:.3f} "
                f"median_s={self.median_s:.6f} peak_bytes_in_use="
                f"{self.peak_bytes} {'PASS' if self.ok else 'FAIL'} "
                f"{self.check}")


def _peak_bytes() -> Optional[int]:
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _timed(fn: Callable, iters: int):
    """``(first_call_s, median_s, result)``; every call ends in
    ``block_until_ready``."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times), out


@dataclasses.dataclass
class Frame:
    """What the phases hand on to each other."""
    scene: WorkcellScene
    spec: object
    env: object
    clouds: list
    cameras: list
    width: int
    height: int
    occupancy: object = None
    sdf: object = None
    table: object = None


def make_frame(n: int = GRID_N, seed: int = 0, width: int = IMG_W,
               height: int = IMG_H) -> Frame:
    from voxelized_geometry_tools_tpu import GridSpec, OccupancyMap
    from voxelized_geometry_tools_tpu.core.maps import UNKNOWN
    from voxelized_geometry_tools_tpu.ops import render, voxelize

    scene = WorkcellScene.make(n, seed)
    spec = GridSpec.from_voxel_counts(scene.resolution, (n, n, n))
    env = OccupancyMap.create(spec, None, "world", default_occupancy=UNKNOWN)
    focal = 520.0 * width / IMG_W
    poses = scene.camera_poses()
    clouds = [voxelize.PointCloud.create(
        scene.depth_points(p, width, height, focal), p) for p in poses]
    cameras = [render.PinholeCamera.create(p, width, height, focal=focal)
               for p in poses]
    return Frame(scene, spec, env, clouds, cameras, width, height)


def phase_carve(frame: Frame, iters: int = 5) -> PhaseResult:
    """Accelerator voxelizer; column carve vs voxel walk; fused occupancy
    vs the native C++ voxelizer."""
    import jax
    from voxelized_geometry_tools_tpu.ops import backends, voxelize

    options = voxelize.FilterOptions()
    vox = backends.make_pointcloud_voxelizer(
        backends.BackendOption.ACCELERATOR)
    setup, median, fused = _timed(
        lambda: vox.voxelize_pointclouds(frame.env, options,
                                         frame.clouds).occupancy, iters)
    frame.occupancy = fused

    spec, origin = frame.spec, frame.env.origin_transform
    walk = jax.jit(lambda c: voxelize.raycast_pointcloud(spec, origin, c))
    mismatched = []
    for i, cloud in enumerate(frame.clouds):
        axis = voxelize.pick_run_axis(cloud, origin)
        cols = jax.jit(lambda c, a=axis: voxelize.raycast_pointcloud_columns(
            spec, origin, c, run_axis=a))(cloud)
        ref = walk(cloud)
        for field in ("seen_free", "seen_filled"):
            if not bool((getattr(cols, field) == getattr(ref, field)).all()):
                mismatched.append(f"cloud{i}.{field}")
        del cols, ref

    native = backends.make_pointcloud_voxelizer(
        backends.BackendOption.NATIVE_CPU)
    native_occ = np.asarray(native.voxelize_pointclouds(
        frame.env, options, frame.clouds).occupancy)
    occ = np.asarray(fused)
    disagree = int((occ != native_occ).sum())
    observed = int((native_occ != 0.5).sum())
    # The native walk steps in float64 and the device walk in float32, so a
    # ray through a voxel corner can take the other staircase step
    # (tests/test_native_backends.py); ties are rare and local.
    limit = max(16, observed // 1000)
    ok = not mismatched and disagree <= limit
    check = (f"column==walk bit-exact for {len(frame.clouds)} clouds"
             f"{' (mismatch: ' + ','.join(mismatched) + ')' if mismatched else ''}; "
             f"native disagreeing voxels {disagree} of {observed} observed "
             f"(limit {limit})")
    return PhaseResult("carve_filter", setup, median, check, ok, _peak_bytes())


def phase_edt(frame: Frame, iters: int = 5) -> PhaseResult:
    """``extract_sdf_from_occupancy`` with ``backend="auto"`` vs ``"xla"``
    (exact) and vs the native EDT (1e-5)."""
    from voxelized_geometry_tools_tpu import native
    from voxelized_geometry_tools_tpu.ops import edt

    spec, origin = frame.spec, frame.env.origin_transform

    def run(backend):
        return edt.extract_sdf_from_occupancy(frame.occupancy, spec, origin,
                                              frame="world", backend=backend)

    setup, median, sdf = _timed(lambda: run("auto").distances, iters)
    frame.sdf = run("auto")
    exact = bool((run("xla").distances == frame.sdf.distances).all())
    filled = np.asarray(edt.filled_mask_from_occupancy(frame.occupancy))
    want = native.edt_sdf(filled, spec.resolution)
    got = np.asarray(frame.sdf.distances)
    same_inf = bool(np.array_equal(np.isinf(got), np.isinf(want)))
    fin = np.isfinite(want)
    err = float(np.max(np.abs(got[fin] - want[fin]), initial=0.0))
    ok = exact and same_inf and err <= 1e-5
    check = (f"auto==xla exact: {exact}; vs native max_abs_err {err:.3g} "
             f"(atol 1e-5), inf sites equal: {same_inf}")
    return PhaseResult("edt", setup, median, check, ok, _peak_bytes())


def render_check(plain, other, resolution: float) -> tuple:
    """``(ok, text)`` of :func:`render.compare_with_plain_march`."""
    from voxelized_geometry_tools_tpu.ops import render
    agreement = render.compare_with_plain_march(plain, other, resolution)
    return agreement.ok, agreement.describe()


def phase_render(frame: Frame, iters: int = 5) -> PhaseResult:
    """Corner table + shipped render schedule vs the plain march."""
    import jax
    from voxelized_geometry_tools_tpu.ops import render, sdf_query

    sdf, cam = frame.sdf, frame.cameras[0]
    build = jax.jit(sdf_query.build_corner_table)

    fast_fn = jax.jit(lambda s, t, c: render.render_depth(
        s, c, num_steps=NUM_STEPS, corner_table=t, **FAST_RENDER))
    plain_fn = jax.jit(lambda s, c: render.render_depth(
        s, c, num_steps=NUM_STEPS, early_exit=False, coarse_factor=0))
    frame.table = jax.block_until_ready(build(sdf))
    setup, median, fast = _timed(lambda: fast_fn(sdf, frame.table, cam),
                                 iters)
    _, build_s, _ = _timed(lambda: build(sdf).rows, iters)
    ok, check = render_check(plain_fn(sdf, cam), fast, sdf.resolution)
    return PhaseResult("corner_table_render", setup, median,
                       f"corner table build median_s {build_s:.6f}; {check}",
                       ok, _peak_bytes())


def planner_points(scene: WorkcellScene, seed: int,
                   trajectories: int = 64, waypoints: int = 64,
                   spheres: int = 32) -> np.ndarray:
    """``[trajectories, waypoints, spheres, 3]`` collision-sphere centres of
    straight-line arm trajectories through the workcell."""
    rng = np.random.default_rng(seed + 1)
    lo, hi = 0.1 * EXTENT_M, 0.9 * EXTENT_M
    start = rng.uniform(lo, hi, (trajectories, 1, 1, 3))
    end = rng.uniform(lo, hi, (trajectories, 1, 1, 3))
    s = np.linspace(0.0, 1.0, waypoints)[None, :, None, None]
    offsets = rng.normal(size=(1, 1, spheres, 3))
    offsets *= 0.3 * rng.uniform(size=(1, 1, spheres, 1)) / np.linalg.norm(
        offsets, axis=-1, keepdims=True)
    return (start + s * (end - start) + offsets).astype(np.float32)


def phase_queries(frame: Frame, seed: int = 0,
                  iters: int = 5, **point_kw) -> PhaseResult:
    """Fast (one corner-row gather) vs raw 8-corner distance queries on
    the device, and fine gradients on the device vs on the host CPU."""
    import jax
    from voxelized_geometry_tools_tpu.ops import sdf_query

    sdf, table = frame.sdf, frame.table
    pts = jax.device_put(planner_points(frame.scene, seed, **point_kw))
    fast_fn = jax.jit(sdf_query.estimate_location_distance_fast)
    raw_fn = jax.jit(sdf_query.estimate_location_distance)
    window = float(sdf.resolution)
    grad_fn = jax.jit(lambda s, p: sdf_query.get_location_fine_gradient(
        s, p, window))
    setup, median, fast = _timed(lambda: fast_fn(sdf, table, pts), iters)
    _, grad_s, grad = _timed(lambda: grad_fn(sdf, pts), iters)
    raw = raw_fn(sdf, pts)
    valid = np.asarray(raw.valid)
    same_valid = bool(np.array_equal(valid, np.asarray(fast.valid)))
    # Same trilinear interpolation up to float reassociation: a few ulp of
    # values up to ~5 m (ulp 4.8e-7), so 1e-5 m is a tenth of a
    # hundredth of a voxel.
    d_err = float(np.max(np.abs(np.asarray(fast.value)[valid]
                                - np.asarray(raw.value)[valid]), initial=0.0))
    cpu = jax.devices("cpu")[0]
    # A host executable from the persistent cache may come from a host
    # with other CPU features, so the host reference compiles afresh.
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        grad_cpu = jax.block_until_ready(grad_fn(
            jax.device_put(sdf, cpu), jax.device_put(pts, cpu)))
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)
    gvalid = np.asarray(grad.valid)
    same_gvalid = bool(np.array_equal(gvalid, np.asarray(grad_cpu.valid)))
    # Differences of two trilinear values over a 1-voxel window: 1e-5 m of
    # value noise becomes 1e-3 of gradient.
    g_err = float(np.max(np.abs(np.asarray(grad.gradient)[gvalid]
                                - np.asarray(grad_cpu.gradient)[gvalid]),
                         initial=0.0))
    ok = same_valid and same_gvalid and d_err <= 1e-5 and g_err <= 1e-3
    check = (f"{valid.size} points, {int(valid.sum())} valid; fast vs raw "
             f"max_abs_err {d_err:.3g} (atol 1e-5), valid masks equal "
             f"{same_valid}; fine gradient median_s {grad_s:.6f}, device vs "
             f"host max_abs_err {g_err:.3g} (atol 1e-3), valid masks equal "
             f"{same_gvalid}")
    return PhaseResult("planner_queries", setup, median, check, ok,
                       _peak_bytes())


def phase_pose(frame: Frame, iters: int = 5, num_fit_steps: int = 3,
               eps: float = 1e-2) -> PhaseResult:
    """``fit_camera_pose`` from a perturbed pose of the inspection camera;
    the loss is finite and falls, and the pose gradient agrees with
    central differences."""
    import jax
    import jax.numpy as jnp
    from voxelized_geometry_tools_tpu.models import fusion_pipeline as fp
    from voxelized_geometry_tools_tpu.ops import render

    sdf = frame.sdf
    true_cam = render.PinholeCamera.create(
        frame.scene.inspection_pose(), frame.width, frame.height,
        focal=520.0 * frame.width / IMG_W)
    steps = 48
    target = jax.jit(lambda s, c: render.render_depth(
        s, c, num_steps=steps).depth)(sdf, true_cam)
    start = jnp.asarray([0.02, -0.015, 0.01, 0.0, 0.0, 0.03], jnp.float32)
    base_cam = dataclasses.replace(
        true_cam, pose=fp.perturb_pose(true_cam.pose, start))

    t0 = time.perf_counter()
    fit = fp.fit_camera_pose(sdf, base_cam, target, num_iters=num_fit_steps,
                             num_steps=steps)
    losses = np.asarray(jax.block_until_ready(fit.losses))
    setup = time.perf_counter() - t0

    def loss(tangent, s):
        cam = dataclasses.replace(
            base_cam, pose=fp.perturb_pose(base_cam.pose, tangent))
        return fp.depth_loss(s, cam, target, num_steps=steps)

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    loss_fn = jax.jit(loss)
    zero = jnp.zeros(6, jnp.float32)
    _, median, (_, g) = _timed(lambda: value_and_grad(zero, sdf), iters)
    g = np.asarray(g, np.float64)
    gnorm = float(np.linalg.norm(g))
    rng = np.random.default_rng(7)
    dirs = [g / max(gnorm, 1e-30)] + [
        v / np.linalg.norm(v) for v in rng.normal(size=(2, 6))]
    fd_err = 0.0
    for v in dirs:
        vj = jnp.asarray(v, jnp.float32)
        fd = (float(loss_fn(eps * vj, sdf))
              - float(loss_fn(-eps * vj, sdf))) / (2.0 * eps)
        fd_err = max(fd_err, abs(fd - float(g @ v)))
    # Set from readings on an H100 at 512^3 (this start, seed 0): sound
    # gradients read 0.28% of |g| at eps 3e-3 and 0.46% at eps 1e-2 (the
    # march's stopping rule puts sub-millimetre kinks in the loss; at eps
    # 3e-2 they read 17%). A gradient scaled by 0.95 reads 4.5%, one that
    # drops its translation or rotation terms 18% or 92%. 1.5% sits about
    # three times above the sound reading and three times below the
    # smallest degraded one.
    tol = 0.015 * gnorm
    falls = bool(np.all(np.isfinite(losses)) and losses[-1] < losses[0])
    ok = falls and gnorm > 0.0 and fd_err <= tol
    check = (f"losses {np.array2string(losses, precision=6)} finite and "
             f"falling: {falls}; |grad| {gnorm:.4g}, central difference "
             f"(eps {eps}) max_abs_err {fd_err:.3g} over 3 directions "
             f"(tol 0.015*|grad| = {tol:.3g}); median_s is one loss+grad "
             f"step")
    return PhaseResult("pose_gradient", setup, median, check, ok,
                       _peak_bytes())


# -- Four cards --------------------------------------------------------------


def phase_four_cards(frame: Frame, iters: int = 5) -> List[PhaseResult]:
    """The sharded path on a mesh over every device, each result compared
    with the same computation on device 0."""
    import jax
    from voxelized_geometry_tools_tpu.ops import backends, edt, render, voxelize
    from voxelized_geometry_tools_tpu.parallel import mesh_utils, sharded

    mesh = mesh_utils.make_mesh(("z",))
    n_dev = mesh.shape["z"]
    spec, env = frame.spec, frame.env
    options = voxelize.FilterOptions()
    results = []

    carve = jax.jit(lambda cs: sharded.sharded_voxelize_pointclouds(
        env, options, cs, mesh).occupancy)
    setup, median, occ = _timed(lambda: carve(frame.clouds), iters)
    single = backends.make_pointcloud_voxelizer(
        backends.BackendOption.ACCELERATOR).voxelize_pointclouds(
            env, options, frame.clouds).occupancy
    same = bool(np.array_equal(np.asarray(occ), np.asarray(single)))
    results.append(PhaseResult(
        f"sharded_carve_{n_dev}cards", setup, median,
        f"bit-identical to device 0: {same}", same, _peak_bytes()))

    sdf_fn = jax.jit(lambda o: sharded.sharded_extract_sdf(
        o, spec, env.origin_transform, mesh, frame="world").distances)
    setup, median, dist = _timed(lambda: sdf_fn(occ), iters)
    ref = edt.extract_sdf_from_occupancy(single, spec, env.origin_transform,
                                         frame="world")
    same = bool(np.array_equal(np.asarray(dist), np.asarray(ref.distances)))
    results.append(PhaseResult(
        f"sharded_edt_{n_dev}cards", setup, median,
        f"bit-identical to device 0: {same}", same, _peak_bytes()))

    sdf = ref.replace(distances=dist)
    cam = frame.cameras[0]
    plain = jax.jit(lambda s, c: render.render_depth(
        s, c, num_steps=NUM_STEPS, early_exit=False, coarse_factor=0))(
            ref, cam)

    def pixel_sharded(s, c):
        return sharded.sharded_render_depth(
            s, c, mesh, num_steps=NUM_STEPS, with_distance=True)

    def grid_sharded(s, c):
        rows = sharded.sharded_build_corner_table(s, mesh, grid_axis=0)
        return sharded.sharded_render_depth_grid_sharded(
            s, c, mesh, num_steps=NUM_STEPS, grid_axis=0, corner_rows=rows,
            with_distance=True)

    for name, fn in (("sharded_render", pixel_sharded),
                     ("sharded_render_grid_sharded", grid_sharded)):
        setup, median, (depth, distance) = _timed(
            lambda f=jax.jit(fn): f(sdf, cam), iters)
        res = render.RenderResult(depth, depth < 99.0, None, distance)
        ok, check = render_check(plain, res, spec.resolution)
        results.append(PhaseResult(f"{name}_{n_dev}cards", setup, median,
                                   check, ok, _peak_bytes()))
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded path on a 4-card mesh")
    args = parser.parse_args(argv)

    print(card_line(), flush=True)
    require_gpu("chip_smoke.py")
    import jax
    from voxelized_geometry_tools_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    devices = jax.devices()
    if args.four_cards and len(devices) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")

    t0 = time.perf_counter()
    frame = make_frame(GRID_N, args.seed)
    print(f"scene: {GRID_N}^3 at {frame.scene.resolution} m, "
          f"{len(frame.clouds)} clouds of "
          f"{[int(c.points.shape[0]) for c in frame.clouds]} points, "
          f"made in {time.perf_counter() - t0:.2f} s", flush=True)

    results = []
    if args.four_cards:
        results = phase_four_cards(frame)
        for r in results:
            print(r.line(), flush=True)
    else:
        for phase in (phase_carve, phase_edt, phase_render, phase_queries,
                      phase_pose):
            r = phase(frame)
            print(r.line(), flush=True)
            results.append(r)
    if not all(r.ok for r in results):
        print("FAILED: " + ", ".join(r.name for r in results if not r.ok),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
