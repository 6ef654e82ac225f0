"""The phases of chip_smoke.py at a tiny size on the CPU, and the script's
refusal to run without a GPU. On a card the same functions run at 512^3."""

import os

import jax
import numpy as np
import pytest

import chip_smoke
from voxelized_geometry_tools_tpu.ops import render
from voxelized_geometry_tools_tpu.utils import compile_cache, gpu
from voxelized_geometry_tools_tpu.utils.workcell import EXTENT_M, WorkcellScene


@pytest.fixture(scope="module")
def frame():
    return chip_smoke.make_frame(64, 0, 128, 96)


@pytest.fixture(scope="module")
def carved(frame):
    return chip_smoke.phase_carve(frame, iters=1)


@pytest.fixture(scope="module")
def with_sdf(frame, carved):
    return chip_smoke.phase_edt(frame, iters=1)


@pytest.fixture(scope="module")
def rendered(frame, with_sdf):
    return chip_smoke.phase_render(frame, iters=1)


def test_phase_carve(carved):
    assert carved.ok, carved.line()
    assert "bit-exact" in carved.check


def test_phase_edt(with_sdf):
    assert with_sdf.ok, with_sdf.line()


def test_phase_render(rendered):
    assert rendered.ok, rendered.line()


def test_phase_queries(frame, rendered):
    r = chip_smoke.phase_queries(frame, iters=1, trajectories=4,
                                 waypoints=8, spheres=8)
    assert r.ok, r.line()
    assert "256 points" in r.check


def test_phase_pose(frame, with_sdf):
    r = chip_smoke.phase_pose(frame, iters=1)
    assert r.ok, r.line()


def test_phase_four_cards_on_virtual_mesh(frame, with_sdf):
    """The sharded phases on the 8 virtual CPU devices the suite runs with;
    each compares with the same computation on device 0."""
    results = chip_smoke.phase_four_cards(frame, iters=1)
    assert len(results) == 4
    for r in results:
        assert r.ok, r.line()
        assert r.name.endswith(f"{len(jax.devices())}cards")


def test_result_line_format():
    line = chip_smoke.PhaseResult("x", 1.5, 0.25, "ok check", True, 7).line()
    assert line.startswith("phase x: setup_s=1.500 median_s=0.250000")
    assert "peak_bytes_in_use=7 PASS ok check" in line


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_fails_without_gpu(argv, capsys):
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present: main() would run the smoke test")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert "needs a GPU" in str(exc.value)
    out = capsys.readouterr().out
    assert '"ok"' not in out  # no result line


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert gpu.card_line().startswith("nvidia-smi unavailable")


def test_workcell_scene_is_seeded_and_keeps_the_middle_clear():
    a = WorkcellScene.make(64, 3)
    b = WorkcellScene.make(64, 3)
    np.testing.assert_array_equal(a.centers, b.centers)
    assert not np.array_equal(a.centers,
                              WorkcellScene.make(64, 4).centers)
    mid = EXTENT_M / 2.0
    gap = np.hypot(a.centers[:, 0] - mid, a.centers[:, 1] - mid) - a.radii
    assert gap.min() > a.CLEAR_RADIUS
    mask = a.mask()
    assert mask.shape == (64, 64, 64) and mask[:, :, 0].all()
    # The inspection camera sees floor only: every pixel returns a point
    # at the floor's height.
    pose = a.inspection_pose()
    pts = a.depth_points(pose, 32, 24, 26.0)
    assert pts.shape == (32 * 24, 3)
    world = pts @ pose[:3, :3].T.astype(np.float64) + pose[:3, 3]
    np.testing.assert_allclose(world[:, 2], a.floor_top, atol=1e-4)


def test_planner_points_stay_in_the_grid():
    pts = chip_smoke.planner_points(WorkcellScene.make(64, 0), 0)
    assert pts.shape == (64, 64, 32, 3)
    assert pts.min() > 0.0 and pts.max() < EXTENT_M


def _result(depth, hit, distance):
    depth = np.asarray(depth, np.float32)
    return render.RenderResult(depth, np.asarray(hit), None,
                               np.asarray(distance, np.float32))


def test_render_contract_counts_violations():
    res = 0.04                     # thresh 0.01, grazer band 0.0032
    n = 100
    base = _result(np.ones(n), np.ones(n, bool), np.zeros(n))
    a = render.compare_with_plain_march(base, base, res)
    assert a.ok and (a.skipped, a.off_depth, a.grazers) == (0, 0, 0)
    # One skipped surface and one common hit off by more than 2 * thresh.
    hit = np.ones(n, bool)
    hit[0] = False
    depth = np.ones(n)
    depth[1] = 1.021
    a = render.compare_with_plain_march(
        base, _result(depth, hit, np.zeros(n)), res)
    assert not a.ok and (a.skipped, a.off_depth) == (1, 1)
    assert a.max_depth_err == pytest.approx(0.021, abs=1e-6)
    # Within 2 * thresh is agreement.
    depth[1] = 1.019
    hit[0] = True
    assert render.compare_with_plain_march(
        base, _result(depth, hit, np.zeros(n)), res).ok
    # A plain grazer (query at the threshold) may classify either way.
    graze = _result(np.ones(n), np.ones(n, bool), np.full(n, 0.01))
    miss_all = _result(np.ones(n), np.zeros(n, bool), graze.distance)
    a = render.compare_with_plain_march(graze, miss_all, res)
    assert a.ok and a.grazers == n
    # A plain hit that ran out of budget unconverged found no surface.
    unconverged = _result(np.ones(n), np.ones(n, bool), np.full(n, 0.018))
    a = render.compare_with_plain_march(unconverged, miss_all, res)
    assert a.ok and (a.unconverged, a.grazers) == (n, 0)
    # The plain march stopped in a dip at the threshold and the other met
    # a surface behind it: exempt. The reverse, a plain crossing (query 0)
    # in front of the other's stop, means the other passed a surface.
    depth = np.ones(n)
    depth[7] = 2.0
    a = render.compare_with_plain_march(
        graze, _result(depth, np.ones(n, bool), np.zeros(n)), res)
    assert a.ok and a.grazers == 1
    a = render.compare_with_plain_march(
        _result(np.ones(n), np.ones(n, bool), np.zeros(n)),
        _result(depth, np.ones(n, bool), np.full(n, 0.01)), res)
    assert not a.ok and a.off_depth == 1
    # So may a pixel where the OTHER render stopped in a sub-threshold
    # dip the plain march stepped over: a surface 1 m nearer.
    other_dist = np.zeros(n)
    other_dist[5] = 0.0095
    depth = np.ones(n)
    depth[5] = 0.0
    a = render.compare_with_plain_march(
        base, _result(depth, np.ones(n, bool), other_dist), res)
    assert a.ok and (a.grazers, a.off_depth) == (1, 0)
    # Outside the band the same depth jump is a violation.
    other_dist[5] = 0.005
    assert not render.compare_with_plain_march(
        base, _result(depth, np.ones(n, bool), other_dist), res).ok


def test_compile_cache_uses_the_variable_when_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
