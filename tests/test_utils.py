"""Tests for the profiling utilities."""

import jax.numpy as jnp

from voxelized_geometry_tools_tpu.utils import PhaseTimer, trace


def test_phase_timer_accumulates():
    timer = PhaseTimer()
    # The yielded list materializes the block's OWN outputs on exit — the
    # pattern an entry-time-only argument binding could never support.
    with timer.phase("a") as outs:
        x = jnp.arange(1000.0) * 2.0
        outs.append(x)
    with timer.phase("b", x) as outs:
        y = x + 1.0
        outs.append(y)
    with timer.phase("a"):
        pass
    times = timer.times()
    assert set(times) == {"a", "b"}
    assert times["a"] >= 0.0 and times["b"] >= 0.0
    assert timer.total() == times["a"] + times["b"]
    report = timer.report()
    assert "a:" in report and "total:" in report


def test_phase_timer_failed_phase_records_nothing():
    import pytest
    timer = PhaseTimer()
    with pytest.raises(RuntimeError, match="boom"):
        with timer.phase("bad"):
            raise RuntimeError("boom")
    assert "bad" not in timer.times()


def test_phase_timer_under_tracing():
    """Inside jit the phase outputs are tracers: waiting on them must be a
    no-op, not a crash, and the phase still records a time."""
    import jax
    timer = PhaseTimer()

    @jax.jit
    def f(v):
        with timer.phase("traced") as outs:
            w = v * 2.0
            outs.append(w)
        return w

    assert float(f(jnp.ones(3))[0]) == 2.0
    assert timer.times()["traced"] >= 0.0


def test_trace_noop():
    with trace(None):
        x = jnp.ones(4) + 1.0
    assert float(x[0]) == 2.0


def test_trace_writes(tmp_path):
    with trace(str(tmp_path)):
        (jnp.ones(64) * 3.0).sum()
    assert any(tmp_path.iterdir())


def test_quaternion_round_trip():
    """matrix -> quaternion -> matrix round-trips for random rotations,
    including trace<=0 branches (Shepperd)."""
    import numpy as np
    from voxelized_geometry_tools_tpu.core import transforms

    rng = np.random.default_rng(5)
    mats = []
    for _ in range(20):
        a = rng.standard_normal((3, 3))
        q, _ = np.linalg.qr(a)
        q *= np.sign(np.linalg.det(q))
        mats.append(q)
    # 180-degree rotations exercise the non-positive-trace branches.
    mats.append(np.diag([1.0, -1.0, -1.0]))
    mats.append(np.diag([-1.0, 1.0, -1.0]))
    mats.append(np.diag([-1.0, -1.0, 1.0]))
    for m in mats:
        quat = transforms.rotation_matrix_to_quaternion(m)
        back = np.asarray(transforms.quaternion_to_rotation_matrix(quat))
        np.testing.assert_allclose(back, m, atol=1e-6)

    t, quat = transforms.isometry_to_pose(
        transforms.isometry_from_quaternion_translation(
            [0.5, 0.5, 0.5, 0.5], (1.0, 2.0, 3.0)))
    np.testing.assert_allclose(t, [1.0, 2.0, 3.0], atol=1e-6)
    # Only a GLOBAL sign flip is legitimate (double cover); per-component
    # abs() would also pass for different rotations.
    target = np.asarray([0.5, 0.5, 0.5, 0.5])
    assert (np.allclose(quat, target, atol=1e-6)
            or np.allclose(quat, -target, atol=1e-6)), quat


def test_voxel_marker_pose_quaternion():
    import numpy as np
    from voxelized_geometry_tools_tpu import GridSpec, OccupancyMap
    from voxelized_geometry_tools_tpu.core import transforms
    from voxelized_geometry_tools_tpu.io import viz

    spec = GridSpec.from_voxel_counts(1.0, (2, 2, 2))
    origin = transforms.isometry_from_axis_angle((0, 0, 1), 0.7)
    origin = np.asarray(origin).copy()
    origin[:3, 3] = (1.0, -2.0, 0.5)
    m = OccupancyMap.create(spec, origin, "w")
    marker = viz.export_occupancy_for_display(m)
    t, q = marker.pose_translation_quaternion()
    np.testing.assert_allclose(t, [1.0, -2.0, 0.5], atol=1e-6)
    back = np.asarray(transforms.quaternion_to_rotation_matrix(q))
    np.testing.assert_allclose(back, origin[:3, :3], atol=1e-5)


def test_public_modules_type_hints_resolve():
    """`typing.get_type_hints` must succeed on every public module's
    module-level callables and classes — a latent-landmine guard: an
    annotation naming a type the module never imports is harmless at
    runtime under `from __future__ import annotations` but raises the
    moment any introspection tool (IDE, pydantic, docs) resolves it
    (ops/map_ops.py was once annotated with an unimported
    OccupancyComponentMap)."""
    import importlib
    import inspect
    import pkgutil
    import typing

    import voxelized_geometry_tools_tpu as pkg

    failures = []
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_"):
                continue
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            try:
                typing.get_type_hints(obj)
                if inspect.isclass(obj):
                    for m_name, m in vars(obj).items():
                        if inspect.isfunction(m):
                            typing.get_type_hints(m)
            except Exception as exc:  # noqa: BLE001 - collect all failures
                failures.append(f"{mod.__name__}.{name}: {exc!r}")
    assert not failures, "\n".join(failures)
