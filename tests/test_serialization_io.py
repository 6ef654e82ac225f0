"""Serialization, conversions, message wrap, viz export, PointCloud2 tests.

Map-level round-trip strategy mirrors
/root/reference/test/occupancy_map_conversions_test.cpp (defaults, uniform
fills, per-index patterned grids, frame/origin preservation)."""

import numpy as np
import jax.numpy as jnp
import pytest

from voxelized_geometry_tools_tpu import (
    GridSpec, OccupancyComponentMap, OccupancyMap, SignedDistanceField,
    TaggedObjectOccupancyComponentMap, TaggedObjectOccupancyMap)
from voxelized_geometry_tools_tpu.core import (
    conversions, serialization, transforms)
from voxelized_geometry_tools_tpu.io import messages, pointcloud2, viz


def patterned_maps():
    spec = GridSpec.from_voxel_counts(0.25, (4, 5, 6))
    origin = transforms.isometry_from_translation((1.0, -2.0, 0.5))
    rng = np.random.default_rng(5)
    occ = rng.choice([0.0, 0.5, 1.0], size=spec.counts).astype(np.float32)
    obj = rng.integers(0, 4, size=spec.counts).astype(np.uint32)
    comp = rng.integers(0, 3, size=spec.counts).astype(np.uint32)
    seg = rng.integers(0, 3, size=spec.counts).astype(np.uint32)

    m1 = OccupancyMap.create(spec, origin, "frame_a").replace(
        occupancy=jnp.asarray(occ))
    m2 = OccupancyComponentMap.create(spec, origin, "frame_b").replace(
        occupancy=jnp.asarray(occ), component=jnp.asarray(comp))
    m3 = TaggedObjectOccupancyMap.create(spec, origin, "frame_c").replace(
        occupancy=jnp.asarray(occ), object_id=jnp.asarray(obj))
    m4 = TaggedObjectOccupancyComponentMap.create(
        spec, origin, "frame_d").replace(
        occupancy=jnp.asarray(occ), object_id=jnp.asarray(obj),
        component=jnp.asarray(comp), spatial_segment=jnp.asarray(seg))
    return [m1, m2, m3, m4]


@pytest.mark.parametrize("compress", [True, False])
def test_map_file_round_trip(tmp_path, compress):
    for m in patterned_maps():
        path = str(tmp_path / f"{type(m).__name__}.vgt")
        serialization.save_to_file(m, path, compress=compress)
        loaded = serialization.load_from_file(path)
        assert type(loaded) is type(m)
        assert loaded.spec == m.spec
        assert loaded.frame == m.frame
        np.testing.assert_allclose(np.asarray(loaded.origin_transform),
                                   np.asarray(m.origin_transform), atol=1e-7)
        np.testing.assert_array_equal(np.asarray(loaded.occupancy),
                                      np.asarray(m.occupancy))
        if hasattr(m, "object_id"):
            np.testing.assert_array_equal(np.asarray(loaded.object_id),
                                          np.asarray(m.object_id))


def test_sdf_round_trip_preserves_lock_and_magic(tmp_path):
    spec = GridSpec.from_voxel_counts(0.5, (3, 3, 3))
    sdf = SignedDistanceField.create(
        spec, np.arange(27, dtype=np.float32).reshape(3, 3, 3) - 13.0,
        frame="sdf_frame", oob_value=42.0, locked=True)
    path = str(tmp_path / "test.sdf")
    serialization.save_to_file(sdf, path, compress=True)
    with open(path, "rb") as f:
        assert f.read(4) == b"SDFZ"
    loaded = serialization.load_from_file(path)
    assert loaded.locked
    assert loaded.oob_value == 42.0
    assert float(loaded.minimum) == -13.0
    assert float(loaded.maximum) == 13.0
    np.testing.assert_array_equal(np.asarray(loaded.distances),
                                  np.asarray(sdf.distances))
    # Uncompressed magic.
    serialization.save_to_file(sdf, path, compress=False)
    with open(path, "rb") as f:
        assert f.read(4) == b"SDFR"
    assert serialization.load_from_file(path).frame == "sdf_frame"


def test_bad_magic_rejected():
    with pytest.raises(ValueError):
        serialization.from_file_bytes(b"XXXX" + b"junk")
    with pytest.raises(ValueError):
        serialization.from_file_bytes(b"ab")


def test_conversions_round_trip():
    m1, m2, m3, m4 = patterned_maps()
    # occupancy <-> occupancy component
    up = conversions.to_occupancy_component_map(m1)
    np.testing.assert_array_equal(np.asarray(up.occupancy),
                                  np.asarray(m1.occupancy))
    assert np.asarray(up.component).max() == 0
    down = conversions.from_occupancy_component_map(m2)
    np.testing.assert_array_equal(np.asarray(down.occupancy),
                                  np.asarray(m2.occupancy))
    assert down.frame == m2.frame
    # tagged <-> tagged component
    up2 = conversions.to_tagged_object_occupancy_component_map(m3)
    np.testing.assert_array_equal(np.asarray(up2.object_id),
                                  np.asarray(m3.object_id))
    down2 = conversions.from_tagged_object_occupancy_component_map(m4)
    np.testing.assert_array_equal(np.asarray(down2.occupancy),
                                  np.asarray(m4.occupancy))
    np.testing.assert_array_equal(np.asarray(down2.object_id),
                                  np.asarray(m4.object_id))


def test_message_round_trip():
    for m in patterned_maps():
        msg = messages.get_message_representation(m, compress=True)
        assert msg["is_compressed"]
        loaded = messages.load_from_message_representation(msg)
        assert type(loaded) is type(m)
        np.testing.assert_array_equal(np.asarray(loaded.occupancy),
                                      np.asarray(m.occupancy))


def test_pointcloud2_parsing():
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    # 16-byte point step with 4 bytes padding.
    raw = np.zeros((10, 16), np.uint8)
    raw[:, :12] = pts.view(np.uint8).reshape(10, 12)
    msg = {
        "fields": [
            {"name": "x", "offset": 0, "datatype": pointcloud2.FLOAT32},
            {"name": "y", "offset": 4, "datatype": pointcloud2.FLOAT32},
            {"name": "z", "offset": 8, "datatype": pointcloud2.FLOAT32},
        ],
        "point_step": 16, "width": 10, "height": 1,
        "data": raw.tobytes(),
    }
    cloud = pointcloud2.pointcloud_from_pointcloud2(msg, np.eye(4), 10.0)
    np.testing.assert_array_equal(np.asarray(cloud.points), pts)
    # Non-sequential fields rejected.
    bad = dict(msg)
    bad["fields"] = [
        {"name": "x", "offset": 0, "datatype": pointcloud2.FLOAT32},
        {"name": "y", "offset": 8, "datatype": pointcloud2.FLOAT32},
        {"name": "z", "offset": 4, "datatype": pointcloud2.FLOAT32},
    ]
    with pytest.raises(ValueError):
        pointcloud2.pointcloud_from_pointcloud2(bad, np.eye(4), 10.0)
    with pytest.raises(ValueError):
        pointcloud2.pointcloud_from_pointcloud2(msg, np.eye(4), -1.0)


def test_viz_exports():
    m1, m2, _, m4 = patterned_maps()
    marker = viz.export_occupancy_for_display(m1)
    occ = np.asarray(m1.occupancy)
    assert marker.num_cells == occ.size  # all cells colored
    assert marker.positions.shape[1] == 3
    assert marker.colors.shape[1] == 4
    # Filled cells red, free green.
    filled_frac = (occ > 0.5).sum()
    red = (marker.colors[:, 0] == 1.0) & (marker.colors[:, 1] == 0.0)
    assert red.sum() == filled_frac

    comp_marker = viz.export_connected_components_for_display(m2)
    assert comp_marker.num_cells == int((np.asarray(m2.component) > 0).sum())

    # color_unknown_components=False paints unknown cells opaque gray
    # instead of their palette color (ros_interface.cpp:356-389); gray is
    # opaque so unknown cells with component 0 now export too.
    gray = viz.export_connected_components_for_display(
        m2, color_unknown_components=False)
    unknown = np.asarray(m2.occupancy) == 0.5
    expected = int(((np.asarray(m2.component) > 0) | unknown).sum())
    assert gray.num_cells == expected
    if unknown.any():
        gray_rows = np.all(gray.colors == (0.5, 0.5, 0.5, 1.0), axis=1)
        assert gray_rows.sum() == int(unknown.sum())

    seg_marker = viz.export_spatial_segments_for_display(m4)
    assert seg_marker.num_cells == int(
        (np.asarray(m4.spatial_segment) > 0).sum())

    from voxelized_geometry_tools_tpu.ops import edt
    sdf = edt.extract_sdf_from_occupancy(m1.occupancy, m1.spec,
                                         m1.origin_transform)
    sdf_marker = viz.export_sdf_for_display(sdf)
    assert sdf_marker.num_cells == occ.size
    coll_marker = viz.export_sdf_collision_only(sdf)
    assert coll_marker.num_cells == int(
        (np.asarray(sdf.distances) <= 0.0).sum())


def test_export_voxel_grid_indices_and_index_map():
    from voxelized_geometry_tools_tpu.io import viz
    from voxelized_geometry_tools_tpu import GridSpec
    import numpy as np
    spec = GridSpec.from_voxel_counts(0.5, (4, 4, 4))
    origin = np.eye(4)
    m = viz.export_voxel_grid_indices(
        spec, origin, "f", [(0, 0, 0), (3, 3, 3)], (1.0, 0.0, 0.0, 0.5))
    assert m.num_cells == 2
    np.testing.assert_allclose(m.positions[0], (0.25, 0.25, 0.25))
    np.testing.assert_allclose(m.positions[1], (1.75, 1.75, 1.75))

    imap = {(1, 2, 3): (0.0, 1.0, 0.0, 1.0), (0, 0, 0): (0, 0, 0, 0.0)}
    m2 = viz.export_voxel_grid_index_map(spec, origin, "f", imap)
    assert m2.num_cells == 1  # zero-alpha dropped
    np.testing.assert_allclose(m2.positions[0], (0.75, 1.25, 1.75))
    m3 = viz.export_voxel_grid_index_map(spec, origin, "f", {})
    assert m3.num_cells == 0


def test_export_index_map_uint8_flags():
    """The reference's exact uint8-flag ExportIndexMapForDisplay signature
    (ros_interface.hpp:639-649): flagged indices in ONE color, zero flags
    skipped."""
    from voxelized_geometry_tools_tpu import OccupancyMap, GridSpec
    from voxelized_geometry_tools_tpu.io import viz
    omap = OccupancyMap.create(GridSpec.from_voxel_counts(0.5, (4, 4, 4)),
                               frame="f")
    flags = {(0, 0, 0): 1, (1, 1, 1): 0, (2, 3, 1): 255}
    m = viz.export_index_map_for_display(omap, flags, (0.0, 0.0, 1.0, 1.0))
    assert m.num_cells == 2
    assert m.ns == "occupancy_map_surface"
    np.testing.assert_allclose(sorted(m.positions[:, 0]), (0.25, 1.25))
    assert viz.export_index_map_for_display(omap, {}, (1, 0, 0, 1)
                                            ).num_cells == 0


def test_viz_non_uniform_voxel_sizes():
    """Marker scale and cell centers honor per-axis voxel sizes
    (ros_interface.hpp:92-148 uses VoxelSizes()/
    GridIndexToLocationInGridFrame)."""
    from voxelized_geometry_tools_tpu import GridSpec
    from voxelized_geometry_tools_tpu.io import viz
    spec = GridSpec.from_voxel_sizes((0.5, 1.0, 2.0), (2, 2, 2))

    def color(vals):
        rgba = np.zeros(vals.shape + (4,), np.float32)
        rgba[..., 0] = 1.0
        rgba[..., 3] = 1.0
        return rgba

    m = viz.export_voxel_grid(spec, np.eye(4), "f", color,
                              np.zeros(spec.counts))
    np.testing.assert_allclose(m.scale, (0.5, 1.0, 2.0))
    np.testing.assert_allclose(m.positions[0], (0.25, 0.5, 1.0))
    np.testing.assert_allclose(m.positions[-1], (0.75, 1.5, 3.0))

    mi = viz.export_voxel_grid_indices(spec, np.eye(4), "f", [(1, 0, 1)],
                                       (1, 0, 0, 1))
    np.testing.assert_allclose(mi.positions[0], (0.75, 0.5, 3.0))
    np.testing.assert_allclose(mi.scale, (0.5, 1.0, 2.0))


def test_component_metadata_round_trip(tmp_path):
    """number_of_components / validity flags survive the file round trip
    (the reference serializes the derived component metadata,
    occupancy_component_map.cpp:66-109)."""
    from voxelized_geometry_tools_tpu import OccupancyComponentMap
    from voxelized_geometry_tools_tpu.core import serialization
    from voxelized_geometry_tools_tpu.ops import map_ops

    spec = GridSpec.from_voxel_counts(1.0, (4, 4, 4))
    m = OccupancyComponentMap.create(spec, None, "w")
    occ = np.zeros((4, 4, 4), np.float32)
    occ[0, 0, 0] = 1.0
    occ[3, 3, 3] = 1.0
    m = m.set_occupancy(jnp.asarray(occ))
    m = map_ops.update_connected_components(m)
    n_before = int(m.number_of_components)
    assert n_before > 0 and m.components_valid

    path = str(tmp_path / "cmap.vgt")
    serialization.save_to_file(m, path)
    loaded = serialization.load_from_file(path)
    assert int(loaded.number_of_components) == n_before
    assert loaded.components_valid
    np.testing.assert_array_equal(np.asarray(loaded.component),
                                  np.asarray(m.component))


def test_integer_location_to_index():
    """Integer-typed query points must not truncate a sub-unit resolution
    (float divide, not integer divide)."""
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    idx = np.asarray(spec.location_in_grid_frame_to_grid_index(
        jnp.asarray([1, 2, 3])))
    np.testing.assert_array_equal(idx, [4, 8, 12])


def test_export_single_spatial_segment():
    """ExportSpatialSegmentForDisplay(map, object_id, segment) shows only
    that object's segment (ros_interface.cpp:1065-1107)."""
    from voxelized_geometry_tools_tpu import TaggedObjectOccupancyComponentMap
    from voxelized_geometry_tools_tpu.io import viz

    spec = GridSpec.from_voxel_counts(1.0, (4, 4, 1))
    m = TaggedObjectOccupancyComponentMap.create(spec, None, "w")
    seg = np.zeros((4, 4, 1), np.uint32)
    obj = np.zeros((4, 4, 1), np.uint32)
    seg[0, 0, 0] = 1
    obj[0, 0, 0] = 2
    seg[3, 3, 0] = 1
    obj[3, 3, 0] = 5  # same segment number, different object
    seg[1, 1, 0] = 2
    obj[1, 1, 0] = 2
    m = m.replace(spatial_segment=jnp.asarray(seg), object_id=jnp.asarray(obj),
                  number_of_spatial_segments=jnp.uint32(2),
                  spatial_segments_valid=True)
    # Stale segments raise, mirroring NumSpatialSegments().Value().
    import pytest
    with pytest.raises(ValueError):
        viz.export_spatial_segment_for_display(
            m.replace(spatial_segments_valid=False), 2, 1)
    marker = viz.export_spatial_segment_for_display(m, object_id=2,
                                                    spatial_segment=1)
    assert marker.num_cells == 1
    np.testing.assert_allclose(marker.positions[0], [0.5, 0.5, 0.5])
    # hot-to-cold helper: endpoints are blue (cold) and red (hot)
    cold = viz.interpolate_hot_to_cold(np.float64(0.0), 0.0, 1.0)
    hot = viz.interpolate_hot_to_cold(np.float64(1.0), 0.0, 1.0)
    np.testing.assert_allclose(cold, [0, 0, 1, 1], atol=1e-6)
    np.testing.assert_allclose(hot, [1, 0, 0, 1], atol=1e-6)


def make_dsh_map():
    from voxelized_geometry_tools_tpu.core.dsh import (
        DSHGridSizes, DynamicSpatialHashedOccupancyMap)
    m = DynamicSpatialHashedOccupancyMap(
        DSHGridSizes(0.25, (4, 4, 4)), default_occupancy=0.5, frame="dsh")
    m.set_location((0.1, 0.1, 0.1), 1.0)
    m.set_location((-0.9, 0.3, 0.1), 0.0)
    m.set_location((3.0, 3.0, 3.0), 1.0)
    return m


@pytest.mark.parametrize("compress", [True, False])
def test_dsh_generic_loader_round_trip(tmp_path, compress):
    """The generic save/load path must route DMGZ/DMGR payloads to the DSH
    deserializer (ros_interface.hpp:597-600 dispatch parity)."""
    from voxelized_geometry_tools_tpu.core.dsh import (
        DynamicSpatialHashedOccupancyMap)
    m = make_dsh_map()
    path = str(tmp_path / "map.dsh")
    serialization.save_to_file(m, path, compress=compress)
    loaded = serialization.load_from_file(path)
    assert isinstance(loaded, DynamicSpatialHashedOccupancyMap)
    assert loaded.frame == "dsh"
    assert loaded.num_chunks == m.num_chunks
    for p in [(0.1, 0.1, 0.1), (-0.9, 0.3, 0.1), (3.0, 3.0, 3.0),
              (10.0, 10.0, 10.0)]:
        v0, s0 = m.get_location(p)
        v1, s1 = loaded.get_location(p)
        assert v0 == v1 and s0 == s1


def test_dsh_message_round_trip():
    """DynamicSpatialHashedOccupancyMapMessage wrap/unwrap
    (ros_interface.hpp:597-600)."""
    from voxelized_geometry_tools_tpu.core.dsh import (
        DynamicSpatialHashedOccupancyMap)
    m = make_dsh_map()
    msg = messages.get_message_representation(m, compress=True)
    assert msg["header"]["frame_id"] == "dsh"
    loaded = messages.load_from_message_representation(msg)
    assert isinstance(loaded, DynamicSpatialHashedOccupancyMap)
    v, s = loaded.get_location((0.1, 0.1, 0.1))
    assert v == 1.0


def test_version1_payload_accepted():
    """Version-1 payloads (pre component-metadata block) still load: the v2
    additions default to invalid/zero when absent."""
    import struct
    m = patterned_maps()[1]  # OccupancyComponentMap
    data = serialization.serialize(m)
    # Strip the v2 component-metadata block (u8 + u32 after the 8-byte
    # version/kind header) and rewrite the version word to 1.
    v1 = struct.pack("<II", 1, 2) + data[8 + 5:]
    loaded = serialization.deserialize(v1)
    assert type(loaded) is type(m)
    assert bool(loaded.components_valid) is False
    assert int(loaded.number_of_components) == 0
    np.testing.assert_array_equal(np.asarray(loaded.occupancy),
                                  np.asarray(m.occupancy))


def test_separate_display_partitions_cells():
    """ExportForSeparateDisplay splits the map into collision/free/unknown
    markers whose cells partition the grid (ros_interface.hpp:495-498)."""
    m = patterned_maps()[0]
    occ = np.asarray(m.occupancy)
    markers = viz.export_for_separate_display(m)
    assert [mk.ns for mk in markers] == ["collision_only", "free_only",
                                        "unknown_only"]
    counts = [mk.num_cells for mk in markers]
    assert counts[0] == int((occ > 0.5).sum())
    assert counts[1] == int((occ < 0.5).sum())
    assert counts[2] == int((occ == 0.5).sum())
    assert sum(counts) == occ.size
    # Each marker is single-colored with the right RGBA.
    np.testing.assert_allclose(markers[0].colors,
                               np.tile([1, 0, 0, 0.5], (counts[0], 1)))
    np.testing.assert_allclose(markers[1].colors,
                               np.tile([0, 1, 0, 0.5], (counts[1], 1)))


def test_classified_and_separate_surfaces_display():
    from voxelized_geometry_tools_tpu.ops import topology
    m = patterned_maps()[0]
    surf = np.asarray(topology.is_surface_index(m.occupancy))
    occ = np.asarray(m.occupancy)
    single = viz.export_classified_surfaces_for_display(m)
    assert single.ns == "occupancy_surfaces"
    assert single.num_cells == int(surf.sum())
    markers = viz.export_surfaces_for_separate_display(m)
    assert [mk.ns for mk in markers] == [
        "collision_surfaces_only", "free_surfaces_only",
        "unknown_surfaces_only"]
    assert markers[0].num_cells == int((surf & (occ > 0.5)).sum())
    assert markers[1].num_cells == int((surf & (occ < 0.5)).sum())
    assert markers[2].num_cells == int((surf & (occ == 0.5)).sum())
    assert sum(mk.num_cells for mk in markers) == int(surf.sum())


def test_tagged_objects_display_with_color_map():
    """ExportForDisplay(map, object_color_map) per-object coloring
    (ros_interface.hpp:611-614)."""
    m = patterned_maps()[2]  # TaggedObjectOccupancyMap, object ids 0..3
    obj = np.asarray(m.object_id)
    color_map = {1: (1.0, 0.0, 0.0, 1.0), 3: (0.0, 0.0, 1.0, 0.25)}
    marker = viz.export_tagged_objects_for_display(m, color_map)
    assert marker.ns == "occupancy_map_objects"
    # Only ids 1 and 3 are mapped -> only their cells appear.
    assert marker.num_cells == int(((obj == 1) | (obj == 3)).sum())
    reds = (marker.colors == np.float32([1, 0, 0, 1])).all(axis=1).sum()
    blues = (marker.colors == np.float32([0, 0, 1, 0.25])).all(axis=1).sum()
    assert reds == int((obj == 1).sum())
    assert blues == int((obj == 3).sum())
    # Default: palette colors, id 0 transparent.
    marker = viz.export_tagged_objects_for_display(m)
    assert marker.num_cells == int((obj != 0).sum())


def test_tagged_object_surfaces_display():
    from voxelized_geometry_tools_tpu.ops import topology
    m = patterned_maps()[2]
    obj = np.asarray(m.object_id)
    surf = np.asarray(topology.is_surface_index(m.occupancy))
    marker = viz.export_tagged_object_surfaces_for_display(
        m, {2: (0.0, 1.0, 0.0, 1.0)})
    assert marker.ns == "occupancy_surfaces"
    assert marker.num_cells == int((surf & (obj == 2)).sum())


def test_dsh_separate_display():
    m = make_dsh_map()
    markers = viz.export_dsh_for_separate_display(m)
    assert [mk.ns for mk in markers] == ["collision_only", "free_only",
                                        "unknown_only"]
    # Two cells were written filled(1.0), one free(0.0); the rest of the
    # allocated chunks default to 0.5 (unknown).
    assert markers[0].num_cells == 2
    assert markers[1].num_cells == 1


def test_f64_sdf_origin_roundtrips_at_full_precision(tmp_path):
    """A double SDF's origin transform must survive save/load without an
    f32 round trip (ulp at 1e7 is ~1 meter in f32)."""
    import jax
    with jax.enable_x64():
        spec = GridSpec.from_voxel_counts(1.0, (4, 4, 4))
        t = np.eye(4)
        t[:3, 3] = (1e7 + 0.123, -2.5, 7.0)
        sdf = SignedDistanceField.create(
            spec, jnp.zeros((4, 4, 4), jnp.float64), t, dtype=jnp.float64,
            locked=True)
        path = tmp_path / "f64.sdf"
        serialization.save_to_file(sdf, str(path))
        loaded = serialization.load_from_file(str(path))
        assert loaded.origin_transform.dtype == jnp.float64
        assert float(loaded.origin_transform[0, 3]) == 1e7 + 0.123


def test_corrupt_payloads_raise_valueerror():
    spec = GridSpec.from_voxel_counts(1.0, (3, 3, 3))
    m = OccupancyMap.create(spec)
    blob = serialization.to_file_bytes(m, compress=False)
    # Unknown kind fails BEFORE body parsing, with the intended error.
    bad_kind = blob[:8] + (99).to_bytes(4, "little") + blob[12:]
    with pytest.raises(ValueError, match="kind"):
        serialization.from_file_bytes(bad_kind)
    # Truncation maps to the ValueError contract, not raw struct.error.
    with pytest.raises(ValueError):
        serialization.from_file_bytes(blob[: len(blob) // 2])


def test_pointcloud2_row_padding_endianness_and_overhang():
    from voxelized_geometry_tools_tpu.io import pointcloud2 as pc2
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    fields = [dict(name=n, offset=o, datatype=pc2.FLOAT32)
              for n, o in (("x", 0), ("y", 4), ("z", 8))]
    # Organized 2x2 cloud, point_step 12, row_step 32 (8 bytes padding).
    data = b"".join(pts[r * 2: r * 2 + 2].tobytes() + b"\0" * 8
                    for r in (0, 1))
    out = pc2.points_from_pointcloud2(fields, 12, data, 4,
                                      row_step=32, width=2)
    np.testing.assert_array_equal(out, pts)
    # Big-endian clouds are rejected, not silently byte-swapped.
    with pytest.raises(ValueError, match="big-endian"):
        pc2.points_from_pointcloud2(fields, 12, pts.tobytes(), 4,
                                    is_bigendian=True)
    # xyz overhanging point_step is a clear layout error.
    bad = [dict(name=n, offset=o, datatype=pc2.FLOAT32)
           for n, o in (("x", 8), ("y", 12), ("z", 16))]
    with pytest.raises(ValueError, match="overhang"):
        pc2.points_from_pointcloud2(bad, 16, b"\0" * 64, 4)
    # Size mismatches name the cause instead of a reshape error.
    with pytest.raises(ValueError, match="data size"):
        pc2.points_from_pointcloud2(fields, 12, pts.tobytes()[:-4], 4)
    # The full message path with row_step in the dict.
    msg = dict(fields=fields, point_step=12, width=2, height=2, data=data,
               row_step=32, is_bigendian=False)
    cloud = pc2.pointcloud_from_pointcloud2(msg, np.eye(4))
    np.testing.assert_array_equal(np.asarray(cloud.points), pts)


def test_message_wire_parity_sdf_field_names_and_tags():
    """SDF messages must use the reference wire contract: field
    'serialized_sdf', scalar_type 1 (float) / 2 (double) — a bridged real
    SignedDistanceFieldMessage is loadable, including bytes payloads."""
    from voxelized_geometry_tools_tpu.io import messages
    assert messages.SCALAR_TYPE_FLOAT == 1   # msg spec values, not the
    assert messages.SCALAR_TYPE_DOUBLE == 2  # internal dtype tags
    spec = GridSpec.from_voxel_counts(1.0, (3, 3, 3))
    sdf = SignedDistanceField.create(spec, jnp.zeros((3, 3, 3)),
                                     locked=True)
    msg = messages.get_message_representation(sdf)
    assert "serialized_sdf" in msg and "serialized_map" not in msg
    assert msg["scalar_type"] == 1
    # bytes payloads (rospy-style) load fine.
    msg["serialized_sdf"] = bytes(msg["serialized_sdf"])
    loaded = messages.load_from_message_representation(msg)
    assert loaded.spec == spec
    # A mismatched tag raises like the reference loader.
    msg["scalar_type"] = 2
    with pytest.raises(ValueError, match="scalar type"):
        messages.load_from_message_representation(msg)
    # Corrupt payloads map to ValueError, not zlib.error.
    m2 = messages.get_message_representation(OccupancyMap.create(spec))
    assert "serialized_map" in m2
    m2["serialized_map"] = m2["serialized_map"][:10]
    with pytest.raises(ValueError):
        messages.load_from_message_representation(m2)
