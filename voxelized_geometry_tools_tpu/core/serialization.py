"""Binary serialization / file IO for maps and SDFs — the checkpoint story.

Mirrors the reference's envelope: a 4-byte magic selecting raw vs
zlib-compressed payload (``SDFZ/SDFR`` for SDFs — signed_distance_field.hpp:
643-722; ``CMGZ/CMGR`` for occupancy and occupancy-component maps —
occupancy_map.cpp:116-193; ``TMGZ/TMGR`` for the tagged types; ``DMGZ/DMGR``
for the dynamic spatial-hashed map).

Payload layout is the VGT v2 format (documented below), *not* the
reference's byte layout: the reference's grid serializer lives in the external
``common_robotics_utilities`` package (not vendored here), so byte
compatibility cannot be implemented or validated against it. The envelope,
magics, compression flag, and round-trip semantics (frame, origin transform,
locked flag, scalar-type tag) are preserved.

VGT v2 payload (little-endian):
  u32   format version (2; v1 files — no component-metadata block — load)
  u32   map kind tag
  u8    scalar type tag (4 = f32, 8 = f64) — SDF only, mirrored from
        msg/SignedDistanceFieldMessage.msg:3-6
  u8    locked flag (SDF only)
  u8 components_valid + u32 number_of_components (component kinds only;
  tagged-component adds u8 segments_valid + u32 number_of_spatial_segments
  — the derived metadata the reference serializer keeps,
  occupancy_component_map.cpp:66-109)
  u32   frame string length + utf-8 bytes
  f64   resolution
  f64[16] origin transform (row-major 4x4)
  i64[3] voxel counts
  u32   channel count, then per channel:
    u32 name length + utf-8 name, u8 dtype tag, raw C-order array bytes
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from .grid import GridSpec
from .maps import (
    OccupancyComponentMap, OccupancyMap, SignedDistanceField,
    TaggedObjectOccupancyComponentMap, TaggedObjectOccupancyMap)

_VERSION = 2

_KIND_OCCUPANCY = 1
_KIND_OCCUPANCY_COMPONENT = 2
_KIND_TAGGED = 3
_KIND_TAGGED_COMPONENT = 4
_KIND_SDF = 5
_KIND_DSH = 6  # payload owned by core.dsh (version 1 layout)

_DTYPE_TAGS = {np.dtype(np.float32): 1, np.dtype(np.uint32): 2,
               np.dtype(np.int32): 3, np.dtype(np.float64): 4}
_TAG_DTYPES = {v: k for k, v in _DTYPE_TAGS.items()}

_MAGICS = {
    _KIND_OCCUPANCY: (b"CMGZ", b"CMGR"),
    _KIND_OCCUPANCY_COMPONENT: (b"CMGZ", b"CMGR"),
    _KIND_TAGGED: (b"TMGZ", b"TMGR"),
    _KIND_TAGGED_COMPONENT: (b"TMGZ", b"TMGR"),
    _KIND_SDF: (b"SDFZ", b"SDFR"),
    _KIND_DSH: (b"DMGZ", b"DMGR"),
}


def _write_string(buf: io.BytesIO, s: str):
    data = s.encode("utf-8")
    buf.write(struct.pack("<I", len(data)))
    buf.write(data)


def _read_string(buf: io.BytesIO) -> str:
    (n,) = struct.unpack("<I", buf.read(4))
    return buf.read(n).decode("utf-8")


def _write_channel(buf: io.BytesIO, name: str, arr: np.ndarray):
    _write_string(buf, name)
    buf.write(struct.pack("<B", _DTYPE_TAGS[arr.dtype]))
    buf.write(np.ascontiguousarray(arr).tobytes())


def _read_channel(buf: io.BytesIO, counts) -> Tuple[str, np.ndarray]:
    name = _read_string(buf)
    (tag,) = struct.unpack("<B", buf.read(1))
    dtype = _TAG_DTYPES[tag]
    n = int(np.prod(counts)) * dtype.itemsize
    arr = np.frombuffer(buf.read(n), dtype=dtype).reshape(counts)
    return name, arr


def _map_kind(m) -> int:
    """Kind tag from type alone — no device-to-host channel materialization
    (to_file_bytes previously pulled every channel twice: once for the
    discarded kind lookup, once inside serialize)."""
    from .dsh import DynamicSpatialHashedOccupancyMap
    if isinstance(m, DynamicSpatialHashedOccupancyMap):
        return _KIND_DSH
    if isinstance(m, SignedDistanceField):
        return _KIND_SDF
    if isinstance(m, TaggedObjectOccupancyComponentMap):
        return _KIND_TAGGED_COMPONENT
    if isinstance(m, TaggedObjectOccupancyMap):
        return _KIND_TAGGED
    if isinstance(m, OccupancyComponentMap):
        return _KIND_OCCUPANCY_COMPONENT
    if isinstance(m, OccupancyMap):
        return _KIND_OCCUPANCY
    raise TypeError(f"Unsupported map type: {type(m)}")


def _map_kind_and_channels(m) -> Tuple[int, Dict[str, np.ndarray], dict]:
    extra = {}
    if isinstance(m, SignedDistanceField):
        extra = dict(locked=m.locked, oob_value=m.oob_value)
        return _KIND_SDF, {"distances": np.asarray(m.distances)}, extra
    if isinstance(m, TaggedObjectOccupancyComponentMap):
        extra = dict(
            components_valid=m.components_valid,
            number_of_components=int(m.number_of_components),
            spatial_segments_valid=m.spatial_segments_valid,
            number_of_spatial_segments=int(m.number_of_spatial_segments))
        return _KIND_TAGGED_COMPONENT, {
            "occupancy": np.asarray(m.occupancy),
            "object_id": np.asarray(m.object_id),
            "component": np.asarray(m.component),
            "spatial_segment": np.asarray(m.spatial_segment)}, extra
    if isinstance(m, TaggedObjectOccupancyMap):
        return _KIND_TAGGED, {
            "occupancy": np.asarray(m.occupancy),
            "object_id": np.asarray(m.object_id)}, extra
    if isinstance(m, OccupancyComponentMap):
        extra = dict(components_valid=m.components_valid,
                     number_of_components=int(m.number_of_components))
        return _KIND_OCCUPANCY_COMPONENT, {
            "occupancy": np.asarray(m.occupancy),
            "component": np.asarray(m.component)}, extra
    if isinstance(m, OccupancyMap):
        return _KIND_OCCUPANCY, {"occupancy": np.asarray(m.occupancy)}, extra
    raise TypeError(f"Unsupported map type: {type(m)}")


def serialize(m) -> bytes:
    """Serialize any map/SDF to the VGT v2 payload (DSH maps use their
    own kind-6 payload, core/dsh.py)."""
    from .dsh import DynamicSpatialHashedOccupancyMap
    if isinstance(m, DynamicSpatialHashedOccupancyMap):
        return m.serialize()
    # The payload stores only the scalar resolution; a non-uniform spec
    # (constructible via the raw dataclass path) would silently collapse
    # to uniform geometry on load — refuse instead.
    m.spec.enforce_uniform_voxel_size()
    kind, channels, extra = _map_kind_and_channels(m)
    buf = io.BytesIO()
    buf.write(struct.pack("<II", _VERSION, kind))
    if kind == _KIND_SDF:
        scalar_tag = 8 if channels["distances"].dtype == np.float64 else 4
        buf.write(struct.pack("<BB", scalar_tag, int(extra["locked"])))
        buf.write(struct.pack("<d", float(extra["oob_value"])))
    elif kind in (_KIND_OCCUPANCY_COMPONENT, _KIND_TAGGED_COMPONENT):
        buf.write(struct.pack("<BI", int(extra["components_valid"]),
                              extra["number_of_components"]))
        if kind == _KIND_TAGGED_COMPONENT:
            buf.write(struct.pack(
                "<BI", int(extra["spatial_segments_valid"]),
                extra["number_of_spatial_segments"]))
    _write_string(buf, m.frame)
    buf.write(struct.pack("<d", m.spec.resolution))
    buf.write(np.asarray(m.origin_transform, np.float64).tobytes())
    buf.write(struct.pack("<3q", *m.spec.counts))
    buf.write(struct.pack("<I", len(channels)))
    for name, arr in channels.items():
        _write_channel(buf, name, arr)
    return buf.getvalue()


def deserialize(data: bytes):
    """Deserialize a VGT payload (v1 or v2) into the matching map type.

    Kind 6 (DSH) is routed to the chunked-map deserializer, mirroring the
    generic loader's dispatch in the reference (ros_interface.hpp:597-600).
    Version-1 payloads are accepted: v2 only added the component-metadata
    block, which defaults to invalid/zero when absent."""
    buf = io.BytesIO(data)
    version, kind = struct.unpack("<II", buf.read(8))
    if kind == _KIND_DSH:
        from .dsh import DynamicSpatialHashedOccupancyMap
        return DynamicSpatialHashedOccupancyMap.deserialize(data)
    if version not in (1, _VERSION):
        raise ValueError(f"Unsupported format version {version}")
    if kind not in (_KIND_SDF, _KIND_OCCUPANCY, _KIND_OCCUPANCY_COMPONENT,
                    _KIND_TAGGED, _KIND_TAGGED_COMPONENT):
        # Validate BEFORE parsing the body: a corrupt/future kind would
        # otherwise die mid-parse with a confusing struct/numpy error.
        raise ValueError(f"Unknown map kind {kind}")
    locked = False
    oob_value = float("inf")
    meta = {}
    if kind == _KIND_SDF:
        _scalar_tag, locked_u8 = struct.unpack("<BB", buf.read(2))
        locked = bool(locked_u8)
        (oob_value,) = struct.unpack("<d", buf.read(8))
    elif kind in (_KIND_OCCUPANCY_COMPONENT, _KIND_TAGGED_COMPONENT):
        if version >= 2:
            cv, nc = struct.unpack("<BI", buf.read(5))
            meta = dict(components_valid=bool(cv),
                        number_of_components=jnp.uint32(nc))
            if kind == _KIND_TAGGED_COMPONENT:
                sv, ns = struct.unpack("<BI", buf.read(5))
                meta.update(spatial_segments_valid=bool(sv),
                            number_of_spatial_segments=jnp.uint32(ns))
        else:
            meta = dict(components_valid=False,
                        number_of_components=jnp.uint32(0))
            if kind == _KIND_TAGGED_COMPONENT:
                meta.update(spatial_segments_valid=False,
                            number_of_spatial_segments=jnp.uint32(0))
    frame = _read_string(buf)
    (resolution,) = struct.unpack("<d", buf.read(8))
    origin = np.frombuffer(buf.read(16 * 8), np.float64).reshape(4, 4)
    counts = struct.unpack("<3q", buf.read(24))
    (n_channels,) = struct.unpack("<I", buf.read(4))
    channels = {}
    for _ in range(n_channels):
        name, arr = _read_channel(buf, counts)
        channels[name] = jnp.asarray(arr)

    spec = GridSpec(tuple(counts), resolution)
    # Hand the RAW f64 origin to create: _default_transform casts it to the
    # map's scalar dtype, so a double SDF keeps the full-precision origin
    # the file stored (a premature f32 cast here destroyed it).
    origin64 = np.ascontiguousarray(origin)
    origin32 = jnp.asarray(origin, jnp.float32)

    if kind == _KIND_SDF:
        # Preserve a stored double field when x64 is enabled; otherwise load
        # as float32 (the cross-precision tolerance story of SURVEY.md §7).
        stored = channels["distances"]
        dtype = stored.dtype if stored.dtype == jnp.float64 else jnp.float32
        return SignedDistanceField.create(
            spec, stored, origin64 if dtype == jnp.float64 else origin32,
            frame, oob_value=oob_value, locked=locked, dtype=dtype)
    if kind == _KIND_TAGGED_COMPONENT:
        m = TaggedObjectOccupancyComponentMap.create(spec, origin32, frame)
        return m.replace(**channels, **meta)
    if kind == _KIND_TAGGED:
        m = TaggedObjectOccupancyMap.create(spec, origin32, frame)
        return m.replace(**channels)
    if kind == _KIND_OCCUPANCY_COMPONENT:
        m = OccupancyComponentMap.create(spec, origin32, frame)
        return m.replace(**channels, **meta)
    if kind == _KIND_OCCUPANCY:
        m = OccupancyMap.create(spec, origin32, frame)
        return m.replace(**channels)
    raise ValueError(f"Unknown map kind {kind}")


def to_file_bytes(m, compress: bool = True) -> bytes:
    """Full file image: 4-byte magic + (optionally zlib-compressed) payload,
    matching the reference's SaveToFile envelope."""
    magic_z, magic_r = _MAGICS[_map_kind(m)]
    payload = serialize(m)
    if compress:
        return magic_z + zlib.compress(payload)
    return magic_r + payload


def from_file_bytes(data: bytes):
    """Load from a file image; decides decompression from the magic."""
    if len(data) < 4:
        raise ValueError("File is too small")
    magic, payload = data[:4], data[4:]
    magics_z = {z for z, _ in _MAGICS.values()}
    magics_r = {r for _, r in _MAGICS.values()}
    if magic in magics_z:
        try:
            payload = zlib.decompress(payload)
        except zlib.error as e:
            raise ValueError(f"Corrupt compressed payload: {e}") from e
    elif magic not in magics_r:
        raise ValueError(f"File has invalid header [{magic!r}]")
    try:
        return deserialize(payload)
    except (struct.error, IndexError) as e:
        # Truncated payloads otherwise escape as raw struct errors,
        # breaking this function's ValueError contract.
        raise ValueError(f"Corrupt payload: {e}") from e


def save_to_file(m, filepath: str, compress: bool = True):
    with open(filepath, "wb") as f:
        f.write(to_file_bytes(m, compress))


def load_from_file(filepath: str):
    with open(filepath, "rb") as f:
        return from_file_bytes(f.read())
