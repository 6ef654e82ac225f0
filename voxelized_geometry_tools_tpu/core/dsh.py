"""Dynamic spatial-hashed (chunked sparse) occupancy map.

Accelerator-native redesign of the reference's ``DynamicSpatialHashedOccupancyMap``
(/root/reference/include/voxelized_geometry_tools/
dynamic_spatial_hashed_occupancy_map.hpp:18-115) and the chunked-grid base it
inherits from the external ``common_robotics_utilities``
``DynamicSpatialHashedVoxelGridBase`` (interface surface per SURVEY.md §2.12b:
``ChunkVoxelCounts``, cell/chunk fill granularity, chunk keeper iteration,
``GetLocationImmutable``/``SetLocation`` with fill status, serialization with
``expected_chunks``).

Design split, accelerator-first:

* **Host side** (this class): dynamic chunk allocation is inherently
  data-dependent, so mutation lives on the host — a dict of
  ``chunk_region -> numpy chunk`` exactly like the reference's unordered-map
  chunk keeper. Chunks are allocated on first write at either CHUNK or CELL
  granularity (``DSHVGFillStatus`` semantics).
* **Device side**: :meth:`pack` freezes the current chunk set into a
  :class:`PackedDSHMap` pytree — stacked chunk data + an open-addressing hash
  table over chunk regions — whose :func:`packed_get_location` is a pure,
  jit/vmap-able batched query (the device-side equivalent of
  ``GetLocationImmutable``). Structure is static under jit; values are leaves.
"""

from __future__ import annotations

import dataclasses
import enum
import io
import struct
import zlib
from typing import Dict, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import transforms
from .grid import GridSpec
from .maps import FREE, OccupancyMap

Array = jnp.ndarray

ChunkRegion = Tuple[int, int, int]


class FillStatus(enum.IntEnum):
    """Mirrors ``DSHVGFillStatus`` (common_robotics_utilities
    dynamic_spatial_hashed_voxel_grid.hpp, consumed at
    dynamic_spatial_hashed_occupancy_map.hpp:18-21)."""
    NOT_FILLED = 0
    CHUNK_FILLED = 1
    CELL_FILLED = 2


@dataclasses.dataclass(frozen=True)
class DSHGridSizes:
    """Chunked-grid geometry: per-voxel resolution + voxels per chunk
    (``DynamicSpatialHashedVoxelGridSizes``, used at
    dynamic_spatial_hashed_occupancy_map.hpp:78-104)."""
    resolution: float
    chunk_counts: Tuple[int, int, int]

    def __post_init__(self):
        if self.resolution <= 0.0:
            raise ValueError("resolution must be > 0")
        if any(int(c) <= 0 for c in self.chunk_counts):
            raise ValueError("chunk voxel counts must be positive")
        object.__setattr__(self, "chunk_counts",
                           tuple(int(c) for c in self.chunk_counts))
        object.__setattr__(self, "resolution", float(self.resolution))

    @property
    def chunk_sizes(self) -> Tuple[float, float, float]:
        return tuple(c * self.resolution for c in self.chunk_counts)

    @property
    def voxels_per_chunk(self) -> int:
        cx, cy, cz = self.chunk_counts
        return cx * cy * cz


class _Chunk:
    """One allocated chunk: either a uniform CHUNK_FILLED value or a dense
    CELL_FILLED array of per-voxel occupancy."""

    __slots__ = ("fill_status", "value", "data")

    def __init__(self, fill_status: FillStatus, value: float = 0.0,
                 data: Optional[np.ndarray] = None):
        self.fill_status = fill_status
        self.value = value
        self.data = data

    def densify(self, counts) -> np.ndarray:
        if self.fill_status == FillStatus.CELL_FILLED:
            return self.data
        return np.full(counts, self.value, dtype=np.float32)


class DynamicSpatialHashedOccupancyMap:
    """Sparse chunked occupancy map with world-frame get/set by location.

    Mutation API (host side) mirrors the reference's
    ``SetLocation``/``GetLocationImmutable``; :meth:`pack` produces the
    device-resident immutable view for batched jitted queries.
    """

    def __init__(self, sizes: DSHGridSizes, default_occupancy: float = FREE,
                 expected_chunks: int = 0, frame: str = "",
                 origin_transform=None):
        self.sizes = sizes
        self.default_occupancy = float(default_occupancy)
        self.frame = frame
        if origin_transform is None:
            origin_transform = np.eye(4, dtype=np.float64)
        self.origin_transform = np.asarray(origin_transform, np.float64)
        self.inverse_origin_transform = np.linalg.inv(self.origin_transform)
        # dict insertion order is stable -> deterministic pack/serialize.
        self._chunks: Dict[ChunkRegion, _Chunk] = {}
        self._expected_chunks = int(expected_chunks)

    # -- geometry -----------------------------------------------------------

    @property
    def resolution(self) -> float:
        return self.sizes.resolution

    @property
    def chunk_counts(self) -> Tuple[int, int, int]:
        """``ChunkVoxelCounts`` (ros_interface.hpp:291)."""
        return self.sizes.chunk_counts

    @property
    def num_chunks(self) -> int:
        return len(self._chunks)

    def _world_to_grid(self, p_world) -> np.ndarray:
        p = np.asarray(p_world, np.float64)[..., :3]
        R = self.inverse_origin_transform
        return p @ R[:3, :3].T + R[:3, 3]

    def _grid_to_indices(self, p_grid) -> Tuple[ChunkRegion, Tuple[int, ...]]:
        res = self.sizes.resolution
        voxel = np.floor(p_grid / res).astype(np.int64)
        counts = np.asarray(self.sizes.chunk_counts, np.int64)
        region = tuple(int(v) for v in np.floor_divide(voxel, counts))
        local = tuple(int(v) for v in voxel - np.asarray(region) * counts)
        return region, local

    def chunk_region_of(self, p_world) -> ChunkRegion:
        region, _ = self._grid_to_indices(self._world_to_grid(p_world))
        return region

    def chunk_items(self) -> Iterator[Tuple[ChunkRegion, np.ndarray]]:
        """Iterate ``(chunk_region, dense chunk occupancy)`` — the analogue of
        walking ``GetImmutableInternalChunkKeeper`` (ros_interface.hpp:
        292-298)."""
        for region, chunk in self._chunks.items():
            arr = chunk.densify(self.sizes.chunk_counts)
            if chunk.fill_status == FillStatus.CELL_FILLED:
                arr = arr.copy()  # densify returns the LIVE storage here
            yield region, arr

    # -- get / set ----------------------------------------------------------

    def get_location(self, p_world) -> Tuple[float, FillStatus]:
        """Occupancy + fill status at a world location
        (``GetLocationImmutable`` semantics: NOT_FILLED where no chunk)."""
        region, local = self._grid_to_indices(self._world_to_grid(p_world))
        chunk = self._chunks.get(region)
        if chunk is None:
            return self.default_occupancy, FillStatus.NOT_FILLED
        if chunk.fill_status == FillStatus.CHUNK_FILLED:
            return float(chunk.value), FillStatus.CHUNK_FILLED
        return float(chunk.data[local]), FillStatus.CELL_FILLED

    def set_location(self, p_world, occupancy: float,
                     grain: FillStatus = FillStatus.CELL_FILLED):
        """Write occupancy at a world location, allocating the containing
        chunk on demand (``SetLocation`` with cell/chunk granularity).

        CHUNK grain overwrites the whole chunk with a uniform value; CELL
        grain densifies a CHUNK_FILLED chunk first (the reference's
        chunk-splitting behavior on mixed-granularity writes)."""
        if grain == FillStatus.NOT_FILLED:
            raise ValueError("grain must be CHUNK_FILLED or CELL_FILLED")
        region, local = self._grid_to_indices(self._world_to_grid(p_world))
        chunk = self._chunks.get(region)
        if grain == FillStatus.CHUNK_FILLED:
            # Quantize to f32 like CELL writes (and like the serialized
            # form), so get_location is identical across a save/load
            # round trip.
            self._chunks[region] = _Chunk(FillStatus.CHUNK_FILLED,
                                          value=float(np.float32(occupancy)))
            return
        if chunk is None:
            data = np.full(self.sizes.chunk_counts, self.default_occupancy,
                           dtype=np.float32)
            chunk = _Chunk(FillStatus.CELL_FILLED, data=data)
            self._chunks[region] = chunk
        elif chunk.fill_status == FillStatus.CHUNK_FILLED:
            chunk = _Chunk(FillStatus.CELL_FILLED,
                           data=chunk.densify(self.sizes.chunk_counts))
            self._chunks[region] = chunk
        chunk.data[local] = float(occupancy)

    # -- conversion ---------------------------------------------------------

    def to_occupancy_map(self, frame: Optional[str] = None) -> OccupancyMap:
        """Densify all chunks into a dense :class:`OccupancyMap` covering the
        allocated AABB (unallocated voxels get the default occupancy)."""
        if not self._chunks:
            raise ValueError("Cannot densify an empty DSH map")
        regions = np.asarray(list(self._chunks.keys()), np.int64)
        lo = regions.min(axis=0)
        hi = regions.max(axis=0) + 1
        counts = np.asarray(self.sizes.chunk_counts, np.int64)
        total = (hi - lo) * counts
        dense = np.full(tuple(int(t) for t in total), self.default_occupancy,
                        dtype=np.float32)
        for region, data in self.chunk_items():
            base = (np.asarray(region) - lo) * counts
            dense[base[0]:base[0] + counts[0],
                  base[1]:base[1] + counts[1],
                  base[2]:base[2] + counts[2]] = data
        # Shift the origin so voxel (0,0,0) of the dense map is the min
        # corner of the lowest allocated chunk.
        offset = lo * counts * self.sizes.resolution
        shift = np.eye(4, dtype=np.float64)
        shift[:3, 3] = offset
        origin = self.origin_transform @ shift
        spec = GridSpec(tuple(int(t) for t in total), self.sizes.resolution)
        return OccupancyMap(
            origin_transform=jnp.asarray(origin, jnp.float32),
            occupancy=jnp.asarray(dense),
            spec=spec, frame=self.frame if frame is None else frame)

    # -- packing for device-side queries -------------------------------------

    def pack(self) -> "PackedDSHMap":
        """Freeze into an immutable device view for jitted batched queries.

        ``expected_chunks`` (constructor) pre-sizes the hash capacity so a
        map packed BEFORE further host-side growth keeps its load factor
        low. Chunk regions must fit int32 (the device probe's key width);
        a map whose regions exceed that — |world coord| beyond
        ~2^31 * chunk extent — is rejected here rather than silently
        mis-hashing on device."""
        n = max(1, len(self._chunks))
        cap = 1
        while cap < 2 * max(n, self._expected_chunks):
            cap *= 2
        keys = np.full((cap, 3), _EMPTY_KEY, np.int32)
        slots = np.full((cap,), -1, np.int32)
        counts = self.sizes.chunk_counts
        data = np.full((n,) + counts, self.default_occupancy, np.float32)
        if self._chunks:
            regions = np.asarray(list(self._chunks.keys()), np.int64)
            # _EMPTY_KEY (INT32_MIN) doubles as the empty sentinel.
            bad = ((np.abs(regions) >= 2 ** 31) |
                   (regions == int(_EMPTY_KEY))).any(axis=1)
            if bad.any():
                raise ValueError(
                    f"chunk region {tuple(regions[bad.argmax()])} exceeds "
                    "the packed table's int32 key range")
            for i, chunk in enumerate(self._chunks.values()):
                data[i] = chunk.densify(counts)
            # Bulk linear-probe insertion (no per-chunk Python/numpy-scalar
            # probe loop). Each round, every unplaced
            # region proposes its current slot; the FIRST proposer (chunk
            # order — np.unique's return_index on the order-preserving
            # pending array) of each still-empty slot wins, the rest step
            # +1. Invariant for probe correctness: an entry only ever steps
            # past slots that are occupied by the end of packing (either
            # already taken or claimed by this round's winner), so no empty
            # slot can sit between any key's home hash and its placement —
            # exactly what the device probe's stop-at-empty rule needs.
            # (Slot ASSIGNMENT among colliding entries may differ from the
            # old one-at-a-time order; the table layout is an internal
            # detail — tests pin probe-vs-host agreement, not layout.)
            h0 = np.zeros(len(regions), np.int64)
            for axis, prime in enumerate(_HASH_PRIMES):
                h0 ^= (regions[:, axis] * prime) % (1 << 32)
            pos = (h0 & 0x7FFFFFFF) % cap
            pending = np.arange(len(regions))
            while pending.size:
                p = pos[pending]
                free = slots[p] < 0
                cand, cand_p = pending[free], p[free]
                uniq, first = np.unique(cand_p, return_index=True)
                winners = cand[first]
                slots[uniq] = winners
                keys[uniq] = regions[winners]
                lost = np.ones(len(regions), bool)
                lost[winners] = False
                pending = pending[lost[pending]]
                pos[pending] = (pos[pending] + 1) % cap
        origin64 = np.asarray(self.origin_transform, np.float64)
        return PackedDSHMap(
            chunk_data=jnp.asarray(data),
            hash_keys=jnp.asarray(keys),
            hash_slots=jnp.asarray(slots),
            origin_transform=jnp.asarray(self.origin_transform, jnp.float32),
            inv_origin_transform=jnp.asarray(np.linalg.inv(origin64),
                                             jnp.float32),
            default_occupancy=jnp.float32(self.default_occupancy),
            sizes=self.sizes, frame=self.frame)

    # -- serialization (DMGZ/DMGR envelope) ----------------------------------

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        buf.write(struct.pack("<II", 1, 6))  # version, kind=DSH
        frame_b = self.frame.encode("utf-8")
        buf.write(struct.pack("<I", len(frame_b)))
        buf.write(frame_b)
        buf.write(struct.pack("<d", self.sizes.resolution))
        buf.write(np.asarray(self.origin_transform, np.float64).tobytes())
        buf.write(struct.pack("<3q", *self.sizes.chunk_counts))
        buf.write(struct.pack("<f", self.default_occupancy))
        buf.write(struct.pack("<q", len(self._chunks)))
        for region, chunk in self._chunks.items():
            buf.write(struct.pack("<3q", *region))
            buf.write(struct.pack("<B", int(chunk.fill_status)))
            if chunk.fill_status == FillStatus.CHUNK_FILLED:
                buf.write(struct.pack("<f", chunk.value))
            else:
                buf.write(np.ascontiguousarray(chunk.data).tobytes())
        return buf.getvalue()

    @staticmethod
    def deserialize(data: bytes) -> "DynamicSpatialHashedOccupancyMap":
        buf = io.BytesIO(data)
        version, kind = struct.unpack("<II", buf.read(8))
        if version != 1 or kind != 6:
            raise ValueError("Not a serialized DSH occupancy map")
        (n_frame,) = struct.unpack("<I", buf.read(4))
        frame = buf.read(n_frame).decode("utf-8")
        (resolution,) = struct.unpack("<d", buf.read(8))
        origin = np.frombuffer(buf.read(128), np.float64).reshape(4, 4)
        chunk_counts = struct.unpack("<3q", buf.read(24))
        (default_occupancy,) = struct.unpack("<f", buf.read(4))
        (n_chunks,) = struct.unpack("<q", buf.read(8))
        sizes = DSHGridSizes(resolution, tuple(int(c) for c in chunk_counts))
        m = DynamicSpatialHashedOccupancyMap(
            sizes, default_occupancy=default_occupancy,
            expected_chunks=n_chunks, frame=frame, origin_transform=origin)
        vpc = sizes.voxels_per_chunk
        for _ in range(n_chunks):
            region = tuple(int(v) for v in struct.unpack("<3q", buf.read(24)))
            (status,) = struct.unpack("<B", buf.read(1))
            status = FillStatus(status)
            if status == FillStatus.CHUNK_FILLED:
                (value,) = struct.unpack("<f", buf.read(4))
                m._chunks[region] = _Chunk(status, value=value)
            else:
                arr = np.frombuffer(buf.read(vpc * 4), np.float32).reshape(
                    sizes.chunk_counts).copy()
                m._chunks[region] = _Chunk(status, data=arr)
        return m

    def to_file_bytes(self, compress: bool = True) -> bytes:
        # One envelope implementation for the whole package: the generic
        # serializer owns the magic/zlib/size-check semantics (kind 6 is
        # routed back to this class's payload codec).
        from . import serialization
        return serialization.to_file_bytes(self, compress)

    @staticmethod
    def from_file_bytes(data: bytes) -> "DynamicSpatialHashedOccupancyMap":
        from . import serialization
        m = serialization.from_file_bytes(data)
        if not isinstance(m, DynamicSpatialHashedOccupancyMap):
            raise ValueError("Not a serialized DSH occupancy map")
        return m

    def save_to_file(self, filepath: str, compress: bool = True):
        with open(filepath, "wb") as f:
            f.write(self.to_file_bytes(compress))

    @staticmethod
    def load_from_file(filepath: str) -> "DynamicSpatialHashedOccupancyMap":
        with open(filepath, "rb") as f:
            return DynamicSpatialHashedOccupancyMap.from_file_bytes(f.read())


_EMPTY_KEY = np.int32(np.iinfo(np.int32).min)
_HASH_PRIMES = (73856093, 19349669, 83492791)


def _hash_region(region, cap: int) -> int:
    """Spatial-hash of a chunk region with explicit 32-bit wraparound, so the
    host insert path and the int32 device probe path agree bit-for-bit."""
    h = 0
    for coord, prime in zip(region, _HASH_PRIMES):
        h ^= (int(coord) * prime) % (1 << 32)
    return (h & 0x7FFFFFFF) % cap


@dataclasses.dataclass(frozen=True)
class PackedDSHMap:
    """Immutable device view of a DSH map: stacked chunks + open-addressing
    hash table over chunk regions. Pytree (structure static under jit)."""

    chunk_data: Array         # f32 [n_chunks, cx, cy, cz]
    hash_keys: Array          # i32 [cap, 3] chunk regions, _EMPTY_KEY = empty
    hash_slots: Array         # i32 [cap] chunk index or -1
    origin_transform: Array   # f32 [4, 4]
    inv_origin_transform: Array  # f32 [4, 4] TRUE inverse (host-computed,
    # so non-rigid origin transforms answer identically to the host path)
    default_occupancy: Array  # f32 scalar
    sizes: DSHGridSizes = dataclasses.field(metadata=dict(static=True))
    frame: str = dataclasses.field(default="", metadata=dict(static=True))

    @property
    def capacity(self) -> int:
        return self.hash_keys.shape[0]


PackedDSHMap = jax.tree_util.register_dataclass(
    PackedDSHMap,
    data_fields=["chunk_data", "hash_keys", "hash_slots", "origin_transform",
                 "inv_origin_transform", "default_occupancy"],
    meta_fields=["sizes", "frame"])


def packed_get_location(packed: PackedDSHMap, p_world) -> Tuple[Array, Array]:
    """Batched jittable ``GetLocationImmutable``: occupancy values and fill
    status codes (:class:`FillStatus` ints; CHUNK vs CELL distinction is not
    represented in the packed view, so any allocated chunk reports
    CELL_FILLED) for world locations ``[..., 3]``."""
    sizes = packed.sizes
    cap = packed.capacity
    p = jnp.asarray(p_world)[..., :3]
    # The TRUE inverse computed at pack time — invert_isometry's R^T
    # shortcut diverges from the host path for non-rigid origin transforms.
    p_grid = transforms.apply_isometry(packed.inv_origin_transform, p)
    res = jnp.float32(sizes.resolution)
    voxel = jnp.floor(p_grid / res).astype(jnp.int32)
    counts = jnp.asarray(sizes.chunk_counts, jnp.int32)
    region = voxel // counts  # floor division (jnp // floors for ints)
    local = voxel - region * counts

    # int32 multiply wraps two's-complement, i.e. exactly mod 2^32 — matching
    # the host-side _hash_region bit-for-bit.
    primes = jnp.asarray(_HASH_PRIMES, jnp.int32)
    terms = region.astype(jnp.int32) * primes
    h0 = ((terms[..., 0] ^ terms[..., 1] ^ terms[..., 2])
          & 0x7FFFFFFF) % cap

    def probe(state):
        h, _, done = state
        key = packed.hash_keys[h]
        empty = key[..., 0] == _EMPTY_KEY
        match = jnp.all(key == region, axis=-1)
        done_now = empty | match
        slot = jnp.where(match, packed.hash_slots[h], -1)
        return h, slot, done_now

    # Linear probing under a while_loop that stops when every query lane has
    # resolved (load factor <= 0.5 keeps expected probes ~1-2, but probe
    # CLUSTERS can be long — e.g. a flat 128x128 slab of chunk regions
    # measures runs of 200+ — so the bound must be the full capacity, not a
    # small constant, or long-cluster chunks silently read as NOT_FILLED).
    def cond(state):
        i, _, _, done = state
        return (i < cap) & jnp.logical_not(jnp.all(done))

    def body(state):
        i, h, slot, done = state
        nh, nslot, ndone = probe((h, slot, done))
        h_next = jnp.where(ndone, nh, (nh + 1) % cap)
        return (i + 1, h_next,
                jnp.where(done, slot, nslot),
                done | ndone)

    h = h0.astype(jnp.int32)
    slot0 = jnp.full(h.shape, -1, jnp.int32)
    done0 = jnp.zeros(h.shape, bool)
    _, _, slot, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), h, slot0, done0))

    found = slot >= 0
    safe_slot = jnp.maximum(slot, 0)
    safe_local = jnp.clip(local, 0, counts - 1)
    values = packed.chunk_data[safe_slot, safe_local[..., 0],
                               safe_local[..., 1], safe_local[..., 2]]
    values = jnp.where(found, values, packed.default_occupancy)
    status = jnp.where(found, jnp.int32(int(FillStatus.CELL_FILLED)),
                       jnp.int32(int(FillStatus.NOT_FILLED)))
    return values, status
