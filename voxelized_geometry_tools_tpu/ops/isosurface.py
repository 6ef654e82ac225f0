"""Isosurface extraction: SDF -> triangle mesh (marching tetrahedra).

An accelerator-native *addition* — the reference rasterizes meshes INTO voxel grids
(/root/reference/src/voxelized_geometry_tools/mesh_rasterizer.cpp) and
exports voxel CUBE_LIST markers for display, but has no way back from a
field to a surface mesh. This module closes the loop: occupancy -> EDT ->
:class:`~..core.maps.SignedDistanceField` -> triangle mesh (for meshed
display, collision geometry export, or downstream CAD/sim tools), the
exact inverse of :mod:`.mesh`'s rasterizer.

Design (accelerator-first):

* **Marching tetrahedra, not marching cubes.** Each lattice cube is split
  into 6 Kuhn tetrahedra sharing the main diagonal; a tet has only 16 sign
  cases with at most 2 triangles, so the whole case analysis is a few
  tiny static tables built in numpy at import — no 256x16 tri-table to
  transcribe, and every branch becomes a vectorized gather over the case
  index. All cubes x 6 tets evaluate as one fused array program per slab.
* **Constant-per-tet gradients fix the winding.** Within a tet the
  interpolant is linear, so its gradient is a constant 3-vector obtained
  from the 4 corner values by a precomputed 3x3 solve (one static inverse
  per tet shape). Triangles are flipped so the face normal aligns with
  the field gradient — outward for an SDF — which sidesteps the classic
  hand-ordered-table winding bugs entirely.
* **Slab streaming + static output capacity.** Grids are processed as a
  ``lax.fori_loop`` over X slabs (two value planes live at a time), each
  slab's triangles scatter-appended at a running offset into a
  caller-sized ``[max_triangles]`` buffer (overflowing triangles are
  dropped via an out-of-range sentinel index; the TRUE count is still
  accumulated so callers can detect overflow and re-run with more
  capacity). Everything is static-shape and jit-compatible.

The vertex lattice is the grid of CELL CENTERS (values live at centers,
grid.py), so the surface spans ``[0.5*res, (n-0.5)*res]`` per axis in grid
frame; ``frame="world"`` applies the SDF origin transform.

Extraction is DIFFERENTIABLE in the field values: crossing positions are
smooth in the corner values (``t = va/(va-vb)``), so vertex-based losses
(mesh-space chamfer, area regularizers, ...) flow gradients back to the
voxel field — validated against finite differences in
tests/test_isosurface.py (case selection is piecewise constant, so the
gradient exists away from sign-change boundaries, like any level-set
parameterization).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core import transforms
from ..core.maps import SignedDistanceField

Array = jnp.ndarray

# --- static case tables (numpy, built once at import) -----------------------

# Cube corner b -> (x, y, z) offset; bit0 = x, bit1 = y, bit2 = z.
_CORNER = np.array([[(b >> 0) & 1, (b >> 1) & 1, (b >> 2) & 1]
                    for b in range(8)], dtype=np.float32)

# Kuhn decomposition: the 6 monotone edge paths 0 -> 7 each span a tet
# (0, p1, p2, 7); together they partition the cube.
_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
    [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]], dtype=np.int32)

# Tet-local edges (pairs of tet-local corner indices 0..3).
_EDGE_CORNERS = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int32)
_EDGE_ID = {tuple(sorted(e)): i for i, e in enumerate(map(tuple,
                                                          _EDGE_CORNERS))}


def _build_case_tables():
    """mask (4 inside-bits) -> triangle count + up to 2 triangles of tet-edge
    ids. Winding is NOT encoded here — it is fixed numerically against the
    tet's constant gradient (see module docstring)."""
    ntris = np.zeros(16, dtype=np.int32)
    tri_edges = np.zeros((16, 2, 3), dtype=np.int32)
    for mask in range(16):
        inside = [i for i in range(4) if (mask >> i) & 1]
        outside = [i for i in range(4) if i not in inside]
        if len(inside) in (0, 4):
            continue
        if len(inside) == 1 or len(inside) == 3:
            apex = inside[0] if len(inside) == 1 else outside[0]
            others = [i for i in range(4) if i != apex]
            ntris[mask] = 1
            tri_edges[mask, 0] = [_EDGE_ID[tuple(sorted((apex, o)))]
                                  for o in others]
        else:  # 2 in / 2 out: quad -> 2 triangles
            i, j = inside
            k, l = outside
            e_ik = _EDGE_ID[tuple(sorted((i, k)))]
            e_il = _EDGE_ID[tuple(sorted((i, l)))]
            e_jk = _EDGE_ID[tuple(sorted((j, k)))]
            e_jl = _EDGE_ID[tuple(sorted((j, l)))]
            ntris[mask] = 2
            tri_edges[mask, 0] = [e_ik, e_il, e_jl]
            tri_edges[mask, 1] = [e_ik, e_jl, e_jk]
    return ntris, tri_edges


_NTRIS, _TRI_EDGES = _build_case_tables()

# Per-tet-shape gradient solve: for tet corners p0..p3 (voxel units), the
# linear interpolant's gradient g solves  [p1-p0; p2-p0; p3-p0] g = dv.
_GRAD_MINV = np.stack([
    np.linalg.inv(_CORNER[_TETS[t, 1:]] - _CORNER[_TETS[t, 0]])
    for t in range(6)])  # [6, 3, 3]


class IsoMesh(NamedTuple):
    """Fixed-capacity triangle soup (grid or world frame).

    ``num_triangles`` is the TRUE extraction count; when it exceeds the
    capacity, the buffer holds the first ``capacity`` triangles and
    ``overflowed`` is True — re-run with a larger ``max_triangles``.

    ``shard_counts`` (set by the sharded extractor) carries per-shard true
    counts: with per-shard compaction a SINGLE shard can drop triangles
    while the aggregate total stays under capacity, so ``overflowed``
    checks each shard against its own slice of the buffer rather than the
    total — the weld/statistics truncation guards then work unchanged on
    sharded meshes.
    """
    vertices: Array  # [max_triangles, 3, 3] f32 — triangle corners
    valid: Array  # [max_triangles] bool
    num_triangles: Array  # i32 scalar, true count (may exceed capacity)
    shard_counts: Optional[Array] = None  # i32 [n_shards] true counts

    @property
    def capacity(self) -> int:
        return self.vertices.shape[0]

    @property
    def overflowed(self) -> Array:
        if self.shard_counts is not None:
            per_shard = self.capacity // self.shard_counts.shape[0]
            return jnp.any(self.shard_counts > per_shard)
        return self.num_triangles > self.capacity


def winding_gradient(grad_minv: Array, dv: Array) -> Array:
    """Per-tet field gradient ``grad_minv @ dv`` (``[6, 3, 3]`` by
    ``[6, 3, cy, cz]``). At default precision the GPU runs this batched
    float32 product as TF32 (relative error ~5e-4, measured on an H100),
    so it asks for full float32."""
    return jnp.einsum("tij,tjyz->tiyz", grad_minv, dv,
                      precision=lax.Precision.HIGHEST)


def _extract_planes(d: Array, n_slabs: int, n_valid_slabs, x_base,
                    res, cap: int):
    """Core slab sweep over ``d`` ([>= n_slabs+1, ny, nz] value planes).

    ``n_slabs`` is the static loop bound; slabs with index >=
    ``n_valid_slabs`` (traced) emit nothing — how a sharded caller masks
    the final halo cube of the last shard. ``x_base`` (traced float) shifts
    the absolute X coordinate for shard-local plane arrays. Returns
    ``(verts [cap, 3, 3], valid [cap], count)``; per-triangle values are
    bitwise-identical for any slab partitioning of the same grid.
    """
    _, ny, nz = d.shape
    cy, cz = ny - 1, nz - 1
    res = jnp.float32(res)

    corner = jnp.asarray(_CORNER)          # [8, 3]
    tets = jnp.asarray(_TETS)              # [6, 4]
    edge_corners = jnp.asarray(_EDGE_CORNERS)  # [6, 2]
    ntris_tab = jnp.asarray(_NTRIS)        # [16]
    tri_edges_tab = jnp.asarray(_TRI_EDGES)  # [16, 2, 3]
    grad_minv = jnp.asarray(_GRAD_MINV)    # [6, 3, 3]

    # Tet corner positions in voxel units, relative to the cube origin.
    tet_pos = corner[tets]                 # [6, 4, 3]
    # Edge endpoint positions/indices per (tet, edge).
    ea = edge_corners[:, 0]                # [6]
    eb = edge_corners[:, 1]
    pa = tet_pos[:, ea]                    # [6 tet, 6 edge, 3]
    pb = tet_pos[:, eb]

    m = cy * cz * 6 * 2  # candidate triangles per slab
    cap = int(cap)

    def slab(i, carry):
        verts_out, valid_out, offset = carry
        planes = lax.dynamic_slice_in_dim(d, i, 2, axis=0)  # [2, ny, nz]
        # Cube corner values for this slab: [8, cy, cz] (corner offsets are
        # static Python ints, so these are cheap static slices).
        vals8 = jnp.stack([
            planes[int(c[0]), int(c[1]):int(c[1]) + cy,
                   int(c[2]):int(c[2]) + cz]
            for c in _CORNER.astype(np.int32)])
        tv = vals8[tets]                   # [6, 4, cy, cz]
        inside = (tv < 0.0).astype(jnp.int32)
        mask = (inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
                + 8 * inside[:, 3])       # [6, cy, cz]
        # Suppress tets touching non-finite values (+-inf oob padding /
        # NaN): an inf endpoint makes t = inf/inf = NaN and the emitted
        # triangle would be garbage marked valid. Zeroing the case index
        # emits nothing there — the conservative reading of "no surface
        # through unobserved cells".
        mask = jnp.where(jnp.isfinite(tv).all(axis=1), mask, 0)

        # Edge crossing points for every (tet, edge): linear interpolation
        # between the endpoint values. Non-crossing edges produce garbage
        # positions that the case table never selects.
        va = tv[:, ea.ravel()].reshape(6, 6, cy, cz)
        vb = tv[:, eb.ravel()].reshape(6, 6, cy, cz)
        den = va - vb
        t = va / jnp.where(jnp.abs(den) < 1e-30, jnp.float32(1e-30), den)
        t = jnp.clip(t, 0.0, 1.0)
        # [6 tet, 6 edge, cy, cz, 3]
        pcross = (pa[:, :, None, None, :]
                  + t[..., None] * (pb - pa)[:, :, None, None, :])

        # Select the (up to 2) triangles per tet by case index.
        ntris = ntris_tab[mask]            # [6, cy, cz]
        eids = tri_edges_tab[mask]         # [6, cy, cz, 2, 3]
        # Gather triangle vertices from pcross along the edge axis.
        pc = jnp.moveaxis(pcross, 1, -2)   # [6, cy, cz, 6, 3]
        tri = jnp.take_along_axis(
            pc[:, :, :, None, :, :],
            eids[..., None].astype(jnp.int32),  # [6, cy, cz, 2, 3, 1]
            axis=-2)                       # [6, cy, cz, 2, 3, 3]

        # Winding: flip so the face normal aligns with the tet's constant
        # field gradient (outward for an SDF: d increases off the surface).
        dv = (tv[:, 1:] - tv[:, :1])       # [6, 3, cy, cz]
        g = winding_gradient(grad_minv, dv)              # [6, 3, cy, cz]
        g = jnp.moveaxis(g, 1, -1)[:, :, :, None, :]     # [6, cy, cz, 1, 3]
        n = jnp.cross(tri[..., 1, :] - tri[..., 0, :],
                      tri[..., 2, :] - tri[..., 0, :])   # [6, cy, cz, 2, 3]
        flip = jnp.sum(n * g, axis=-1) < 0.0             # [6, cy, cz, 2]
        tri = jnp.where(flip[..., None, None],
                        tri[..., (0, 2, 1), :], tri)

        # Shift to absolute grid-frame coordinates (cell centers at
        # (idx + 0.5) * res; cube origin = (i, j, k)).
        jj = jnp.arange(cy, dtype=jnp.float32)
        kk = jnp.arange(cz, dtype=jnp.float32)
        org = jnp.stack(jnp.broadcast_arrays(
            jnp.asarray(x_base, jnp.float32) + i.astype(jnp.float32),
            jj[:, None], kk[None, :]), axis=-1)  # [cy, cz, 3]
        tri = (tri + org[None, :, :, None, None, :]
               + jnp.float32(0.5)) * res

        # Append valid triangles at the running offset.
        slot = jnp.arange(2, dtype=jnp.int32)
        tvalid = slot[None, None, None, :] < ntris[..., None]  # [6,cy,cz,2]
        tvalid = tvalid & (i < jnp.asarray(n_valid_slabs, jnp.int32))
        tvf = tvalid.reshape(m)
        trif = tri.reshape(m, 3, 3)
        pos = offset + jnp.cumsum(tvf.astype(jnp.int32)) - tvf
        write = tvf & (pos < cap)
        idx = jnp.where(write, pos, cap)  # cap = drop sentinel row
        verts_out = verts_out.at[idx].set(trif, mode="drop")
        valid_out = valid_out.at[idx].set(tvf, mode="drop")
        return verts_out, valid_out, offset + jnp.sum(tvf, dtype=jnp.int32)

    # Derive the init carry from the inputs so its varying manual axes
    # match the body outputs under shard_map (same pattern as
    # render.march_while). The finiteness guard keeps the zero a ZERO when
    # the first voxel is +-inf/NaN (inf * 0 = NaN would poison every
    # unwritten buffer row).
    x0 = d.reshape(-1)[0]
    z = jnp.where(jnp.isfinite(x0), x0, 0.0) * 0.0
    verts0 = jnp.zeros((cap + 1, 3, 3), jnp.float32) + z
    valid0 = (jnp.zeros((cap + 1,), jnp.float32) + z) > 0.0
    count0 = jnp.int32(0) + jnp.asarray(n_valid_slabs, jnp.int32) * 0
    verts, valid, count = lax.fori_loop(
        0, n_slabs, slab, (verts0, valid0, count0))
    return verts[:cap], valid[:cap], count


def _validated_field(sdf: SignedDistanceField, level, frame: str) -> Array:
    """Shared prologue of the single-device and sharded extractors: frame
    validation, uniform-voxel enforcement, level shift."""
    if frame not in ("world", "grid"):
        raise ValueError(f"frame must be 'world' or 'grid', got {frame!r}")
    spec = sdf.spec
    spec.enforce_uniform_voxel_size()
    nx, ny, nz = spec.shape
    if min(nx, ny, nz) < 2:
        raise ValueError("isosurface extraction needs >= 2 voxels per axis")
    return sdf.distances.astype(jnp.float32) - jnp.float32(level)


def _verts_to_frame(verts: Array, sdf: SignedDistanceField,
                    frame: str) -> Array:
    """Shared epilogue: apply the origin transform for ``frame="world"``."""
    if frame == "world":
        flat = verts.reshape(-1, 3)
        flat = transforms.apply_isometry(sdf.origin_transform, flat)
        verts = flat.reshape(-1, 3, 3)
    return verts


def extract_isosurface(sdf: SignedDistanceField, level: float = 0.0,
                       max_triangles: int = 1 << 18,
                       frame: str = "world") -> IsoMesh:
    """Extract the ``distance == level`` surface as a triangle mesh.

    ``frame`` is ``"world"`` (apply the SDF origin transform) or ``"grid"``.
    Jit-compatible (``max_triangles``/``level``/``frame`` static). A cell
    is "inside" iff ``distance - level < 0``; tets touching NaN/inf cells
    (e.g. the +inf oob padding of partially observed fields) emit NOTHING —
    their case index is forced to the empty case, so unobserved regions
    produce neither fabricated walls nor NaN vertices.
    """
    d = _validated_field(sdf, level, frame)
    cx = sdf.spec.num_x - 1
    verts, valid, count = _extract_planes(
        d, cx, cx, 0.0, sdf.spec.resolution, int(max_triangles))
    verts = _verts_to_frame(verts, sdf, frame)
    return IsoMesh(vertices=verts, valid=valid, num_triangles=count)


def weld_vertices(iso_mesh: IsoMesh, tolerance: float = 1e-6):
    """Host-side: collapse the triangle soup into an indexed mesh.

    Marching tetrahedra emits each crossing point once per incident
    triangle; welding by position (quantized to ``tolerance``) recovers the
    shared-vertex mesh downstream tools expect. Returns
    ``(vertices [V, 3] f64, faces [F, 3] i64)`` with degenerate faces
    (repeated welded indices — the zero-area slivers marching tets can
    emit when a crossing lands on a lattice vertex) dropped.

    Raises on an overflowed (truncated) mesh: welding a partial soup would
    silently produce a holed surface — re-extract with more capacity.
    (Sharded meshes: a single shard can drop triangles while the aggregate
    ``overflowed`` stays False — check the returned ``shard_counts``
    against the per-shard capacity first.)
    """
    if bool(iso_mesh.overflowed):
        raise ValueError(
            f"IsoMesh overflowed its capacity ({int(iso_mesh.num_triangles)}"
            f" > {iso_mesh.capacity}) — re-extract with more max_triangles")
    v = np.asarray(iso_mesh.vertices)[np.asarray(iso_mesh.valid)]
    if v.size == 0:
        return np.zeros((0, 3), np.float64), np.zeros((0, 3), np.int64)
    flat = v.reshape(-1, 3).astype(np.float64)
    keys = np.round(flat / float(tolerance)).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    # Average the original (unquantized) coordinates per welded vertex.
    counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    verts = np.zeros((len(uniq), 3), np.float64)
    for a in range(3):
        verts[:, a] = np.bincount(inverse, weights=flat[:, a],
                                  minlength=len(uniq)) / counts
    faces = inverse.reshape(-1, 3).astype(np.int64)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def save_obj(path, iso_mesh: IsoMesh, tolerance: float = 1e-6) -> int:
    """Write the extracted surface as a Wavefront OBJ file (welded,
    1-indexed). Returns the number of faces written."""
    verts, faces = weld_vertices(iso_mesh, tolerance)
    with open(path, "w") as f:
        f.write("# voxelized_geometry_tools_tpu isosurface\n")
        for p in verts:
            f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
    return len(faces)


def extract_object_meshes(omap, level: float = 0.0,
                          max_triangles: int = 1 << 16,
                          frame: str = "world", **sdf_kwargs):
    """One watertight mesh per tagged object: each object id present in
    ``omap`` (a TaggedObjectOccupancy[Component]Map) gets its own SDF
    (``map_ops.make_all_object_sdfs``,
    tagged_object_occupancy_component_map.hpp:426-452) and its zero level
    set extracted. Returns ``{object_id: IsoMesh}`` — the meshed
    counterpart of the reference's per-object-color voxel display.
    """
    from . import map_ops
    sdfs = map_ops.make_all_object_sdfs(omap, **sdf_kwargs)
    return {oid: extract_isosurface(s, level=level,
                                    max_triangles=max_triangles,
                                    frame=frame)
            for oid, s in sdfs.items()}


def mesh_statistics(iso_mesh: IsoMesh):
    """Host-side surface area and enclosed volume of the extracted mesh.

    Area is the summed triangle areas; volume uses the divergence theorem
    (sum of signed origin-apex tetrahedron volumes — exact for any closed
    mesh with outward winding, which the gradient-aligned flip guarantees
    for SDF level sets). Returns ``(area, volume)`` floats. Raises on an
    overflowed mesh (a truncated shell has no meaningful volume).
    """
    if bool(iso_mesh.overflowed):
        raise ValueError(
            f"IsoMesh overflowed its capacity ({int(iso_mesh.num_triangles)}"
            f" > {iso_mesh.capacity}) — re-extract with more max_triangles")
    v = np.asarray(iso_mesh.vertices)[np.asarray(iso_mesh.valid)]
    if v.size == 0:
        return 0.0, 0.0
    v = v.astype(np.float64)
    cr = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    area = 0.5 * float(np.linalg.norm(cr, axis=-1).sum())
    volume = float(np.einsum("ij,ij->i", v[:, 0],
                             np.cross(v[:, 1], v[:, 2])).sum()) / 6.0
    return area, volume
