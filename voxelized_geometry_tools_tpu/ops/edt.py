"""Exact 3-D Euclidean distance transform + signed-distance-field generation.

Accelerator redesign of the reference's Felzenszwalb–Huttenlocher EDT
pipeline (signed_distance_field_generation.cpp:85-391 and
signed_distance_field_generation.hpp:40-285 of the reference).

The reference runs a *sequential* 1-D lower-envelope scan per grid line and
parallelizes across lines with OpenMP. Here the math is reformulated so
that every pass is data-parallel over all grid lines at once:

* **Pass 1** (seed field is binary ``{0, +inf}``): the 1-D transform reduces to
  squared distance-to-nearest-seed, computed exactly with two ``cummax``
  prefix scans — O(n), fully vectorized over all grid lines at once.
* **Passes 2 and 3** (general ``f``): ``d[q] = min_k (q-k)^2 + f[k]`` is
  evaluated as a blocked min-plus reduction over ``k`` tiles
  (``backend="xla"``): O(n^2) work per line, every op a full-grid
  elementwise op or reduction. ``backend="triton"`` runs the best-first
  kernel of :mod:`..kernels.edt_triton`, which skips chunks that provably
  cannot improve a tile; ``backend="auto"`` picks it on a GPU.

Both formulations are *exact*: all intermediate values are squared integer
distances, exactly representable in f32 up to 2^24 (grids beyond ~2300^3
per-axis would need f64/i32 — far past any practical dense grid).

Results match the reference to full float precision on its golden fixtures
(sdf_generation_test.cpp: Linear/Planar/Cube exact tests, degenerate
full/empty grids, center/corner/face obstacles).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.grid import GridSpec
from ..core.maps import SignedDistanceField

Array = jnp.ndarray

_INF = jnp.inf


def _binary_squared_dist_last(seed: Array) -> Array:
    """Squared distance (in voxels) to the nearest True along the last axis.

    Exact equivalent of the first F-H pass when the input field is the seeded
    ``{0, +inf}`` indicator (signed_distance_field_generation.hpp:57-74).
    Lines with no seed return ``+inf``.
    """
    n = seed.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)

    def one_sided(s):
        marked = jnp.where(s, idx, jnp.int32(-1))
        last = lax.cummax(marked, axis=s.ndim - 1)
        delta = (idx - last).astype(jnp.float32)
        return jnp.where(last >= 0, delta * delta, _INF)

    d_left = one_sided(seed)
    d_right = jnp.flip(one_sided(jnp.flip(seed, axis=-1)), axis=-1)
    return jnp.minimum(d_left, d_right)


def _parabolic_envelope_last(f: Array, block: int = 512) -> Array:
    """Exact 1-D squared-distance transform along the last axis.

    Computes ``d[q] = min_k (q-k)^2 + f[k]`` (Felzenszwalb & Huttenlocher
    2012, as in signed_distance_field_generation.cpp:124-226) as a blocked
    min-plus reduction. ``k`` is processed in tiles of ``block`` so each scan
    step is one large fused reduction over the whole grid; the default
    covers a whole 512-voxel line per step (block size not measured on the
    H100).
    """
    n = f.shape[-1]
    q = jnp.arange(n, dtype=jnp.float32)

    pad = (-n) % block
    f_padded = jnp.pad(f, [(0, 0)] * (f.ndim - 1) + [(0, pad)],
                       constant_values=_INF)
    num_blocks = (n + pad) // block
    # [num_blocks, block] k values.
    k_blocks = (jnp.arange(num_blocks, dtype=jnp.float32)[:, None] * block
                + jnp.arange(block, dtype=jnp.float32)[None, :])

    def body(d, blk):
        k_vals, start = blk
        fk = lax.dynamic_slice_in_dim(f_padded, start, block, axis=-1)
        # cand[..., q, kb] = (q - k)^2 + f[k]
        delta = q[:, None] - k_vals[None, :]
        cand = delta * delta + fk[..., None, :]
        return jnp.minimum(d, jnp.min(cand, axis=-1)), None

    # Derive the initial carry from ``f`` (not a bare constant) so its
    # varying-manual-axes match the body output under shard_map.
    d0 = jnp.where(jnp.zeros(f.shape, dtype=bool), f[..., :n], _INF)
    starts = jnp.arange(num_blocks, dtype=jnp.int32) * block
    d, _ = lax.scan(body, d0, (k_blocks, starts))
    return d


def _resolve_edt_backend(backend: str) -> str:
    """``auto`` picks the Triton kernel (:mod:`..kernels.edt_triton`) when
    the process's default device is a GPU, the XLA min-plus everywhere else
    (CPU tests, virtual meshes). It keys off the process default and not the
    lowering target: pass ``backend="xla"`` when lowering for the CPU from a
    GPU host."""
    if backend not in ("auto", "xla", "triton"):
        raise ValueError(f"Unknown EDT backend {backend!r}")
    if backend != "auto":
        return backend
    return "triton" if jax.default_backend() == "gpu" else "xla"


def _envelope_axis(f: Array, axis: int, block: int, backend: str) -> Array:
    """Envelope pass along ``axis`` of ``f`` with the chosen backend."""
    if _resolve_edt_backend(backend) == "triton":
        from ..kernels import edt_triton
        return edt_triton.envelope_along_axis(f, axis)
    return jnp.moveaxis(
        _parabolic_envelope_last(jnp.moveaxis(f, axis, -1), block), -1, axis)


def squared_edt(seed: Array, block: int = 512,
                backend: str = "auto") -> Array:
    """Exact squared Euclidean distance (voxel units) to nearest True voxel.

    Equivalent of seeding ``{0, +inf}`` and running
    ``ComputeDistanceFieldTransformInPlace`` along X, Y, Z
    (signed_distance_field_generation.cpp:258-391). Separable-exactness makes
    the axis order irrelevant. Returns ``+inf`` everywhere if no seed is set.

    ``backend`` selects the envelope-pass implementation: ``"xla"`` (fused
    min-plus), ``"triton"`` (the GPU kernel in :mod:`..kernels.edt_triton`)
    or ``"auto"`` (the kernel on a GPU, XLA otherwise) — all exact,
    mirroring the reference's interchangeable device backends.
    """
    seed = jnp.asarray(seed, dtype=bool)
    # Axis 0 (binary fast path).
    d = jnp.moveaxis(_binary_squared_dist_last(jnp.moveaxis(seed, 0, -1)),
                     -1, 0)
    for axis in (1, 2):
        if seed.shape[axis] > 1:
            d = _envelope_axis(d, axis, block, backend)
    return d


def signed_distance_from_filled_mask(is_filled: Array, resolution: float,
                                     block: int = 512,
                                     dtype=jnp.float32,
                                     backend: str = "auto") -> Array:
    """Two-field signed combine: ``sqrt(d2_filled) - sqrt(d2_free)`` scaled by
    resolution (signed_distance_field_generation.hpp:85-108). Negative inside
    filled space, positive outside; ``+/-inf`` for fully empty/filled grids.

    The squared axis transforms are integer-exact in float32 up to 2048-voxel
    axes (3 * 2048^2 < 2^24), so the requested ``dtype`` (float / double —
    the reference's two instantiations) only needs to govern the final
    sqrt/scale combine."""
    is_filled = jnp.asarray(is_filled, dtype=bool)
    # Both fields ride ONE envelope pass per axis: the passes treat grid
    # lines independently, so stacking the filled- and free-seeded fields
    # along axis 0 (after the per-field binary axis-0 pass) halves the
    # number of envelope invocations and doubles the line count each kernel
    # call amortizes over.
    d_f = jnp.moveaxis(_binary_squared_dist_last(
        jnp.moveaxis(is_filled, 0, -1)), -1, 0)
    d_e = jnp.moveaxis(_binary_squared_dist_last(
        jnp.moveaxis(~is_filled, 0, -1)), -1, 0)
    d = jnp.concatenate([d_f, d_e], axis=0)
    for axis in (1, 2):
        if is_filled.shape[axis] > 1:
            d = _envelope_axis(d, axis, block, backend)
    nx = is_filled.shape[0]
    d2_filled = d[:nx].astype(dtype)
    d2_free = d[nx:].astype(dtype)
    res = jnp.asarray(resolution, dtype)
    return jnp.sqrt(d2_filled) * res - jnp.sqrt(d2_free) * res


def _largest_divisor_at_most(n: int, target: int) -> int:
    for s in range(min(int(target), int(n)), 0, -1):
        if n % s == 0:
            return s
    return 1


def _slab_schedule(n: int, target: int):
    """``(slab, pad)`` with ``slab <= target`` and ``(n + pad) % slab == 0``.

    Prefers an exact divisor near the target; for divisor-poor dimensions
    (primes) it PADS instead of degrading to slab=1 (which would serialize
    the pass n-fold). Overlapping slabs are NOT an option: the
    envelope is not idempotent — re-enveloping a line inf-convolves the
    parabola kernel twice and shrinks distances. Padded lines are
    independent of real ones (the slab axis is perpendicular to the pass
    axis), so their values never mix."""
    n, target = int(n), max(1, min(int(target), int(n)))
    s = _largest_divisor_at_most(n, target)
    if s >= max(1, target // 2):
        return s, 0
    return target, (-n) % target


def _streamed_slab_axis(shape, pass_axis: int) -> int:
    """Largest axis perpendicular to the pass axis — slabbing a small
    perpendicular axis would degenerate to one whole-grid slab and forfeit
    the bounded-memory guarantee on anisotropic grids."""
    return max((a for a in range(3) if a != pass_axis),
               key=lambda a: shape[a])


def _streamed_binary_axis0(seed: Array, slab_target: int) -> Array:
    """Axis-0 binary pass streamed in slabs (transients slab-sized)."""
    s_ax = _streamed_slab_axis(seed.shape, 0)
    n_s = seed.shape[s_ax]
    slab, pad = _slab_schedule(n_s, slab_target)
    src = seed
    if pad:
        cfg = [(0, 0)] * 3
        cfg[s_ax] = (0, pad)
        src = jnp.pad(seed, cfg)

    def body(i, acc):
        start = i * slab
        sl = lax.dynamic_slice_in_dim(src, start, slab, axis=s_ax)
        d = jnp.moveaxis(_binary_squared_dist_last(
            jnp.moveaxis(sl, 0, -1)), -1, 0)
        return lax.dynamic_update_slice_in_dim(acc, d, start, axis=s_ax)

    out = jnp.zeros(src.shape, jnp.float32)
    out = lax.fori_loop(0, (n_s + pad) // slab, body, out)
    return lax.slice_in_dim(out, 0, n_s, axis=s_ax) if pad else out


def _streamed_envelope_axis(d: Array, axis: int, slab_target: int,
                            block: int, backend: str) -> Array:
    """Envelope along ``axis`` streamed in slabs over a perpendicular axis.

    The dense path's whole-grid ``moveaxis`` + envelope materializes 2-3
    full-grid copies at once; here each fori_loop iteration slices one slab,
    envelopes it, and writes it back in place (XLA aliases loop carries), so
    peak memory is ONE full grid plus a slab. Identical per-line math ->
    bit-identical results."""
    s_ax = _streamed_slab_axis(d.shape, axis)
    n_s = d.shape[s_ax]
    slab, pad = _slab_schedule(n_s, slab_target)
    if pad:
        cfg = [(0, 0)] * 3
        cfg[s_ax] = (0, pad)
        d = jnp.pad(d, cfg)

    def body(i, acc):
        start = i * slab
        sl = lax.dynamic_slice_in_dim(acc, start, slab, axis=s_ax)
        sl = _envelope_axis(sl, axis, block, backend)
        return lax.dynamic_update_slice_in_dim(acc, sl, start, axis=s_ax)

    d = lax.fori_loop(0, (n_s + pad) // slab, body, d)
    return lax.slice_in_dim(d, 0, n_s, axis=s_ax) if pad else d


def squared_edt_streamed(seed: Array, slab: int = 128, block: int = 512,
                         backend: str = "auto") -> Array:
    """Exact squared EDT with slab-bounded transients — the single-device
    answer to grids whose dense pipeline exhausts device memory (the
    reference's answer to oversized grids is the chunked DSH map,
    dynamic_spatial_hashed_occupancy_map.hpp:18-115 — ours is streaming on
    one device or Z-slab sharding across devices).
    Bit-identical to :func:`squared_edt`."""
    seed = jnp.asarray(seed, dtype=bool)
    d = _streamed_binary_axis0(seed, slab)
    if seed.shape[1] > 1:
        d = _streamed_envelope_axis(d, 1, slab, block, backend)
    if seed.shape[2] > 1:
        d = _streamed_envelope_axis(d, 2, slab, block, backend)
    return d


def signed_distance_from_filled_mask_streamed(
        is_filled: Array, resolution: float, slab: int = 128,
        block: int = 512, dtype=jnp.float32,
        backend: str = "auto") -> Array:
    """Two-field signed combine with slab-bounded memory: the fields run
    SEQUENTIALLY (not stacked — stacking doubles resident distance grids)
    and each pass streams slabs, so peak memory is ~2 full f32 grids instead of
    the dense path's ~4. Bit-identical to
    :func:`signed_distance_from_filled_mask` (same per-line envelope math,
    and sqrt/scale are elementwise)."""
    is_filled = jnp.asarray(is_filled, dtype=bool)
    res = jnp.asarray(resolution, dtype)
    out = jnp.sqrt(
        squared_edt_streamed(is_filled, slab, block, backend).astype(dtype)
    ) * res
    d2_free = squared_edt_streamed(~is_filled, slab, block, backend)
    return out - jnp.sqrt(d2_free.astype(dtype)) * res


def _pad_axis_flags(counts: Tuple[int, int, int]):
    """Virtual border is only added along axes with more than one voxel
    (signed_distance_field_generation.hpp:136-147)."""
    return tuple(1 if c > 1 else 0 for c in counts)


def signed_distance_with_virtual_border(is_filled: Array, resolution: float,
                                        block: int = 512,
                                        dtype=jnp.float32,
                                        streaming: bool = False,
                                        backend: str = "auto") -> Array:
    """``AddVirtualBorder`` variant (hpp:115-285): synthesize a 1-voxel border,
    compute a "free" SDF (border filled) and a "filled" SDF (border free) on
    the enlarged grid, crop, and merge."""
    is_filled = jnp.asarray(is_filled, dtype=bool)
    pads = _pad_axis_flags(is_filled.shape)
    pad_cfg = [(p, p) for p in pads]

    free_seeds = jnp.pad(is_filled, pad_cfg, constant_values=True)
    filled_seeds = jnp.pad(is_filled, pad_cfg, constant_values=False)

    if streaming:
        free_sdf = signed_distance_from_filled_mask_streamed(
            free_seeds, resolution, block=block, dtype=dtype,
            backend=backend)
        filled_sdf = signed_distance_from_filled_mask_streamed(
            filled_seeds, resolution, block=block, dtype=dtype,
            backend=backend)
    else:
        free_sdf = signed_distance_from_filled_mask(
            free_seeds, resolution, block, dtype, backend)
        filled_sdf = signed_distance_from_filled_mask(
            filled_seeds, resolution, block, dtype, backend)
    crop = tuple(slice(p, s - p) for p, s in zip(pads, free_sdf.shape))
    free_sdf = free_sdf[crop]
    filled_sdf = filled_sdf[crop]

    # Merge rule (hpp:265-276) — same rule as the free/named-object merge.
    return merge_free_and_named_object_sdfs(free_sdf, filled_sdf)


def filled_mask_from_occupancy(occupancy: Array,
                               unknown_is_filled: bool = True) -> Array:
    """``is_filled_fn`` for occupancy channels (occupancy_map.hpp:181-205):
    filled iff occupancy > 0.5, or == 0.5 when unknown counts as filled."""
    occ = jnp.asarray(occupancy)
    filled = occ > 0.5
    if unknown_is_filled:
        filled = filled | (occ == 0.5)
    return filled


# Grids whose dense two-field pipeline would crowd device memory stream
# instead. A fixed constant from H100 arithmetic: JAX's default pool is 3/4
# of the card's 80 GB, 60 GB; the dense pipeline peaked at 5.5 GB for 512^3
# (1.34e8 voxels, ~41 B/voxel, measured on an H100), so 1024^3 would take
# ~44 GB and leave too little for a corner table or render beside it.
# 1024^3 streams; 768^3 (~19 GB) stays dense.
_STREAMING_AUTO_VOXELS = 1024 ** 3


@functools.partial(jax.jit, static_argnames=("add_virtual_border", "block",
                                             "dtype", "streaming", "backend"))
def _sdf_values_from_mask(is_filled: Array, resolution: float,
                          add_virtual_border: bool = False,
                          block: int = 512, dtype=jnp.float32,
                          streaming: bool = False,
                          backend: str = "auto") -> Array:
    if add_virtual_border:
        return signed_distance_with_virtual_border(
            is_filled, resolution, block, dtype, streaming=streaming,
            backend=backend)
    if streaming:
        return signed_distance_from_filled_mask_streamed(
            is_filled, resolution, block=block, dtype=dtype, backend=backend)
    return signed_distance_from_filled_mask(is_filled, resolution, block,
                                            dtype, backend)


def extract_signed_distance_field(
        is_filled: Array,
        spec: GridSpec,
        origin_transform,
        frame: str = "",
        oob_value: float = float("inf"),
        add_virtual_border: bool = False,
        block: int = 512,
        dtype=jnp.float32,
        streaming: Optional[bool] = None,
        backend: str = "auto") -> SignedDistanceField:
    """Full SDF-generation entry point over a filled-voxel mask.

    Functional analogue of
    ``signed_distance_field_generation::internal::ExtractSignedDistanceField``
    (hpp:40-285): computes the signed field and returns it *locked* with
    cached min/max. ``unknown_is_filled`` handling lives in the per-map
    wrappers via :func:`filled_mask_from_occupancy`.

    ``streaming`` selects the slab-streamed pipeline (bit-identical, slab-
    bounded transients in device memory); ``None`` enables it
    automatically for grids >= 1024^3 voxels. ``backend`` picks the
    envelope-pass implementation (see :func:`squared_edt`).
    """
    # Fail fast: SignedDistanceField.create would reject a non-uniform spec
    # anyway, but only AFTER the (minutes-long at 1024^3) EDT pipeline has
    # compiled and dispatched.
    spec.enforce_uniform_voxel_size()
    mask = jnp.asarray(is_filled, dtype=bool)
    if streaming is None:
        streaming = spec.num_total >= _STREAMING_AUTO_VOXELS
    values = _sdf_values_from_mask(
        mask, float(spec.resolution),
        add_virtual_border=add_virtual_border, block=block, dtype=dtype,
        streaming=bool(streaming), backend=backend)
    return SignedDistanceField.create(
        spec=spec, distances=values, origin_transform=origin_transform,
        frame=frame, oob_value=oob_value, locked=True, dtype=dtype)


def extract_sdf_from_occupancy(
        occupancy: Array,
        spec: GridSpec,
        origin_transform,
        frame: str = "",
        oob_value: float = float("inf"),
        unknown_is_filled: bool = True,
        add_virtual_border: bool = False,
        block: int = 512,
        dtype=jnp.float32,
        streaming: Optional[bool] = None,
        backend: str = "auto") -> SignedDistanceField:
    """SDF from an occupancy channel (``OccupancyMap::ExtractSignedDistanceField``,
    occupancy_map.hpp:174-210). ``dtype=jnp.float32`` / ``jnp.float64`` are
    the ``ExtractSignedDistanceFieldFloat`` / ``...Double`` variants
    (occupancy_map.cpp:250-262; float64 requires ``jax_enable_x64``)."""
    mask = filled_mask_from_occupancy(occupancy, unknown_is_filled)
    return extract_signed_distance_field(
        mask, spec, origin_transform, frame=frame, oob_value=oob_value,
        add_virtual_border=add_virtual_border, block=block, dtype=dtype,
        streaming=streaming, backend=backend)


def merge_free_and_named_object_sdfs(free_sdf: Array,
                                     named_objects_sdf: Array) -> Array:
    """Combine rule for ``ExtractFreeAndNamedObjectsSignedDistanceField``
    (tagged_object_occupancy_component_map.hpp:510-537)."""
    return jnp.where(free_sdf >= 0.0, free_sdf,
                     jnp.where(named_objects_sdf <= -0.0, named_objects_sdf,
                               0.0))
