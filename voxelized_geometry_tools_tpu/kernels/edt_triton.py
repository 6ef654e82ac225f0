"""Pallas (Triton route) kernel for the EDT's 1-D parabolic-envelope pass.

Each envelope pass computes ``d[q] = min_k (q - k)^2 + f[k]`` along one grid
axis for every grid line (the Felzenszwalb-Huttenlocher transform of
signed_distance_field_generation.cpp:124-226, evaluated as an exact min-plus
reduction; :func:`..ops.edt._parabolic_envelope_last` is the plain XLA form,
which does all ``n^2`` candidates of every line).

This kernel skips most of that work. The position axis is cut into chunks
of ``_CHUNK`` positions, and one program owns a ``[tile_q, tile_lines]``
output tile. It consumes chunks best-first, in order of the admissible bound
``geom(tile, chunk)^2 + min f[chunk]``, which lower-bounds every candidate of
the chunk for every entry of the tile, and stops once the best remaining
bound cannot improve the tile's worst entry. The result is exact; work adapts
to where the seeds are (chunks of empty space, ``f = +inf``, are never read).

Layout: the array is viewed as ``[batch, n, lines]`` with lines on the minor
axis, so each chunk row ``f[k, l0:l0 + tile_lines]`` is one coalesced load.
A pass along a middle axis needs no transpose; a pass along the last axis
transposes once in and once out. Nothing is staged in shared memory: rows
are read from L2/HBM as the march reaches them. The per-chunk minima are
computed once in XLA and fed in as a second operand.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

Array = jnp.ndarray

_CHUNK = 16
# Tile and warp count from a sweep of the two 512^3 envelope passes on an
# H100 (tile_q 16/32/64 x tile_lines 32/64/128 x 2/4/8 warps; PERF.md):
# two warps won at every tile shape, and [16, 64] was fastest.
TILE_Q = 16
TILE_LINES = 64
NUM_WARPS = 2


def _bestfirst_kernel(f_ref, cmin_ref, out_ref, *, chunk: int):
    """``out[q, l] = min_k (q - k)^2 + f[k, l]`` for one output tile.

    ``f_ref`` is the ``[padded_n, tile_lines]`` column block of one batch
    entry (a view into device memory, not a copy), ``cmin_ref`` the
    per-chunk minima of that block (``+inf`` past the last chunk), and
    ``out_ref`` the ``[tile_q, tile_lines]`` tile."""
    tq = out_ref.shape[0]
    n_bounds = cmin_ref.shape[0]
    q0 = pl.program_id(2) * tq
    q = (q0 + lax.broadcasted_iota(jnp.int32, (tq, 1), 0)).astype(jnp.float32)

    c_idx = lax.broadcasted_iota(jnp.int32, (n_bounds,), 0)
    gap_lo = q0 - (c_idx * chunk + chunk - 1)
    gap_hi = c_idx * chunk - (q0 + tq - 1)
    geom = jnp.maximum(jnp.maximum(gap_lo, gap_hi), 0).astype(jnp.float32)
    bounds = geom * geom + cmin_ref[...]

    def cond(state):
        d, b = state
        return jnp.min(b) < jnp.max(d)

    def body(state):
        d, b = state
        c = jnp.argmin(b).astype(jnp.int32)
        base = c * chunk
        for u in range(chunk):
            row = f_ref[pl.ds(base + u, 1), :]           # [1, tile_lines]
            delta = q - (base + u).astype(jnp.float32)   # [tile_q, 1]
            d = jnp.minimum(d, delta * delta + row)
        return d, jnp.where(c_idx == c, jnp.inf, b)

    d0 = jnp.full(out_ref.shape, jnp.inf, jnp.float32)
    d, _ = lax.while_loop(cond, body, (d0, bounds))
    out_ref[...] = d


def _envelope_middle(f: Array, tile_q: int, tile_lines: int,
                     interpret: bool) -> Array:
    """Envelope along axis 1 of a ``[batch, n, lines]`` float32 array.

    Padding values matter: positions pad with ``+inf`` (a candidate that
    never wins), lines pad with ``0.0``. An ``inf`` line would pin its
    outputs at ``inf``, so the tile's worst entry would stay ``inf`` and the
    march would never stop early; a zero line converges at once and only
    loosens the bound of the one tile that holds it."""
    batch, n, lines = f.shape
    step = max(_CHUNK, tile_q)
    pad_n = (-n) % step
    pad_l = (-lines) % tile_lines
    if pad_n or pad_l:
        f = jnp.pad(f, ((0, 0), (0, pad_n), (0, pad_l)),
                    constant_values=((0.0, 0.0), (jnp.inf, jnp.inf),
                                     (0.0, 0.0)))
    padded_n, padded_l = n + pad_n, lines + pad_l
    n_ch = padded_n // _CHUNK
    n_lb = padded_l // tile_lines
    cmin = jnp.min(f.reshape(batch, n_ch, _CHUNK, n_lb, tile_lines),
                   axis=(2, 4))                              # [B, n_ch, n_lb]
    # Triton vectors have power-of-two sizes: pad the bound vector with
    # +inf chunks, which are never chosen.
    n_bounds = 1 << max(n_ch - 1, 0).bit_length()
    cmin = jnp.pad(jnp.swapaxes(cmin, 1, 2),
                   ((0, 0), (0, 0), (0, n_bounds - n_ch)),
                   constant_values=jnp.inf)                  # [B, n_lb, nb]

    out = pl.pallas_call(
        functools.partial(_bestfirst_kernel, chunk=_CHUNK),
        grid=(batch, n_lb, padded_n // tile_q),
        in_specs=[
            pl.BlockSpec((None, padded_n, tile_lines),
                         lambda b, i, j: (b, 0, i)),
            pl.BlockSpec((None, None, n_bounds), lambda b, i, j: (b, i, 0)),
        ],
        out_specs=pl.BlockSpec((None, tile_q, tile_lines),
                               lambda b, i, j: (b, j, i)),
        out_shape=jax.ShapeDtypeStruct(f.shape, jnp.float32,
                                       vma=jax.typeof(f).vma),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="edt_envelope_bestfirst",
    )(f, cmin)
    return out[:, :n, :lines]


@functools.partial(jax.jit, static_argnames=("axis", "tile_q", "tile_lines",
                                             "interpret"))
def envelope_along_axis(f: Array, axis: int, tile_q: int = TILE_Q,
                        tile_lines: int = TILE_LINES,
                        interpret: bool = False) -> Array:
    """Exact 1-D squared-distance transform of ``f`` along ``axis``.

    Same result as moving ``axis`` last and calling
    :func:`..ops.edt._parabolic_envelope_last`, for any float32 ``f``
    (``+inf`` allowed; the bound ``geom^2 + min f[chunk]`` holds for negative
    values too). ``tile_q`` and ``tile_lines`` must be powers of two.
    ``interpret=True`` runs the kernel in the Pallas interpreter, which is
    how it is tested without a GPU."""
    for name, v in (("tile_q", tile_q), ("tile_lines", tile_lines)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two, got {v}")
    f = jnp.asarray(f, jnp.float32)
    shape = f.shape
    axis = axis % f.ndim
    n = shape[axis]
    batch = math.prod(shape[:axis])
    lines = math.prod(shape[axis + 1:])
    if lines > 1:
        out = _envelope_middle(f.reshape(batch, n, lines), tile_q, tile_lines,
                               interpret)
        return out.reshape(shape)
    # Last axis: put the lines on the minor axis for coalesced row loads.
    ft = jnp.swapaxes(f.reshape(1, batch, n), 1, 2)           # [1, n, batch]
    out = _envelope_middle(ft, tile_q, tile_lines, interpret)
    return jnp.swapaxes(out, 1, 2).reshape(shape)
