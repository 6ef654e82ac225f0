"""DSH benchmark: packed probe-table query rate on device.

The reference's DynamicSpatialHashedVoxelGrid answers GetLocationImmutable
one query at a time on the host (dynamic_spatial_hashed_occupancy_map.hpp).
The accelerator analogue packs the chunked map into a device-resident
open-addressing table (core/dsh.PackedDSHMap) and answers MILLIONS of
queries per dispatch through ``packed_get_location``'s vectorized linear
probe. This measures that rate — hit-heavy and miss-heavy mixes — next to
the dense OccupancyMap gather rate on the same query batch, to state what
the sparse probe costs relative to a dense lookup.

Run on a GPU: ``python benchmarks/dsh_query.py [n_queries]``
(``JAX_PLATFORMS=cpu`` smoke-tests it on the CPU backend).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from anywhere

import json
import os
import sys
import time

import jax

from voxelized_geometry_tools_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)
enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from voxelized_geometry_tools_tpu import GridSpec, OccupancyMap
from voxelized_geometry_tools_tpu.core import dsh


def _force(x):
    return jax.block_until_ready(x)


def build_map(n_chunks_axis=12):
    """A DSH map with an n^3 block of allocated 8^3-voxel chunks (a solid
    occupied core inside each, free elsewhere) — ~1.7k chunks at n=12."""
    sizes = dsh.DSHGridSizes(resolution=0.05, chunk_counts=(8, 8, 8))
    m = dsh.DynamicSpatialHashedOccupancyMap(sizes, frame="bench")
    t0 = time.monotonic()
    cs = sizes.chunk_sizes
    for cx in range(n_chunks_axis):
        for cy in range(n_chunks_axis):
            for cz in range(n_chunks_axis):
                # One set_location per chunk allocates it (chunk-granularity
                # fill); center of the chunk.
                p = ((cx + 0.5) * cs[0], (cy + 0.5) * cs[1],
                     (cz + 0.5) * cs[2])
                m.set_location(p, 1.0, grain=dsh.FillStatus.CHUNK_FILLED)
    build_s = time.monotonic() - t0
    return m, build_s, n_chunks_axis * np.asarray(cs)


def main():
    n_queries = int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000
    rng = np.random.default_rng(0)
    m, build_s, extent = build_map()
    # Warm the backend BEFORE timing pack: the first jnp.asarray of the
    # process pays backend initialisation.
    _force(jnp.zeros(8))
    t0 = time.monotonic()
    packed = m.pack()
    packed = jax.tree.map(
        lambda x: jax.device_put(x) if hasattr(x, "shape") else x, packed)
    _force(packed.chunk_data)
    pack_s = time.monotonic() - t0
    n_chunks = int(packed.chunk_data.shape[0])
    print(f"chunks={n_chunks} cap={packed.capacity} "
          f"build={build_s:.2f}s pack={pack_s:.2f}s", flush=True)

    # Hit-heavy batch: uniform inside the allocated extent. Miss-heavy:
    # uniform over 2x the extent per axis (7/8 of queries outside).
    q_hit = rng.uniform(0, 1, (n_queries, 3)).astype(np.float32) * extent
    q_miss = (rng.uniform(-0.5, 1.5, (n_queries, 3)).astype(np.float32)
              * extent)

    query = jax.jit(lambda p, q: dsh.packed_get_location(p, q)[0])

    results = {"n_chunks": n_chunks, "capacity": int(packed.capacity),
               "n_queries": n_queries, "host_build_s": build_s,
               "pack_s": pack_s}
    for name, q in (("hit", q_hit), ("miss", q_miss)):
        qd = jax.device_put(jnp.asarray(q))
        _force(qd)
        out = query(packed, qd)
        _force(out)  # compile + warm
        iters = 5
        t0 = time.monotonic()
        for _ in range(iters):
            out = query(packed, qd)
        _force(out)
        dt = (time.monotonic() - t0) / iters
        rate = n_queries / dt
        results[f"{name}_queries_per_s"] = rate
        results[f"{name}_ns_per_query"] = dt / n_queries * 1e9
        print(f"{name}: {dt*1e3:.2f} ms -> {rate/1e6:.1f} M q/s "
              f"({dt/n_queries*1e9:.2f} ns/q)", flush=True)

    # Dense comparison: same hit batch against a dense OccupancyMap whose
    # grid covers the allocated extent (96^3 voxels at these sizes).
    counts = tuple(int(round(e / m.resolution)) for e in extent)
    spec = GridSpec.from_voxel_counts(m.resolution, counts)
    dense = OccupancyMap.create(spec, None, "bench")
    dvals = jax.device_put(dense.occupancy)

    def dense_query(vals, p):
        idx = jnp.clip((p / spec.resolution).astype(jnp.int32), 0,
                       jnp.asarray(counts, jnp.int32) - 1)
        return vals[idx[..., 0], idx[..., 1], idx[..., 2]]

    dq = jax.jit(dense_query)
    qd = jax.device_put(jnp.asarray(q_hit))
    out = dq(dvals, qd)
    _force(out)
    iters = 5
    t0 = time.monotonic()
    for _ in range(iters):
        out = dq(dvals, qd)
    _force(out)
    dt = (time.monotonic() - t0) / iters
    results["dense_queries_per_s"] = n_queries / dt
    results["dense_ns_per_query"] = dt / n_queries * 1e9
    print(f"dense: {dt*1e3:.2f} ms -> {n_queries/dt/1e6:.1f} M q/s "
          f"({dt/n_queries*1e9:.2f} ns/q)", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
