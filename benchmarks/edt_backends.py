"""Two-field EDT at 512^3: the Triton envelope kernel against plain XLA.

Times ``ops.edt.signed_distance_from_filled_mask`` on the seeded workcell
workcell scene (``utils/workcell.py``) with ``backend="triton"`` and ``backend="xla"``
in one process, in turns (xla, triton, triton, xla), each the median of
``--iters`` warm calls ending in ``block_until_ready``. Also times one
envelope pass on the intermediate the pipeline hands it: the middle-axis
pass (no transpose) on the stacked binary-pass output, and the last-axis
pass (one transpose in, one out) on the middle-axis pass's output. Prints XLA's temporary-buffer size for the
min-plus so a materialized candidate array would show.

Needs a GPU: ``python benchmarks/edt_backends.py [--n 512] [--iters 10]``.
Prints one JSON line.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np


def _median_s(fn, arg, iters):
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from voxelized_geometry_tools_tpu.ops import edt
    from voxelized_geometry_tools_tpu.kernels import edt_triton
    from voxelized_geometry_tools_tpu.utils.compile_cache import (
        enable_compile_cache)
    from voxelized_geometry_tools_tpu.utils.gpu import card_line, require_gpu
    from voxelized_geometry_tools_tpu.utils.workcell import WorkcellScene

    require_gpu("benchmarks/edt_backends.py")
    print(card_line(), flush=True)
    enable_compile_cache()
    scene = WorkcellScene.make(args.n, args.seed)
    mask = jax.device_put(scene.mask())

    out = {"n": args.n, "device_kind": jax.devices()[0].device_kind}
    fns = {b: jax.jit(lambda m, b=b: edt.signed_distance_from_filled_mask(
        m, 0.01, backend=b)) for b in ("xla", "triton")}
    results = {}
    for b, fn in fns.items():
        t0 = time.perf_counter()
        compiled = fn.lower(mask).compile()
        out[f"compile_s_{b}"] = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        out[f"temp_bytes_{b}"] = getattr(mem, "temp_size_in_bytes", None)
        results[b] = jax.block_until_ready(fn(mask))
    out["exact"] = bool(jnp.array_equal(results["xla"], results["triton"]))
    del results

    times = {"xla": [], "triton": []}
    for b in ("xla", "triton", "triton", "xla"):
        times[b].append(_median_s(fns[b], mask, args.iters))
    for b, t in times.items():
        out[f"two_field_s_{b}"] = t

    # Each envelope pass on the stacked [2n, n, n] field it sees in
    # signed_distance_from_filled_mask: the binary axis-0 pass's output laid
    # back as [x, y, z], then the middle-axis pass's output.
    d = jax.block_until_ready(jax.jit(lambda m: jnp.concatenate(
        [jnp.moveaxis(edt._binary_squared_dist_last(jnp.moveaxis(s, 0, -1)),
                      -1, 0) for s in (m, ~m)]))(mask))
    for axis in (1, 2):
        kern = jax.jit(lambda f, a=axis: edt_triton.envelope_along_axis(f, a))
        plain = jax.jit(lambda f, a=axis: edt._envelope_axis(f, a, 512,
                                                             "xla"))
        jax.block_until_ready((kern(d), plain(d)))
        out[f"pass_axis{axis}_s_triton"] = _median_s(kern, d, args.iters)
        out[f"pass_axis{axis}_s_xla"] = _median_s(plain, d, args.iters)
        d = jax.block_until_ready(kern(d))
    transpose = jax.jit(lambda f: jnp.swapaxes(f, 1, 2))
    jax.block_until_ready(transpose(d))
    out["transpose_s"] = _median_s(transpose, d, args.iters)
    out["peak_bytes_in_use"] = jax.devices()[0].memory_stats().get(
        "peak_bytes_in_use")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
