"""Profiling / tracing utilities.

The reference's only observability hooks are the per-phase wall timings it
returns from API calls (``VoxelizerRuntime`` — pointcloud_voxelization_
interface.hpp:206-229) and ``std::chrono`` prints in the examples
(tutorial.cpp:145-155, 213-219). This module keeps that "runtime struct
returned from the API" shape (see :class:`..ops.voxelize.VoxelizerRuntime`)
and adds:

* :class:`PhaseTimer` — named wall-clock phases that wait for the phase's
  outputs with ``jax.block_until_ready`` before the clock stops,
* :func:`trace` — a thin wrapper over ``jax.profiler.trace`` producing
  TensorBoard-loadable device traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class PhaseTimer:
    """Accumulating named-phase wall timer.

    The context manager yields a list; append the block's OUTPUTS to it so
    they are materialized before the clock stops (arguments passed to
    ``phase(...)`` directly are bound at entry and therefore can only be
    values that already exist — an earlier design bound ONLY entry-time
    arguments, which by construction could never cover the timed block's
    own results, so async dispatch leaked each phase's device time into
    the next phase).

    >>> timer = PhaseTimer()
    >>> with timer.phase("raycast") as outs:
    ...     grids = carve(...)
    ...     outs.append(grids)        # materialized before the clock stops
    >>> timer.times()["raycast"]

    Under ``jax.jit`` the outputs are tracers and there is nothing to wait
    for: the phase then times tracing only. A phase whose body raises records no time (a half-timed failed phase
    would pollute the totals) and never masks the body's exception with a
    secondary materialization error.
    """

    def __init__(self):
        self._times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, *materialize):
        outs = list(materialize)
        t0 = time.monotonic()
        yield outs
        # (reached only when the body did not raise; a no-op on tracers)
        jax.block_until_ready(outs)
        self._times[name] = (self._times.get(name, 0.0)
                             + time.monotonic() - t0)

    def times(self) -> Dict[str, float]:
        return dict(self._times)

    def total(self) -> float:
        return sum(self._times.values())

    def report(self) -> str:
        lines = [f"{name}: {t:.4f}s" for name, t in self._times.items()]
        lines.append(f"total: {self.total():.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Device-level profiler trace (TensorBoard format). No-op when
    ``log_dir`` is None so call sites can leave tracing wired in."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield
