"""Hand-written kernels for the dense-grid hot passes.

Each kernel is an *alternative backend* to an XLA formulation in
:mod:`..ops`, with an exactness test against it, mirroring the reference's
CPU/CUDA/OpenCL one-oracle-many-backends strategy
(pointcloud_voxelization_test.cpp:275-295). A kernel stays only while it
beats its XLA twin on the GPU; PERF.md records both times.

* :mod:`.edt_triton` — the EDT's best-first envelope pass (Pallas, Triton
  route).
"""

from . import edt_triton  # noqa: F401
