"""Exactness tests for the Triton envelope kernel (interpret mode on CPU),
mirroring the reference's one-oracle-many-backends strategy
(pointcloud_voxelization_test.cpp:275-295 runs the same checks on every
available device backend), plus the EDT's choice of backend."""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from voxelized_geometry_tools_tpu.ops import edt
from voxelized_geometry_tools_tpu.kernels import edt_triton


def _xla_along(f, axis):
    return np.asarray(edt._envelope_axis(jnp.asarray(f), axis, 512, "xla"))


def _triton_along(f, axis, **kw):
    kw.setdefault("tile_q", 16)
    kw.setdefault("tile_lines", 8)
    return np.asarray(edt_triton.envelope_along_axis(
        jnp.asarray(f), axis, interpret=True, **kw))


@pytest.mark.parametrize("shape", [(7, 13, 37), (3, 50), (1, 1, 4)])
def test_envelope_bestfirst_matches_xla(shape):
    rng = np.random.default_rng(3)
    f = rng.uniform(0, 300, shape).astype(np.float32)
    f[rng.uniform(size=shape) < 0.4] = np.inf
    np.testing.assert_array_equal(_xla_along(f, -1), _triton_along(f, -1))


@pytest.mark.parametrize("shape,axis", [((7, 13, 37), 1), ((9, 40, 6), 1),
                                        ((20, 3, 5), 0), ((2, 3, 33, 4), 2)])
def test_envelope_bestfirst_middle_axis_matches_xla(shape, axis):
    """Passes along a middle axis read the lines in place (no transpose)."""
    rng = np.random.default_rng(11)
    f = rng.uniform(0, 300, shape).astype(np.float32)
    f[rng.uniform(size=shape) < 0.4] = np.inf
    np.testing.assert_array_equal(_xla_along(f, axis),
                                  _triton_along(f, axis))


def test_bestfirst_degenerate_fields():
    for fill in (np.inf, 0.0, 1e6):
        f = np.full((6, 40), fill, np.float32)
        np.testing.assert_array_equal(_xla_along(f, -1),
                                      _triton_along(f, -1, tile_q=8))


def test_bestfirst_negative_values_exact():
    """The bound ``geom^2 + min f[chunk]`` also holds for negative f."""
    rng = np.random.default_rng(4)
    f = rng.uniform(-500, 500, (5, 70)).astype(np.float32)
    np.testing.assert_array_equal(_xla_along(f, -1), _triton_along(f, -1))


def test_bestfirst_small_tile_lines_exact():
    """Tile shapes other than the defaults must stay exact, including a
    q tile wider than the chunk."""
    rng = np.random.default_rng(5)
    f = np.where(rng.random((8, 96, 300)) < 0.02, 0.0, np.inf)
    f[0, 0, 17] = 0.0
    f = f.astype(np.float32)
    ref = _xla_along(f, -1)
    for tl, tq in ((256, 16), (32, 64)):
        np.testing.assert_array_equal(
            ref, _triton_along(f, -1, tile_lines=tl, tile_q=tq))


def test_all_kernels_exact_with_line_padding():
    """Line counts that do NOT divide tile_lines force padded lanes; the
    kernel must stay exact on the real lanes regardless of pad values."""
    rng = np.random.default_rng(78)
    f = rng.random((7, 96)).astype(np.float32) * 50.0
    f[rng.random((7, 96)) < 0.5] = np.inf
    f[:, 11] = 0.0
    np.testing.assert_array_equal(_xla_along(f, -1),
                                  _triton_along(f, -1, tile_lines=128))


def test_tile_sizes_must_be_powers_of_two():
    with pytest.raises(ValueError, match="power of two"):
        edt_triton.envelope_along_axis(jnp.zeros((4, 8)), -1, tile_q=24,
                                       interpret=True)


@pytest.fixture
def gpu_resolution(monkeypatch):
    """Make ``auto`` resolve as on a GPU, with the kernel interpreted."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        edt_triton, "envelope_along_axis",
        functools.partial(edt_triton.envelope_along_axis, tile_q=16,
                          tile_lines=8, interpret=True))


def test_resolve_edt_backend(monkeypatch):
    assert edt._resolve_edt_backend("auto") == "xla"   # CPU here
    assert edt._resolve_edt_backend("xla") == "xla"
    assert edt._resolve_edt_backend("triton") == "triton"
    with pytest.raises(ValueError, match="Unknown EDT backend"):
        edt._resolve_edt_backend("pallas-windowed")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert edt._resolve_edt_backend("auto") == "triton"
    assert edt._resolve_edt_backend("xla") == "xla"


def test_squared_edt_pallas_matches_xla(gpu_resolution):
    """The full 3-D EDT through the kernel's passes (one middle-axis pass,
    one last-axis pass) equals the XLA backend."""
    rng = np.random.default_rng(7)
    seed = jnp.asarray(rng.uniform(size=(24, 17, 33)) < 0.1)
    np.testing.assert_array_equal(
        np.asarray(edt.squared_edt(seed, backend="xla")),
        np.asarray(edt.squared_edt(seed, backend="auto")))


def test_squared_edt_pallas_empty_and_full(gpu_resolution):
    empty = jnp.zeros((4, 5, 6), bool)
    assert bool(jnp.all(jnp.isinf(edt.squared_edt(empty))))
    full = jnp.ones((4, 5, 6), bool)
    assert bool(jnp.all(edt.squared_edt(full) == 0.0))


def test_signed_distance_and_streamed_through_kernel(gpu_resolution):
    """The stacked two-field pass and the slab-streamed pipeline both run
    the kernel per pass and stay bit-identical to XLA."""
    rng = np.random.default_rng(9)
    filled = jnp.asarray(rng.uniform(size=(12, 10, 20)) < 0.2)
    want = np.asarray(edt.signed_distance_from_filled_mask(
        filled, 0.1, backend="xla"))
    np.testing.assert_array_equal(
        want, np.asarray(edt.signed_distance_from_filled_mask(filled, 0.1)))
    np.testing.assert_array_equal(
        want, np.asarray(edt.signed_distance_from_filled_mask_streamed(
            filled, 0.1, slab=4)))
