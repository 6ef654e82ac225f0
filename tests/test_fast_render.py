"""Tests for the render/query acceleration structures.

The CornerTable and SdfMip fast paths must be exact (CornerTable) or
hit-equivalent (mip skip + chunked tail) against the reference-semantics
slow path, including gradients.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxelized_geometry_tools_tpu import GridSpec
from voxelized_geometry_tools_tpu.ops import edt, render, sdf_query


@pytest.fixture(scope="module")
def sphere_sdf():
    n = 40
    spec = GridSpec.from_voxel_counts(0.05, (n, n, 24))
    xs, ys, zs = np.meshgrid(np.arange(n), np.arange(n), np.arange(24),
                             indexing="ij", sparse=True)
    filled = ((xs - 20) ** 2 + (ys - 20) ** 2 + (zs - 12) ** 2) <= 81
    return edt.extract_signed_distance_field(
        jnp.asarray(filled), spec, None, frame="t")


@pytest.fixture(scope="module")
def corner_table(sphere_sdf):
    return sdf_query.build_corner_table(sphere_sdf)


def test_corner_table_exact_match(sphere_sdf, corner_table):
    """Fast path must match the 8-gather path to float ulp level (the two
    programs reassociate the same arithmetic) on every region: interior,
    edge extrapolation, and out-of-bounds."""
    rng = np.random.default_rng(0)
    hi = np.asarray(sphere_sdf.spec.grid_sizes)
    pts = rng.uniform(-0.3, 1.0, size=(5000, 3)) * (hi + 0.6) - 0.3
    pts = jnp.asarray(pts, jnp.float32)
    slow = sdf_query.estimate_location_distance(sphere_sdf, pts)
    fast = sdf_query.estimate_location_distance_fast(
        sphere_sdf, corner_table, pts)
    np.testing.assert_array_equal(np.asarray(slow.valid),
                                  np.asarray(fast.valid))
    m = np.asarray(slow.valid)
    np.testing.assert_allclose(np.asarray(slow.value)[m],
                               np.asarray(fast.value)[m], rtol=0, atol=1e-6)


def test_corner_pair_table_bitwise_matches_brick(sphere_sdf, corner_table):
    """The 4-gather z-pair table assembles the same 8-corner vector in the
    same order as the 1-gather brick table, so query values must be
    BITWISE identical everywhere (interior, edge extrapolation, OOB)."""
    pair = sdf_query.build_corner_pair_table(sphere_sdf)
    # Lane-packed: 4 z-pairs per 8-lane row (see the CornerPairTable
    # docstring for why).
    n_cells = int(np.prod(sphere_sdf.spec.counts))
    assert pair.rows.shape == (-(-n_cells // 4), 8)
    rng = np.random.default_rng(7)
    hi = np.asarray(sphere_sdf.spec.grid_sizes)
    pts = rng.uniform(-0.3, 1.0, size=(5000, 3)) * (hi + 0.6) - 0.3
    pts = jnp.asarray(pts, jnp.float32)
    brick = sdf_query.estimate_location_distance_fast(
        sphere_sdf, corner_table, pts)
    zpair = sdf_query.estimate_location_distance_fast(
        sphere_sdf, pair, pts)
    np.testing.assert_array_equal(np.asarray(brick.valid),
                                  np.asarray(zpair.valid))
    m = np.asarray(brick.valid)
    np.testing.assert_array_equal(np.asarray(brick.value)[m],
                                  np.asarray(zpair.value)[m])


def test_corner_pair_table_gradients_match(sphere_sdf):
    """Voxel gradients through the pair-table query equal the 8-gather
    path's (the table build is shifts only, so AD routes through it)."""
    pts = jnp.asarray(np.random.default_rng(2).uniform(
        0.2, 1.0, size=(64, 3)), jnp.float32)

    def loss_slow(d):
        s = sphere_sdf.replace(distances=d)
        return jnp.nansum(sdf_query.estimate_location_distance(s, pts).value)

    def loss_pair(d):
        s = sphere_sdf.replace(distances=d)
        t = sdf_query.build_corner_pair_table(s)
        return jnp.nansum(
            sdf_query.estimate_location_distance_fast(s, t, pts).value)

    g_slow = jax.grad(loss_slow)(sphere_sdf.distances)
    g_pair = jax.grad(loss_pair)(sphere_sdf.distances)
    np.testing.assert_allclose(np.asarray(g_slow), np.asarray(g_pair),
                               atol=1e-5)


@pytest.mark.slow
def test_corner_pair_table_render_matches(sphere_sdf, corner_table):
    """Renders through the pair table match the brick-table renders within
    the convergence threshold. (NOT bitwise: the written arithmetic is
    identical, but XLA fuses the 4-gather and 1-gather programs
    differently, and 1-ulp sample drift can flip a marginal silhouette ray
    at the convergence boundary — the eager query-level comparison above
    IS bitwise.)"""
    pair = sdf_query.build_corner_pair_table(sphere_sdf)
    cam = _camera(sphere_sdf, w=48, h=32)
    atol = 2.0 * 0.25 * sphere_sdf.resolution + 1e-6
    for kwargs in [dict(early_exit=True),
                   dict(early_exit=True, coarse_factor=4, head_steps=0,
                        tail_chunks=8)]:
        a = render.render_depth(sphere_sdf, cam, num_steps=64,
                                corner_table=corner_table, **kwargs)
        bq = render.render_depth(sphere_sdf, cam, num_steps=64,
                                 corner_table=pair, **kwargs)
        ah, bh = np.asarray(a.hit), np.asarray(bq.hit)
        assert (ah != bh).mean() < 0.02, "hit masks diverged beyond ulp flips"
        m = ah & bh
        np.testing.assert_allclose(np.asarray(a.depth)[m],
                                   np.asarray(bq.depth)[m], atol=atol)


def test_corner_table_nonfinite_points(sphere_sdf, corner_table):
    pts = jnp.asarray([[np.nan, 0.1, 0.1], [np.inf, 0.1, 0.1],
                       [0.1, 0.1, 0.1]], jnp.float32)
    q = sdf_query.estimate_location_distance_fast(sphere_sdf, corner_table,
                                                  pts)
    assert not bool(q.valid[0]) and not bool(q.valid[1])
    assert bool(q.valid[2])


def test_corner_table_gradients_match(sphere_sdf):
    pts = jnp.asarray(np.random.default_rng(1).uniform(
        0.2, 1.0, size=(64, 3)), jnp.float32)

    def loss_slow(d):
        s = sphere_sdf.replace(distances=d)
        return jnp.nansum(sdf_query.estimate_location_distance(s, pts).value)

    def loss_fast(d):
        s = sphere_sdf.replace(distances=d)
        t = sdf_query.build_corner_table(s)
        return jnp.nansum(
            sdf_query.estimate_location_distance_fast(s, t, pts).value)

    g_slow = jax.grad(loss_slow)(sphere_sdf.distances)
    g_fast = jax.grad(loss_fast)(sphere_sdf.distances)
    np.testing.assert_allclose(np.asarray(g_slow), np.asarray(g_fast),
                               atol=1e-5)


def _camera(sdf, w=48, h=36):
    sizes = np.asarray(sdf.spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.5 * sizes[2]])
    return render.PinholeCamera.create(pose, w, h, focal=45.0)


def test_fast_render_matches_slow(sphere_sdf, corner_table):
    cam = _camera(sphere_sdf)
    base = render.render_depth(sphere_sdf, cam, num_steps=64)
    fast = render.render_depth(sphere_sdf, cam, num_steps=64,
                               corner_table=corner_table)
    np.testing.assert_array_equal(np.asarray(base.hit), np.asarray(fast.hit))
    np.testing.assert_allclose(np.asarray(base.depth),
                               np.asarray(fast.depth), atol=1e-5)


@pytest.mark.parametrize("factor", [4, 8])
def test_mip_skip_hit_equivalence(sphere_sdf, corner_table, factor):
    """Mip skipping + early exit + chunked tail must find the same surface."""
    cam = _camera(sphere_sdf)
    mip = render.build_sdf_mip(sphere_sdf, factor)
    base = render.render_depth(sphere_sdf, cam, num_steps=64)
    fast = render.render_depth(sphere_sdf, cam, num_steps=64,
                               corner_table=corner_table, early_exit=True,
                               mip=mip)
    assert float((np.asarray(base.hit) == np.asarray(fast.hit)).mean()) == 1.0
    m = np.asarray(base.hit)
    np.testing.assert_allclose(np.asarray(base.depth)[m],
                               np.asarray(fast.depth)[m],
                               atol=2 * sphere_sdf.spec.resolution)


def test_mip_lower_bound_property(sphere_sdf):
    """Every mip entry must lower-bound the SDF anywhere in its block."""
    mip = render.build_sdf_mip(sphere_sdf, 4)
    d = np.asarray(sphere_sdf.distances)
    vals = np.asarray(mip.values).reshape(mip.coarse_counts)
    nx, ny, nz = d.shape
    f = mip.factor
    # The mip must lower-bound the CORRECTED distance the march compares
    # against (stored distance pulled half a voxel toward the surface).
    corrected = np.where(d >= 0.0, d - 0.5 * sphere_sdf.spec.resolution,
                         d + 0.5 * sphere_sdf.spec.resolution)
    rng = np.random.default_rng(3)
    for _ in range(200):
        i, j, k = (rng.integers(0, nx), rng.integers(0, ny),
                   rng.integers(0, nz))
        assert vals[i // f, j // f, k // f] <= corrected[i, j, k] + 1e-6


def test_mip_jits_and_is_pytree(sphere_sdf):
    mip = jax.jit(lambda s: render.build_sdf_mip(s, 8))(sphere_sdf)
    leaves = jax.tree_util.tree_leaves(mip)
    assert any(l.size > 1 for l in leaves if hasattr(l, "size"))


def test_chunked_tail_scatter_roundtrip(sphere_sdf, corner_table):
    """Tail chunking must not permute results (scatter-back correctness):
    compare against the same config with chunking disabled."""
    cam = _camera(sphere_sdf, w=37, h=23)  # non-divisible sizes stress pad
    mip = render.build_sdf_mip(sphere_sdf, 8)
    chunked = render.render_depth(sphere_sdf, cam, num_steps=64,
                                  corner_table=corner_table, early_exit=True,
                                  mip=mip)
    whole = render.sphere_trace(
        sphere_sdf, *render.camera_rays(cam), num_steps=64,
        corner_table=corner_table, early_exit=True, mip=mip, tail_chunks=1)
    np.testing.assert_allclose(np.asarray(chunked.depth),
                               np.asarray(whole.depth), atol=1e-5)


_JRENDER_CACHE = {}


def _jrender(sdf, cam, corner_table=None, **kw):
    """Jitted render_depth for the heavy contract tests: eager lax
    while_loops re-trace per call, so the 96-128-step schedule-contract
    tests each burned 10-30 s of dispatch. One wrapper per SCHEDULE is
    cached here (a fresh jit-of-lambda per call would never hit jax's
    own cache — it keys on the wrapper object); sdf/cam/table pass as
    traced args so jit's cache handles shape changes. Bitwise-INVARIANCE
    tests stay eager on purpose — XLA may fuse two different schedules'
    programs differently (ulp drift), which would make a bitwise assert
    flaky without weakening the eager contract."""
    key = tuple(sorted(kw.items()))
    fn = _JRENDER_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda s, c, t, kw=kw: render.render_depth(
            s, c, corner_table=t, **kw))
        _JRENDER_CACHE[key] = fn
    return fn(sdf, cam, corner_table)


def _check_cone_equiv(base, cone, sdf):
    """Equivalence contract for a WORKING cone prepass:
    :func:`render.compare_with_plain_march`, the contract the GPU smoke
    test holds the shipped schedule to at 512^3.

    Starting a ray at a certified-safe deeper depth changes its sample
    SEQUENCE, so depths are not bitwise equal — but the sphere-trace
    iteration ``t -> t + d(t)`` is monotone for a 1-Lipschitz field, so a
    certified start can only move a ray FURTHER along, never past a
    surface the plain march would find: no converged base hit is skipped,
    and common hits agree within twice the convergence threshold. Tangent
    grazers (a query within a small band of the threshold, no crossing)
    can classify either way under any resampling and are exempt (8/307k
    pixels on the 512^3 sphere at focal 600, certificates uninvolved).
    """
    agreement = render.compare_with_plain_march(base, cone, sdf.resolution)
    assert agreement.ok, agreement.describe()
    # A lone sphere has no surface behind a grazer, so here even the pixels
    # the contract exempts must agree: every base hit outside the band is
    # a cone hit, and every common hit is within twice the threshold.
    thresh = 0.25 * sdf.resolution
    band = render.GRAZER_BAND_VOXELS * sdf.resolution
    base_hit, cone_hit = np.asarray(base.hit), np.asarray(cone.hit)
    graze = np.abs(np.asarray(base.distance) - thresh) <= band
    assert not (base_hit & ~cone_hit & ~graze).any(), agreement.describe()
    m = base_hit & cone_hit
    np.testing.assert_allclose(np.asarray(cone.depth)[m],
                               np.asarray(base.depth)[m],
                               atol=2.0 * thresh + 1e-6)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_cone_prepass_equivalence(sphere_sdf, corner_table, factor):
    """The cone-traced prepass certifies per-block safe starting depths —
    no surface may be skipped and converged depths must agree within the
    convergence threshold; with a generous budget the hit masks are
    identical (see _check_cone_equiv for the contract)."""
    cam = _camera(sphere_sdf, w=48, h=32)
    base = _jrender(sphere_sdf, cam, num_steps=128,
                    corner_table=corner_table, early_exit=True)
    cone = _jrender(sphere_sdf, cam, num_steps=128,
                    corner_table=corner_table, early_exit=True,
                    coarse_factor=factor)
    _check_cone_equiv(base, cone, sphere_sdf)
    # Budget 128 is generous for a 40-voxel grid: both marches converge
    # everywhere a surface exists, so the masks must be identical.
    np.testing.assert_array_equal(np.asarray(base.hit), np.asarray(cone.hit))


def test_cone_refine_equivalence_and_deeper_certificates(sphere_sdf,
                                                         corner_table):
    """Hierarchical cone refinement (``cone_refine``): the composed
    parent+child certificates must preserve the cone contract (hit
    superset + depth within the threshold band on this grazer-free
    scene), and the refined prepass must certify STRICTLY MORE than the
    parent stage alone — deeper mean starts and at least as many escape
    certificates (that is the knob's entire point; measured on the 40^3
    scene: retired fraction 0.185 -> 0.292 at refine=4)."""
    cam = _camera(sphere_sdf, w=48, h=32)
    base = _jrender(sphere_sdf, cam, num_steps=128,
                    corner_table=corner_table, early_exit=True)
    refined = _jrender(sphere_sdf, cam, num_steps=128,
                       corner_table=corner_table,
                       early_exit=True, coarse_factor=8,
                       head_steps=0, tail_chunks=8,
                       cone_refine=4)
    _check_cone_equiv(base, refined, sphere_sdf)

    thresh = 0.25 * sphere_sdf.resolution
    plain = render._cone_prepass(sphere_sdf, cam, 8, 128, thresh, 100.0,
                                 corner_table)
    fine = render._cone_prepass(sphere_sdf, cam, 8, 128, thresh, 100.0,
                                corner_table, cone_refine=4)
    assert float(jnp.sum(fine[3])) >= float(jnp.sum(plain[3]))
    o, d = render.camera_rays(cam)
    _, _, hits = render._clip_to_grid(sphere_sdf, o, d)
    m = np.asarray(hits)
    assert (np.asarray(fine[0])[m].mean()
            > np.asarray(plain[0])[m].mean())
    with pytest.raises(ValueError, match="must divide"):
        render.render_depth(sphere_sdf, cam, corner_table=corner_table,
                            early_exit=True, coarse_factor=8,
                            head_steps=0, cone_refine=3)


def test_cone_prepass_actually_advances(sphere_sdf, corner_table):
    """Regression guard against the round-2 silent no-op: for a camera
    OUTSIDE the grid the prepass must still certify starts strictly deeper
    than the fine rays' own entry depths (the round-2 version issued a raw
    out-of-bounds query from its pre-entry start, died on step 0, and
    certified nothing — slowness was uniformly 1 and t_init < t_enter
    everywhere)."""
    cam = _camera(sphere_sdf, w=48, h=32)
    t_img, valid_img, slow, esc = render._cone_prepass(
        sphere_sdf, cam, 4, 64, 0.25 * sphere_sdf.resolution, 100.0,
        corner_table)
    o, d = render.camera_rays(cam)
    t_enter, _, hits = render._clip_to_grid(sphere_sdf, o, d)
    adv = np.asarray(t_img) - np.asarray(t_enter)
    m = np.asarray(hits)
    # A meaningful fraction of rays must start at least 2 voxels past
    # their entry, and the slowness image must not be constant.
    assert (adv[m] > 2.0 * sphere_sdf.resolution).mean() > 0.3
    assert np.asarray(slow).std() > 0.0


@pytest.mark.parametrize("factor", [4, 8])
def test_cone_prepass_distant_oblique_camera(sphere_sdf, corner_table,
                                             factor):
    """With a DISTANT grid (or a grazing entry
    face) a fine ray can enter the grid earlier than the cone march's start
    (center-ray entry minus a fixed slack), leaving an uncertified window
    where surfaces could be skipped. The fix gates the certificate per fine
    ray on ``t_enter >= cone start`` — cone-prepass renders must equal the
    plain march for ANY camera."""
    sizes = np.asarray(sphere_sdf.spec.grid_sizes)
    # Far away and oblique: look at the grid corner from ~40 grid-widths
    # out, so block cones subtend many voxels at the entry face.
    eye = sizes / 2.0 + np.array([60.0, 45.0, 80.0])
    target = np.array([0.1, 0.15, 0.05]) * sizes
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = (
        right, down, fwd, eye)
    cam = render.PinholeCamera.create(pose, 48, 32, focal=1500.0)
    base = _jrender(sphere_sdf, cam, num_steps=96,
                    corner_table=corner_table, early_exit=True)
    cone = _jrender(sphere_sdf, cam, num_steps=96,
                    corner_table=corner_table, early_exit=True,
                    coarse_factor=factor)
    _check_cone_equiv(base, cone, sphere_sdf)
    np.testing.assert_array_equal(np.asarray(base.hit), np.asarray(cone.hit))


def test_cone_prepass_headless_tail(sphere_sdf, corner_table):
    """head_steps=0 + cone-slowness sort key + block tail: no full-width
    fine steps at all — still no surface skipped, converged depths within
    the convergence-threshold contract."""
    cam = _camera(sphere_sdf, w=48, h=32)
    base = _jrender(sphere_sdf, cam, num_steps=128,
                    corner_table=corner_table, early_exit=True)
    headless = _jrender(sphere_sdf, cam, num_steps=128,
                        corner_table=corner_table,
                        early_exit=True, coarse_factor=4,
                        head_steps=0, tail_chunks=8)
    _check_cone_equiv(base, headless, sphere_sdf)
    np.testing.assert_array_equal(np.asarray(base.hit),
                                  np.asarray(headless.hit))


@pytest.mark.parametrize("chunks", [3, 8])
def test_cone_tail_chunking_bitwise_invariant(sphere_sdf, corner_table,
                                              chunks):
    """The chunked cone tail never changes a cone's sample sequence, so
    all four prepass outputs must be BITWISE identical for any chunk
    count (including non-dividing ones — padding is dead lanes)."""
    cam = _camera(sphere_sdf, w=48, h=32)
    ref = render._cone_prepass(
        sphere_sdf, cam, 4, 64, 0.25 * sphere_sdf.resolution, 100.0,
        corner_table)
    out = render._cone_prepass(
        sphere_sdf, cam, 4, 64, 0.25 * sphere_sdf.resolution, 100.0,
        corner_table, cone_tail_chunks=chunks)
    for a, b, name in zip(ref, out, ["t", "valid_from", "slow", "esc"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    # End-to-end render with the chunked cone is identical too.
    r1 = render.render_depth(sphere_sdf, cam, num_steps=64,
                             corner_table=corner_table, early_exit=True,
                             coarse_factor=4, head_steps=1, tail_chunks=8)
    r2 = render.render_depth(sphere_sdf, cam, num_steps=64,
                             corner_table=corner_table, early_exit=True,
                             coarse_factor=4, head_steps=1, tail_chunks=8,
                             cone_tail_chunks=chunks)
    np.testing.assert_array_equal(np.asarray(r1.depth),
                                  np.asarray(r2.depth))


def test_remat_march_gradients_match(sphere_sdf):
    """remat=True recomputes march steps in the backward pass — values
    and voxel gradients must equal the stored-activation path exactly.
    The corner table is rebuilt INSIDE the loss (a table built outside
    is a constant: no gradient would flow and the check would be 0≡0)."""
    cam = _camera(sphere_sdf, w=24, h=16)
    o, d = render.camera_rays(cam)

    def loss(dists, rm):
        s = sphere_sdf.replace(distances=dists)
        t = sdf_query.build_corner_table(s)
        r = render.sphere_trace(s, o, d, num_steps=24,
                                corner_table=t, remat=rm)
        return jnp.nansum(jnp.where(r.hit, r.depth, 0.0))

    v0, g0 = jax.value_and_grad(loss)(sphere_sdf.distances, False)
    v1, g1 = jax.value_and_grad(loss)(sphere_sdf.distances, True)
    assert int((np.asarray(g0) != 0).sum()) > 0
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), atol=1e-6)


def test_cone_prepass_gradients_flow(sphere_sdf, corner_table):
    """Reverse-mode AD must work through the cone-started scan march: the
    certified start is control data (stop_gradient — the depth's true
    gradient through a start point inside certified-empty space is zero),
    while the march itself stays differentiable in the voxel values."""
    cam = _camera(sphere_sdf, w=24, h=16)

    def loss(dists):
        r = render.render_depth(sphere_sdf.replace(distances=dists), cam,
                                num_steps=24, coarse_factor=4)
        return jnp.nansum(jnp.where(r.hit, r.depth, 0.0))

    g = jax.grad(loss)(sphere_sdf.distances)
    assert (np.asarray(g) != 0).any()
    assert np.isfinite(np.asarray(g)).all()


def test_cone_prepass_scan_path(sphere_sdf, corner_table):
    """Cone prepass composes with the differentiable scan march too."""
    cam = _camera(sphere_sdf, w=48, h=32)
    base = render.render_depth(sphere_sdf, cam, num_steps=128,
                               corner_table=corner_table)
    cone = render.render_depth(sphere_sdf, cam, num_steps=128,
                               corner_table=corner_table, coarse_factor=4)
    _check_cone_equiv(base, cone, sphere_sdf)
    # A non-dividing factor raises (matching render_depth_batch) instead of
    # silently disabling the prepass — a silent multi-x throughput
    # regression with no signal.
    with pytest.raises(ValueError, match="coarse_factor"):
        render.render_depth(sphere_sdf, cam, num_steps=128,
                            corner_table=corner_table, coarse_factor=7)


@pytest.mark.slow
def test_render_depth_batch_matches_per_view(sphere_sdf, corner_table):
    """One-march multi-camera rendering: per-ray sample sequences equal the
    per-view block-tail render, so depths are bitwise identical view by
    view."""
    sizes = np.asarray(sphere_sdf.spec.grid_sizes)
    cams = []
    for dx, dz in [(0.0, 1.5), (0.3, 1.8), (-0.4, 1.2)]:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = sizes / 2.0 - np.array([dx, 0.0, dz * sizes[2]])
        cams.append(render.PinholeCamera.create(pose, 32, 24, focal=30.0))
    batched = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    out = render.render_depth_batch(
        sphere_sdf, batched, num_steps=48, corner_table=corner_table,
        coarse_factor=4, tail_chunks=8)
    assert out.depth.shape == (3, 24, 32)
    for i, cam in enumerate(cams):
        # Match render_depth_batch's round-4 defaults (cone_steps=32,
        # cone_tail_chunks=8) — cone_steps changes the certified starts,
        # so the per-view oracle must march the same schedule.
        single = render.render_depth(
            sphere_sdf, cam, num_steps=48, corner_table=corner_table,
            early_exit=True, coarse_factor=4, head_steps=0, tail_chunks=8,
            cone_steps=32, cone_tail_chunks=8)
        np.testing.assert_array_equal(np.asarray(out.depth[i]),
                                      np.asarray(single.depth))
        np.testing.assert_array_equal(np.asarray(out.hit[i]),
                                      np.asarray(single.hit))


@pytest.mark.slow
def test_block_tail_miss_certificate(sphere_sdf, corner_table):
    """The head_steps=0 block-tail schedule retires rays whose block cone
    ESCAPED the grid still-safe (a proof that no surface lies anywhere on
    their in-grid span). On a miss-heavy frame the certificate must
    actually fire, and depth/hit must still equal the plain march exactly
    (retired rays get the same final sample as marched ones)."""
    # Wide camera: sphere occupies a small fraction of the frame, most
    # blocks' cones fly through empty grid and escape.
    sizes = np.asarray(sphere_sdf.spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 2.5 * sizes[2]])
    cam = render.PinholeCamera.create(pose, 64, 48, focal=30.0)

    base = _jrender(sphere_sdf, cam, num_steps=128,
                    corner_table=corner_table, early_exit=True)
    blocked = _jrender(sphere_sdf, cam, num_steps=128,
                       corner_table=corner_table, early_exit=True,
                       coarse_factor=4, head_steps=0,
                       tail_chunks=8)
    _check_cone_equiv(base, blocked, sphere_sdf)
    np.testing.assert_array_equal(np.asarray(base.hit),
                                  np.asarray(blocked.hit))
    # The certificate must be non-vacuous on this frame.
    _, _, _, esc = render._cone_prepass(
        sphere_sdf, cam, 4, 128, 0.25 * sphere_sdf.resolution, 100.0,
        corner_table)
    assert float(np.asarray(esc).mean()) > 0.1
    # And some rays must hit (the frame exercises both paths).
    assert np.asarray(base.hit).any()


def test_block_tail_cone_steps_budget(sphere_sdf, corner_table):
    """cone_steps budget composes with the block-tail schedule: shallower
    certified starts (fewer escapes) stay exact."""
    cam = _camera(sphere_sdf, w=64, h=48)
    base = _jrender(sphere_sdf, cam, num_steps=128,
                    corner_table=corner_table, early_exit=True)
    for cs in (4, 12):
        r = _jrender(sphere_sdf, cam, num_steps=128,
                     corner_table=corner_table, early_exit=True,
                     coarse_factor=4, head_steps=0,
                     tail_chunks=8, cone_steps=cs)
        _check_cone_equiv(base, r, sphere_sdf)
        np.testing.assert_array_equal(np.asarray(base.hit),
                                      np.asarray(r.hit))


@pytest.mark.slow
def test_mip_skip_grazing_band():
    """A far tiny obstacle with grazing silhouette rays: the mip skip must
    never LOSE a hit relative to the plain march (jumps shrink by the
    convergence band), for the default and a loose surface threshold; the
    unshrunk jump leapfrogged grazing query<=thresh dips and flipped hits
    on exactly this scene."""
    res = 0.1
    nx, ny, nz = 16, 16, 256
    spec = GridSpec.from_voxel_counts(res, (nx, ny, nz))
    ii, jj, kk = jnp.meshgrid(jnp.arange(nx, dtype=jnp.float32),
                              jnp.arange(ny, dtype=jnp.float32),
                              jnp.arange(nz, dtype=jnp.float32),
                              indexing="ij")
    d = (jnp.sqrt((ii - 8.0) ** 2 + (jj - 8.0) ** 2
                  + (kk - 240.0) ** 2) - 3.0) * res
    from voxelized_geometry_tools_tpu.core.maps import SignedDistanceField
    sdf = SignedDistanceField.create(spec, d, locked=True)
    mip = render.build_sdf_mip(sdf, factor=8)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.8, 0.8, -6.0)
    cam = render.PinholeCamera.create(pose, 96, 96, focal=700.0)
    for thresh in (0.25 * res, 2 * res):
        kw = dict(num_steps=256, early_exit=True, surface_threshold=thresh)
        base = render.render_depth(sdf, cam, **kw)
        fast = render.render_depth(sdf, cam, mip=mip, coarse_steps=64, **kw)
        bh, fh = np.asarray(base.hit), np.asarray(fast.hit)
        assert bh.sum() > 100
        assert not (bh & ~fh).any(), "mip skip lost hits"
        m = bh & fh
        dd = np.abs(np.asarray(base.depth)[m] - np.asarray(fast.depth)[m])
        assert float(dd.max()) <= 2 * thresh + 1e-5


def test_with_stats_is_bitwise_free_and_counts_rows(sphere_sdf,
                                                    corner_table):
    """The roofline-audit surface (round-5): with_stats=True must be a
    pure observer — counters ride existing loop carries, so the result
    agrees with the default path to the ulp (the extra outputs can shift
    XLA fusion, so bitwise is compilation-dependent, not contractual) —
    and gather_rows_from_stats must account every phase (at least one
    row per final sample plus the cone/tail work)."""
    cam = _camera(sphere_sdf, w=48, h=32)
    kw = dict(num_steps=64, corner_table=corner_table, early_exit=True,
              coarse_factor=8, head_steps=0, tail_chunks=8, cone_steps=32,
              cone_tail_chunks=4)
    plain = jax.jit(lambda: render.render_depth(sphere_sdf, cam,
                                                **kw).depth)()
    result, stats = jax.jit(lambda: render.render_depth(
        sphere_sdf, cam, with_stats=True, **kw))()
    np.testing.assert_allclose(np.asarray(plain),
                                np.asarray(result.depth), atol=1e-5)
    stats = jax.tree.map(np.asarray, stats)
    rows = render.gather_rows_from_stats(stats)
    n_rays = 48 * 32
    assert rows > 0
    # Sparse final sample (round-5): only chunks containing an in-grid
    # non-converged (needy) ray issue gathers, so the count is a multiple
    # of the chunk width, positive (certificate-retired blocks are needy
    # by construction on this scene), and never exceeds the dense count.
    assert 0 < stats["final_sample_rows"] <= n_rays
    assert stats["final_sort_blocks"] > 0
    cone = stats["cone_stages"][0]
    assert int(cone["head_iters"]) > 0  # the prepass actually marched
    assert (stats["fine_tail_iters"] >= 0).all()
    # The 8-gather (no corner table) march costs 8 rows per sample.
    rows8 = render.gather_rows_from_stats(stats, gathers_per_sample=8.0)
    assert rows8 > rows


def test_sparse_final_sample_matches_dense_resample(sphere_sdf,
                                                    corner_table):
    """The block-tail schedule's SPARSE final sample (round-5) must be
    output-equivalent to densely re-sampling the field at the returned
    final positions: converged rays reuse the march's carried sample
    (same expression, same position), escaped rays are proven
    out-of-grid by the gather-free validity predicate, and only needy
    blocks issue real gathers. Covers head_steps=0 and >0 (carry
    threading), with and without the corner table, wide camera so some
    rays miss the grid entirely."""
    sizes = np.asarray(sphere_sdf.spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.5 * sizes[2]])
    cam = render.PinholeCamera.create(pose, 64, 48, focal=24.0)
    for head, ct in ((0, corner_table), (4, corner_table), (0, None)):
        res, st = render.render_depth(
            sphere_sdf, cam, num_steps=48, corner_table=ct,
            early_exit=True, coarse_factor=8, head_steps=head,
            tail_chunks=8, cone_steps=24, cone_tail_chunks=4,
            with_stats=True)
        if ct is not None:
            q = sdf_query.estimate_location_distance_fast(
                sphere_sdf, ct, res.points)
        else:
            q = sdf_query.estimate_location_distance(sphere_sdf, res.points)
        dense = np.where(np.asarray(q.valid), np.asarray(q.value), np.inf)
        got = np.asarray(res.distance)
        both_inf = np.isinf(dense) & np.isinf(got)
        np.testing.assert_allclose(np.where(both_inf, 0.0, got),
                                   np.where(both_inf, 0.0, dense),
                                   rtol=1e-5, atol=1e-6)
        # The sparse counter never exceeds the dense count and the audit
        # accounts its permutes. head_steps > 0 has no cone-slowness sort
        # key, so the block-tail (and with it the sparse final) does not
        # engage — that config pins the dense fallback instead.
        n_rays = 64 * 48
        assert 0 <= float(st["final_sample_rows"]) <= n_rays
        if head == 0:
            assert st["final_sort_blocks"] > 0
            assert float(st["final_sample_rows"]) < n_rays
        assert render.gather_rows_from_stats(
            jax.tree.map(np.asarray, st)) > 0


def test_relax_overrelaxation_contract(sphere_sdf, corner_table):
    """Over-relaxed sphere tracing (``relax`` > 1, Keinert-style revert on
    overshoot) preserves the march contract on a grazer-free fixture:
    identical hit sets, common depths within the convergence band, for
    both the plain early-exit march and the full block-tail schedule.
    (It stays opt-in; this test pins that the knob is SOUND, not that it
    is fast.)"""
    cam = _camera(sphere_sdf)
    thresh = 0.25 * sphere_sdf.resolution

    def check(base, rx, om):
        # Hit divergence is allowed ONLY in the tangent-grazer band
        # (sampling ~om x sparser in a sub-threshold dip widens the
        # detection band by that factor — sphere_trace docstring); every
        # other pixel must classify identically, and common hits agree
        # within the convergence band.
        bh, rh = np.asarray(base.hit), np.asarray(rx.hit)
        if (bh != rh).any():
            band = om * 0.2 * sphere_sdf.resolution
            dist = np.where(bh, np.asarray(base.distance),
                            np.asarray(rx.distance))
            bad = (bh != rh) & ~(np.abs(dist - thresh) <= band)
            assert not bad.any(), int(bad.sum())
        m = bh & rh
        dd = np.abs(np.asarray(base.depth)[m] - np.asarray(rx.depth)[m])
        assert float(dd.max()) <= 2 * thresh + 1e-6

    kw = dict(num_steps=64, corner_table=corner_table, early_exit=True)
    base = render.render_depth(sphere_sdf, cam, **kw)
    for om in (1.3, 1.9):
        check(base, render.render_depth(sphere_sdf, cam, relax=om, **kw),
              om)
    # Full schedule (cone prepass + block tail + sparse final).
    sched = dict(num_steps=64, corner_table=corner_table, early_exit=True,
                 coarse_factor=8, head_steps=0, tail_chunks=8,
                 cone_steps=32, cone_tail_chunks=4)
    base2 = render.render_depth(sphere_sdf, _camera(sphere_sdf, 64, 48),
                                **sched)
    rx2 = render.render_depth(sphere_sdf, _camera(sphere_sdf, 64, 48),
                              relax=1.6, **sched)
    check(base2, rx2, 1.6)
    with pytest.raises(ValueError, match="relax"):
        render.render_depth(sphere_sdf, cam, relax=0.5, **kw)
    with pytest.raises(ValueError, match="early_exit"):
        render.render_depth(sphere_sdf, cam, num_steps=64,
                            corner_table=corner_table, relax=1.5)
