"""Triton kernels (phase-2 body sweep, phase-1 panel solve) vs the XLA
reference path.  On the CPU they run in the Pallas interpreter; the same
kernels compile through Triton on a CUDA GPU, where the ``gpu``-marked
test runs them compiled."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.observation import forward as fwd
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.ops.ensrf_triton import body_update


def _setup(nobs=12, nmems=16, seed=4, dtype=jnp.float32, ntimes=2, nvars=1):
    state = make_demo_state(nvars=nvars, ntimes=ntimes, ny=8, nx=8,
                            nmems=nmems, seed=seed)
    obs = make_demo_obs(state, nobs=nobs, seed=seed + 1, radius=700.0)
    batch = ObservationBatch.coerce(obs)
    s = state.structure
    taps = fwd.build_taps(s, batch.lats, batch.lons, batch.times_s,
                          batch.var_indices(s))
    prior = jnp.asarray(np.asarray(state.to_vect()), dtype=dtype)
    ye = fwd.apply_taps_obj(prior, taps)
    row_lat, row_lon = s.row_latlon()
    obs_arr = core.ObsArrays(
        values=jnp.asarray(batch.values, dtype=dtype),
        errors=jnp.asarray(batch.errors, dtype=dtype),
        lats=jnp.asarray(batch.lats, dtype=dtype),
        lons=jnp.asarray(batch.lons, dtype=dtype),
        radii=jnp.asarray(batch.localize_radius, dtype=dtype),
        assim=jnp.asarray(batch.assimilate_flags & taps.qc_ok),
    )
    bm = jnp.mean(prior, axis=1)
    bp = prior - bm[:, None]
    tm = jnp.mean(ye, axis=1).astype(dtype)
    tp = (ye - jnp.mean(ye, axis=1)[:, None]).astype(dtype)
    return (bm, bp, tm, tp,
            jnp.asarray(row_lat, dtype=dtype), jnp.asarray(row_lon, dtype=dtype),
            obs_arr)




def _close(got, ref, tol):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("localize", [True, False])
def test_single_block_matches_xla(localize):
    """One obs block: the kernel equals the XLA block operator."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=8, dtype=jnp.float64)
    tail = core.tail_scan(tm, tp, obs, localize=localize)
    if localize:
        from efa_xray_tpu.observation.localization import gaspari_cohn, haversine

        d = haversine((blat[:, None], blon[:, None]),
                      (obs.lats[None, :], obs.lons[None, :]))
        w = gaspari_cohn(d, obs.radii[None, :]).astype(bp.dtype)
    else:
        w = None
    ref = core.apply_obs_block(bm, bp, tail.ye, tail.gain_coef,
                               tail.sqrt_coef, w)
    got = body_update(bm, bp, blat, blon, tail, obs, localize=localize,
                      geometry="haversine", interpret=True)
    _close(got, ref, 1e-9)


def test_full_blocked_body_matches_xla_multiple_blocks():
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=40)
    tail = core.tail_scan(tm, tp, obs, localize=True)
    ref = core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                  localize=True, block_size=4)
    got = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                      geometry="haversine", block_size=16, interpret=True)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=2e-5, atol=1e-4)


def test_pallas_respects_row_padding():
    """Row count not a multiple of the tile: masked rows must not leak."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=5)
    tail = core.tail_scan(tm, tp, obs, localize=True)
    nrows = bm.shape[0]
    assert nrows % 48 != 0
    bm_p, bp_p = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                             tile=48, interpret=True)
    assert bm_p.shape == (nrows,)
    assert bp_p.shape == bp.shape
    assert np.isfinite(np.asarray(bp_p)).all()


@pytest.mark.parametrize("nmems", [5, 20, 80])
@pytest.mark.parametrize("geometry", ["chordal", "haversine"])
@pytest.mark.parametrize("ntimes", [1, 2], ids=["flat", "gridded"])
def test_body_kernel_matches_xla(ntimes, geometry, nmems):
    """The one body kernel on flat (one var/time) and gridded (vt = 2)
    states, on both geometries and member counts below, at and above the
    padded power of two: float64 equality with the XLA body up to
    reassociation."""
    bm, bp, tm, tp, blat, blon, obs = _setup(
        nobs=37, nmems=nmems, dtype=jnp.float64, ntimes=ntimes, seed=nmems)
    fg = geometry == "chordal"
    tail = core.tail_scan(tm, tp, obs, localize=True, fast_geometry=fg)
    ref = core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                  localize=True, block_size=8,
                                  fast_geometry=fg)
    got = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                      geometry=geometry, tile=32, interpret=True)
    _close(got, ref, 1e-9)


def test_grid_mode_matches_flat_mode():
    """A gridded state's rows are independent: updating the two groups'
    rows as two flat states equals updating the gridded state at once."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=9, nmems=12,
                                             dtype=jnp.float64)
    tail = core.tail_scan(tm, tp, obs, localize=True)
    ngrid = bm.shape[0] // 2
    kw = dict(localize=True, geometry="haversine", tile=16, interpret=True)
    whole = body_update(bm, bp, blat, blon, tail, obs, **kw)
    halves = [body_update(bm[s], bp[s], blat[s], blon[s], tail, obs, **kw)
              for s in (slice(0, ngrid), slice(ngrid, None))]
    _close(whole, [jnp.concatenate([h[0] for h in halves]),
                   jnp.concatenate([h[1] for h in halves])], 1e-12)


def test_grid_mode_with_nondividing_tile():
    """Tile larger than and not dividing the row count: masking stays
    inert."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=5, nmems=8,
                                             dtype=jnp.float64)
    tail = core.tail_scan(tm, tp, obs, localize=True)
    a = body_update(bm, bp, blat, blon, tail, obs, localize=True, tile=16,
                    interpret=True)
    b = body_update(bm, bp, blat, blon, tail, obs, localize=True, tile=256,
                    interpret=True)
    _close(a, b, 1e-12)


def test_body_kernel_odd_row_count():
    """nrows not a multiple of the tile (or of 8): masking keeps results
    exact and output shapes equal to input shapes (the donation-aliasing
    contract: in/out buffers match for ANY row count)."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=9, nmems=12, seed=3)
    n = 123
    bm, bp, blat, blon = bm[:n], bp[:n], blat[:n], blon[:n]
    tail = core.tail_scan(tm, tp, obs, localize=True)
    ref = core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                  localize=True, block_size=3,
                                  fast_geometry=True)
    got = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                      block_size=16, tile=32, interpret=True)
    assert got[0].shape == bm.shape and got[1].shape == bp.shape
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=2e-5, atol=2e-4)


def test_body_kernel_partial_last_block():
    """nobs one past a block boundary: the padded obs of the last block
    are exact no-ops."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=33, nmems=10,
                                             dtype=jnp.float64)
    tail = core.tail_scan(tm, tp, obs, localize=True)
    ref = core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                  localize=True, block_size=33)
    got = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                      geometry="haversine", block_size=16, interpret=True)
    _close(got, ref, 1e-9)


def test_fused_v4_matches_xla_exact():
    """Chordal kernel vs the exact-geometry XLA body (weight-formula
    tolerance)."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=9, nmems=12, seed=8)
    tail = core.tail_scan(tm, tp, obs, localize=True)
    ref = core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                  localize=True, block_size=3)
    got = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                      geometry="chordal", tile=48, interpret=True)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=2e-4, atol=2e-3)


def _vertical_obs(obs, nrows, dtype, seed):
    rng = np.random.default_rng(seed)
    body_vert = jnp.asarray(np.repeat([500.0, 850.0], nrows // 2), dtype)
    n = obs.values.shape[0]
    obs = obs._replace(
        verts=jnp.asarray(rng.uniform(400, 900, n), dtype),
        vert_radii=jnp.asarray(
            np.where(np.arange(n) % 3 == 0, np.inf, 300.0), dtype),
    )
    return body_vert, obs


@pytest.mark.parametrize("geometry", ["chordal", "haversine"])
def test_fused_v4_gridded_state_with_vertical(geometry):
    """Gridded state with vertical localization: the per-row vertical GC
    factor matches the XLA body."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=9, nmems=12, seed=6,
                                             dtype=jnp.float64)
    body_vert, obs = _vertical_obs(obs, bm.shape[0], bp.dtype, 0)
    fg = geometry == "chordal"
    tail = core.tail_scan(tm, tp, obs, localize=True, fast_geometry=fg)
    ref = core.ensrf_blocked_body(
        bm, bp, blat, blon, tail, obs, localize=True, block_size=3,
        fast_geometry=fg, body_vert=body_vert, vertical=True,
    )
    got = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                      geometry=geometry, body_vert=body_vert, vertical=True,
                      tile=32, interpret=True)
    _close(got, ref, 1e-9)


@pytest.mark.parametrize("geometry", ["chordal", "haversine"])
def test_body_kernel_varloc(geometry):
    """Cross-variable localization: the kernel gathers the factor per
    (row, ob) from the small table, as the XLA body applies it."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=11, nmems=10, seed=12,
                                             dtype=jnp.float64, ntimes=1,
                                             nvars=2)
    nrows, nobs = bm.shape[0], obs.values.shape[0]
    varloc = jnp.asarray([[1.0, 0.3], [0.0, 1.0], [1.0, 1.0]])
    row_var = jnp.repeat(jnp.arange(2, dtype=jnp.int32), nrows // 2)
    ob_var = jnp.asarray(np.arange(nobs) % 3, jnp.int32)
    fg = geometry == "chordal"
    vkw = dict(varloc=varloc, row_var=row_var, ob_var=ob_var)
    tail = core.tail_scan(tm, tp, obs, localize=True, fast_geometry=fg,
                          varloc=varloc, ob_var=ob_var)
    ref = core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                  localize=True, block_size=4,
                                  fast_geometry=fg, **vkw)
    got = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                      geometry=geometry, interpret=True, **vkw)
    _close(got, ref, 1e-9)


@pytest.mark.parametrize("fast_geometry", [True, False])
def test_ensrf_class_routes_gridded_fast_geometry_to_v4_grid(fast_geometry):
    """EnSRF with use_pallas on a vt>1 state (kernels in the interpreter)
    must agree with the XLA path end to end."""
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig

    state = make_demo_state(ntimes=3, ny=7, nx=9, nmems=14, seed=15)
    obs = make_demo_obs(state, nobs=30, seed=16, radius=900.0)
    kw = dict(localization="GC", dtype="float32",
              fast_geometry=fast_geometry, tail_panel=16)
    p1, _ = EnSRF(state, list(obs), config=FilterConfig(**kw)).update()
    filt = EnSRF(state, list(obs), config=FilterConfig(
        use_pallas=True, tail_pallas=True, **kw))
    filt.interpret = True
    assert filt._kernels().body and filt._kernels().tail
    p2, _ = filt.update()
    np.testing.assert_allclose(np.asarray(p2.data), np.asarray(p1.data),
                               atol=2e-4)


# ---------------------------------------------------------------------------
# Localization culling + spatial row sorting
# ---------------------------------------------------------------------------


def _scatter_setup(nstate=600, nmems=10, nobs=21, radius=400.0, seed=7,
                   inf_frac=0.2, unassim_frac=0.15):
    """Scattered-row workload with mixed radii (some inf = unlocalized) and
    some unassimilated obs — the cases the cull mask must respect."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-88, 88, nstate)
    lon = rng.uniform(0, 360, nstate)
    prior = rng.normal(280, 3, (nstate, nmems)).astype(np.float32)
    rows = rng.integers(0, nstate, nobs)
    ye = prior[rows]
    radii = np.where(rng.random(nobs) < inf_frac, np.inf,
                     rng.uniform(radius * 0.5, radius * 1.5, nobs))
    obs = core.ObsArrays(
        values=jnp.asarray(ye.mean(1) + rng.normal(0, 1, nobs), jnp.float32),
        errors=jnp.ones(nobs, jnp.float32),
        lats=jnp.asarray(lat[rows], jnp.float32),
        lons=jnp.asarray(lon[rows], jnp.float32),
        radii=jnp.asarray(radii, jnp.float32),
        assim=jnp.asarray(rng.random(nobs) > unassim_frac),
    )
    bm = jnp.asarray(prior.mean(1))
    bp = jnp.asarray(prior - prior.mean(1, keepdims=True))
    tm = jnp.mean(jnp.asarray(ye), axis=1)
    tp = jnp.asarray(ye) - tm[:, None]
    return (bm, bp, tm, tp, jnp.asarray(lat, jnp.float32),
            jnp.asarray(lon, jnp.float32), obs)


@pytest.mark.parametrize("cull,spatial_sort", [(True, False), (False, True),
                                               (True, True)])
def test_fused_cull_and_sort_match_xla(cull, spatial_sort):
    """Culling skips only provably-zero work and row sorting is an exact
    permutation: both reproduce the unculled kernel bit-for-bit and the
    XLA blocked oracle to f32 reassociation."""
    bm, bp, tm, tp, blat, blon, obs = _scatter_setup()
    tail = core.tail_scan(tm, tp, obs, localize=True, fast_geometry=True)
    bm_x, bp_x, *_ = core.ensrf_blocked(
        bm, bp, tm, tp, blat, blon, obs, localize=True, block_size=8,
        fast_geometry=True,
    )
    kw = dict(localize=True, block_size=16, tile=32, interpret=True)
    bm_base, bp_base = body_update(bm, bp, blat, blon, tail, obs,
                                   cull=False, spatial_sort=False, **kw)
    bm_p, bp_p = body_update(bm, bp, blat, blon, tail, obs, cull=cull,
                             spatial_sort=spatial_sort, **kw)
    # Identical arithmetic (skips are multiplications by exact zeros; the
    # sort is a row permutation of row-local work): bitwise equality.
    np.testing.assert_array_equal(np.asarray(bm_p), np.asarray(bm_base))
    np.testing.assert_array_equal(np.asarray(bp_p), np.asarray(bp_base))
    np.testing.assert_allclose(np.asarray(bm_p), np.asarray(bm_x),
                               rtol=2e-5, atol=5e-4)
    np.testing.assert_allclose(np.asarray(bp_p), np.asarray(bp_x),
                               rtol=2e-5, atol=5e-4)


def test_cull_mask_is_conservative():
    """Every (tile, block) pair the mask kills must have identically zero
    Gaspari-Cohn weights for every (assimilated) ob in it."""
    from efa_xray_tpu.observation.localization import (
        gaspari_cohn_np,
        latlon_to_unit,
    )
    from efa_xray_tpu.ops.ensrf_triton import cull_masks

    bm, bp, tm, tp, blat, blon, obs = _scatter_setup(nstate=500, nobs=40,
                                                     radius=900.0, seed=3)
    from efa_xray_tpu.observation.localization import spatial_sort_order

    # Compact tiles and blocks, so that some pairs die.
    ro = np.asarray(spatial_sort_order(blat, blon))
    blat, blon = blat[ro], blon[ro]
    oo = np.asarray(spatial_sort_order(obs.lats, obs.lons))
    obs = jax.tree.map(lambda a: a[oo], obs)
    tile, bsz = 48, 4
    xyz = latlon_to_unit(blat, blon)
    oxyz = latlon_to_unit(obs.lats, obs.lons)
    mask = np.asarray(cull_masks(xyz, oxyz, obs.radii, obs.assim, tile, bsz))

    x = np.asarray(xyz, np.float64)
    o = np.asarray(oxyz, np.float64)
    dist = 6371.0 * np.arccos(np.clip(o @ x.T, -1, 1))  # [nobs, nstate]
    radii = np.asarray(obs.radii, np.float64)
    w = np.stack([np.ones_like(dist[j]) if np.isinf(radii[j])
                  else gaspari_cohn_np(dist[j], radii[j])
                  for j in range(len(radii))])
    w *= np.asarray(obs.assim, np.float64)[:, None]

    nstate = x.shape[0]
    for t in range(mask.shape[0]):
        rows = slice(t * tile, min((t + 1) * tile, nstate))
        for b in range(mask.shape[1]):
            if not mask[t, b]:
                assert not np.any(w[b * bsz:(b + 1) * bsz, rows] != 0.0), (t, b)
    assert (~mask).any()  # the test exercises the cull path at all


def test_sort_spatially_improves_mask_sparsity():
    """Hilbert-sorting rows AND obs must strictly increase the number of
    culled (tile, block) pairs on a scattered global workload."""
    from efa_xray_tpu.observation.localization import (
        latlon_to_unit,
        spatial_sort_order,
    )
    from efa_xray_tpu.ops.ensrf_triton import cull_masks

    rng = np.random.default_rng(11)
    n, nobs, tile, bsz = 4096, 256, 256, 16
    lat = jnp.asarray(rng.uniform(-88, 88, n), jnp.float32)
    lon = jnp.asarray(rng.uniform(0, 360, n), jnp.float32)
    olat = jnp.asarray(rng.uniform(-88, 88, nobs), jnp.float32)
    olon = jnp.asarray(rng.uniform(0, 360, nobs), jnp.float32)
    radii = jnp.full(nobs, 800.0, jnp.float32)
    ok = jnp.ones(nobs, bool)
    xyz = latlon_to_unit(lat, lon)
    oxyz = latlon_to_unit(olat, olon)
    unsorted = cull_masks(xyz, oxyz, radii, ok, tile, bsz)
    ro = spatial_sort_order(lat, lon)
    oo = spatial_sort_order(olat, olon)
    srt = cull_masks(xyz[ro], oxyz[oo], radii[oo], ok, tile, bsz)
    frac_unsorted = float(jnp.mean(unsorted.astype(jnp.float32)))
    frac_sorted = float(jnp.mean(srt.astype(jnp.float32)))
    assert frac_sorted < frac_unsorted
    assert frac_sorted < 0.75


def test_pack_bits_roundtrip():
    """Cull bits: bit i of word w is block 32 w + i, padding bits zero."""
    from efa_xray_tpu.ops.ensrf_triton import pack_bits

    alive = np.random.default_rng(0).random((3, 70)) < 0.5
    words = np.asarray(pack_bits(jnp.asarray(alive))).astype(np.int64)
    assert words.shape == (3, 3)
    back = (words[:, :, None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(back.reshape(3, 96)[:, :70], alive)
    assert not back.reshape(3, 96)[:, 70:].any()


def test_sort_spatially_batch_roundtrip():
    """ObservationBatch spatial sort keeps every field aligned."""
    from conftest import make_demo_obs, make_demo_state
    from efa_xray_tpu.observation.observation import ObservationBatch
    from efa_xray_tpu.observation.thinning import sort_spatially

    state = make_demo_state(ntimes=1, ny=6, nx=6, nmems=8, seed=0)
    batch = ObservationBatch.coerce(make_demo_obs(state, nobs=25, seed=1))
    out = sort_spatially(batch)
    assert sorted(np.asarray(out.values).tolist()) == sorted(
        np.asarray(batch.values).tolist()
    )
    # field alignment: (value, lat, lon, error) tuples are preserved
    a = {(float(v), float(la), float(lo), float(e))
         for v, la, lo, e in zip(batch.values, batch.lats, batch.lons,
                                 batch.errors)}
    b = {(float(v), float(la), float(lo), float(e))
         for v, la, lo, e in zip(out.values, out.lats, out.lons, out.errors)}
    assert a == b


# ---------------------------------------------------------------------------
# Kernel tail solve (tail_scan_blocked(kernels=True))
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("localize", [True, False])
def test_tail_pallas_apply_matches_xla_tail(localize):
    """Routing the panel solve and apply through the kernels reproduces
    the XLA hierarchical tail (and hence the exact serial tail)."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=40, nmems=10,
                                             dtype=jnp.float64)
    ref = core.tail_scan_blocked(tm, tp, obs, localize=localize,
                                 fast_geometry=True, panel=10)
    got = core.tail_scan_blocked(tm, tp, obs, localize=localize,
                                 fast_geometry=True, panel=10,
                                 kernels=True, interpret=True)
    for name in ("tail_mean", "tail_perts", "gain_coef", "sqrt_coef", "ye"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-9, rtol=1e-9, err_msg=name)


def test_tail_pallas_apply_with_skipped_obs():
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=30, nmems=10)
    obs = obs._replace(assim=jnp.asarray(
        np.random.default_rng(5).random(30) > 0.3))
    ref = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                 fast_geometry=True, panel=8)
    got = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                 fast_geometry=True, panel=8,
                                 kernels=True, interpret=True)
    np.testing.assert_allclose(np.asarray(got.tail_perts),
                               np.asarray(ref.tail_perts), atol=5e-4, rtol=0)
    np.testing.assert_array_equal(np.asarray(got.diags.assimilated),
                                  np.asarray(ref.diags.assimilated))


def test_tail_pallas_guards():
    """The tail kernels have no hybrid static column: asking for both
    raises instead of silently dropping the column."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=20, nmems=8)
    with pytest.raises(ValueError):
        core.tail_scan_blocked(tm, tp, obs, localize=True, panel=8,
                               hybrid_alpha=0.5, tail_sigma=jnp.ones(20),
                               static_length=500.0,
                               kernels=True, interpret=True)


@pytest.mark.parametrize("localize", [True, False])
@pytest.mark.parametrize("unbiased", [False, True])
def test_tail_panel_solve_pallas_matches_tail_scan(localize, unbiased):
    """The in-kernel panel solve reproduces ensrf_core.tail_scan exactly
    (float64 interpret mode): slab, ye sequence, coefficients, and all
    four diagnostics, including inf radii and skipped obs."""
    from efa_xray_tpu.observation.localization import (
        chordal_gc_weights, latlon_to_unit)
    from efa_xray_tpu.ops.tail_solve_triton import tail_panel_solve

    rng = np.random.default_rng(11)
    P, M = 24, 10
    lat = rng.uniform(-60, 60, P)
    lon = rng.uniform(0, 360, P)
    tp0 = rng.normal(0, 1, (P, M))
    tp0 -= tp0.mean(1, keepdims=True)
    tm0 = rng.normal(280, 3, P)
    obs = core.ObsArrays(
        values=jnp.asarray(tm0 + rng.normal(0, 1, P)),
        errors=jnp.asarray(rng.uniform(0.5, 2.0, P)),
        lats=jnp.asarray(lat), lons=jnp.asarray(lon),
        radii=jnp.asarray(np.where(rng.random(P) < 0.2, np.inf, 2000.0)),
        assim=jnp.asarray(rng.random(P) > 0.25),
    )
    sol = core.tail_scan(jnp.asarray(tm0), jnp.asarray(tp0), obs,
                         localize=localize, unbiased=unbiased,
                         fast_geometry=True)
    if localize:
        xyz = latlon_to_unit(obs.lats, obs.lons)
        wmat = chordal_gc_weights(xyz[None, :, :], xyz[:, None, :],
                                  obs.radii[:, None])
    else:
        wmat = jnp.ones((P, P))
    got = tail_panel_solve(
        jnp.asarray(tm0), jnp.asarray(tp0), obs.values, obs.errors,
        obs.assim, wmat, unbiased=unbiased, interpret=True)
    refs = (sol.tail_mean, sol.tail_perts, sol.ye, sol.gain_coef,
            sol.sqrt_coef, sol.diags.prior_mean, sol.diags.prior_var,
            sol.diags.post_mean, sol.diags.post_var)
    for name, a, b in zip(
            "tm tp ye gain sqrt pm pv om ov".split(), got, refs):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=1e-9, err_msg=name)


def test_tail_pallas_single_panel_pads_and_slices():
    """nobs <= panel: the whole batch is ONE kernel panel solve; outputs
    keep nobs rows and match the XLA tail."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=13, nmems=10, seed=9)
    ref = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                 fast_geometry=True, panel=32)
    got = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                 fast_geometry=True, panel=32,
                                 kernels=True, interpret=True)
    assert got.ye.shape == ref.ye.shape == (13, 10)
    np.testing.assert_allclose(np.asarray(got.tail_mean),
                               np.asarray(ref.tail_mean), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.tail_perts),
                               np.asarray(ref.tail_perts), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.gain_coef),
                               np.asarray(ref.gain_coef), atol=5e-4)


def test_tail_pallas_blocked_diags_match_xla():
    """tail_scan_blocked(kernels=True) reproduces the XLA path's
    diagnostics."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=30, nmems=10)
    obs = obs._replace(assim=jnp.asarray(
        np.random.default_rng(6).random(30) > 0.3))
    ref = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                 fast_geometry=True, panel=8)
    got = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                 fast_geometry=True, panel=8,
                                 kernels=True, interpret=True)
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.diags, name)),
            np.asarray(getattr(ref.diags, name)), atol=5e-4, rtol=0,
            err_msg=name)


@pytest.mark.parametrize("variant", ["haversine", "vertical", "varloc"])
def test_tail_kernels_cover_geometry_vertical_varloc(variant):
    """The kernel tail takes exact geometry, vertical localization and
    cross-variable factors (all enter through the XLA-built ob-ob weight
    matrix and the body kernel's per-row factors)."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=29, nmems=9, seed=21,
                                             dtype=jnp.float64)
    kw = dict(localize=True, fast_geometry=variant != "haversine", panel=8)
    if variant == "vertical":
        _, obs = _vertical_obs(obs, 2, tm.dtype, 4)
        kw["vertical"] = True
    if variant == "varloc":
        kw["varloc"] = jnp.asarray([[1.0, 0.2], [0.5, 1.0], [1.0, 1.0]])
        kw["ob_var"] = jnp.asarray(np.arange(29) % 3, jnp.int32)
    ref = core.tail_scan(tm, tp, obs, **{k: v for k, v in kw.items()
                                         if k != "panel"})
    got = core.tail_scan_blocked(tm, tp, obs, kernels=True, interpret=True,
                                 **kw)
    for name in ("tail_mean", "tail_perts", "gain_coef", "sqrt_coef"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-9, rtol=1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# Precision and the compiled kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("setting,expect", [
    (None, jax.lax.Precision.DEFAULT),
    ("default", jax.lax.Precision.DEFAULT),
    ("tensorfloat32", jax.lax.Precision.DEFAULT),
    ("highest", jax.lax.Precision.HIGHEST),
    ("float32", jax.lax.Precision.HIGHEST),
])
def test_kernel_dots_follow_matmul_precision(setting, expect):
    """The kernels' dots take the ambient jax.default_matmul_precision,
    which FilterConfig.matmul_precision sets around every update."""
    from efa_xray_tpu.ops.ensrf_triton import dot_precision

    if setting is None:
        assert dot_precision() == expect
    else:
        with jax.default_matmul_precision(setting):
            assert dot_precision() == expect


@pytest.mark.gpu
def test_compiled_kernels_match_interpreter():
    """On a CUDA GPU: the compiled body and tail kernels equal their
    interpreted runs (true-f32 dots on both sides)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU")
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=70, nmems=20)
    with jax.default_matmul_precision("highest"):
        tail = core.tail_scan_blocked(tm, tp, obs, localize=True, panel=32,
                                      kernels=True)
        tail_i = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                        panel=32, kernels=True,
                                        interpret=True)
        got = body_update(bm, bp, blat, blon, tail, obs, localize=True)
        ref = body_update(bm, bp, blat, blon, tail, obs, localize=True,
                          interpret=True)
    np.testing.assert_allclose(np.asarray(tail.tail_perts),
                               np.asarray(tail_i.tail_perts), atol=1e-4)
    _close(got, ref, 1e-4)
