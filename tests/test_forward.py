"""Forward operator: nearest points, interpolation weights, batched apply."""

import numpy as np
import pytest

from conftest import make_demo_state
from efa_xray_tpu.observation import forward as fwd
from efa_xray_tpu.utils import timeutil


def _taps_for(state, lats, lons, times, var_idx=None, **kw):
    s = state.structure
    n = len(lats)
    vi = np.zeros(n, dtype=np.int32) if var_idx is None else np.asarray(var_idx)
    return fwd.build_taps(
        s,
        np.asarray(lats, dtype=np.float64),
        np.asarray(lons, dtype=np.float64),
        timeutil.to_epoch_seconds(times),
        vi,
        **kw,
    )


def test_exact_gridpoint_exact_time_is_identity_pick():
    state = make_demo_state(ny=5, nx=6, ntimes=3)
    s = state.structure
    y0, x0, t0 = 2, 3, 1
    taps = _taps_for(
        state, [s.lat[y0, x0]], [s.lon[y0, x0]], [s.times64()[t0]]
    )
    ye = np.asarray(fwd.apply_taps_obj(state.to_vect(), taps))
    np.testing.assert_allclose(ye[0], np.asarray(state.data)[0, t0, y0, x0], rtol=1e-12)


def test_idw_weights_sum_to_one_and_are_positive():
    state = make_demo_state(ny=8, nx=8)
    s = state.structure
    taps = _taps_for(
        state,
        [44.37, 46.11],
        [236.2, 239.9],
        [s.times64()[0], s.times64()[1]],
    )
    w = np.asarray(taps.weights)
    assert (w >= 0).all()
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-12)


def test_time_interpolation_linear():
    state = make_demo_state(ntimes=3)
    s = state.structure
    t64 = s.times64()
    # Pick an exact grid point so only time weighting matters.
    y0, x0 = 2, 2
    mid = t64[0] + (t64[1] - t64[0]) // 3  # 1/3 of the way to t1
    taps = _taps_for(state, [s.lat[y0, x0]], [s.lon[y0, x0]], [mid])
    ye = np.asarray(fwd.apply_taps_obj(state.to_vect(), taps))
    dense = np.asarray(state.data)
    want = (2.0 / 3.0) * dense[0, 0, y0, x0] + (1.0 / 3.0) * dense[0, 1, y0, x0]
    np.testing.assert_allclose(ye[0], want, rtol=1e-9)


def test_time_weighting_reference_mode_swaps_brackets():
    state = make_demo_state(ntimes=2)
    s = state.structure
    t64 = s.times64()
    y0, x0 = 1, 1
    mid = t64[0] + (t64[1] - t64[0]) // 4
    ours = _taps_for(state, [s.lat[y0, x0]], [s.lon[y0, x0]], [mid])
    ref = _taps_for(
        state, [s.lat[y0, x0]], [s.lon[y0, x0]], [mid], time_weighting="reference"
    )
    w_ours = np.asarray(ours.weights).reshape(4, 2)
    w_ref = np.asarray(ref.weights).reshape(4, 2)
    # The reference mode gives the bracket weights swapped (ensemble.py:218-224)
    np.testing.assert_allclose(w_ours[:, 0], w_ref[:, 1], atol=1e-12)
    np.testing.assert_allclose(w_ours[:, 1], w_ref[:, 0], atol=1e-12)


def test_out_of_time_range_sets_qc_flag_and_zero_weights():
    state = make_demo_state(ntimes=2)
    s = state.structure
    before = s.times64()[0] - np.timedelta64(1, "h")
    after = s.times64()[-1] + np.timedelta64(1, "h")
    inside = s.times64()[0]
    taps = _taps_for(
        state, [45.0, 45.0, 45.0], [236.0, 236.0, 236.0], [before, after, inside]
    )
    np.testing.assert_array_equal(taps.qc_ok, [False, False, True])
    w = np.asarray(taps.weights)
    assert (w[:2] == 0).all()
    assert w[2].sum() == pytest.approx(1.0)


def test_multi_variable_taps_select_right_variable():
    state = make_demo_state(nvars=2)
    s = state.structure
    y0, x0 = 1, 2
    taps = _taps_for(
        state,
        [s.lat[y0, x0]] * 2,
        [s.lon[y0, x0]] * 2,
        [s.times64()[0]] * 2,
        var_idx=[0, 1],
    )
    ye = np.asarray(fwd.apply_taps_obj(state.to_vect(), taps))
    dense = np.asarray(state.data)
    np.testing.assert_allclose(ye[0], dense[0, 0, y0, x0], rtol=1e-12)
    np.testing.assert_allclose(ye[1], dense[1, 0, y0, x0], rtol=1e-12)


def test_interpolate_matches_manual_idw():
    """Full interpolate path vs a hand-rolled IDW + linear-time oracle."""
    state = make_demo_state(ny=6, nx=6, ntimes=2)
    s = state.structure
    lat, lon = 45.3, 237.1
    t = s.times64()[0] + np.timedelta64(2, "h")  # 1/3 between 6-hourly times
    est = np.asarray(state.interpolate(state.vars()[0], t, lat, lon))

    # oracle
    from efa_xray_tpu.observation.localization import gaspari_cohn_np

    def hav(lat1, lon1, lat2, lon2):
        R = 6371.0
        p1, p2 = np.radians(lat1), np.radians(lat2)
        a = (
            np.sin((p2 - p1) / 2) ** 2
            + np.cos(p1) * np.cos(p2) * np.sin(np.radians(lon2 - lon1) / 2) ** 2
        )
        return 2 * R * np.arctan2(np.sqrt(a), np.sqrt(1 - a))

    d = hav(s.lat, s.lon, lat, lon).ravel()
    near = np.argsort(d)[:4]
    wsp = 1.0 / d[near]
    wsp /= wsp.sum()
    dense = np.asarray(state.data)[0].reshape(2, -1, s.nmems)
    f0 = (dense[0][near] * wsp[:, None]).sum(axis=0)
    f1 = (dense[1][near] * wsp[:, None]).sum(axis=0)
    want = (2.0 / 3.0) * f0 + (1.0 / 3.0) * f1
    np.testing.assert_allclose(est, want, rtol=1e-9)


def test_nearest_metric_reference_proxy_runs():
    state = make_demo_state()
    s = state.structure
    taps = _taps_for(
        state, [45.0], [236.0], [s.times64()[0]], metric="reference_proxy"
    )
    assert taps.qc_ok[0]
    assert np.asarray(taps.weights).sum() == pytest.approx(1.0)


def test_pluggable_forward_operator():
    """Custom H callables (the reference's promised-but-unimplemented
    pluggable operators, observation.py:44-46) flow through the filter."""
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.observation.observation import Observation
    from conftest import make_demo_obs

    state = make_demo_state(nmems=12)
    s = state.structure

    def layer_mean_h(st):
        # e.g. a crude "satellite" operator: domain-average at time 0
        import jax.numpy as jnp

        return jnp.mean(st.data[0, 0], axis=(0, 1))

    true_ye = np.asarray(layer_mean_h(state), dtype=np.float64)
    custom = Observation(
        value=float(true_ye.mean() + 0.5), obtype=s.var_names[0],
        time=s.times64()[0], error=0.5, lat=46.0, lon=237.0,
        assimilate_this=True, localize_radius=None,
        forward_operator=layer_mean_h,
    )
    plain = make_demo_obs(state, nobs=2)
    filt = EnSRF(state, [custom] + plain,
                 config=FilterConfig(localization="GC", dtype="float64"))
    post, batch = filt.update()
    # The custom ob's prior mean must come from its own operator, not
    # interpolation at (lat, lon).
    assert batch.prior_mean[0] == pytest.approx(true_ye.mean(), abs=1e-9)
    assert batch.assimilated.all()


def test_custom_operator_with_nonstate_obtype_and_out_of_range_time():
    """Custom-H obs need not name a state variable and bypass the
    interpolation time-window QC (found by code review: both previously
    crashed or were silently dropped)."""
    import numpy as _np
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.observation.observation import Observation

    state = make_demo_state(nmems=10)
    s = state.structure

    def h(st):
        import jax.numpy as jnp

        return jnp.mean(st.data[0], axis=(0, 1, 2))

    true_ye = np.asarray(h(state), dtype=np.float64)
    ob = Observation(
        value=float(true_ye.mean() + 1.0),
        obtype="satellite_radiance_ch4",  # NOT a state variable
        time=s.times64()[-1] + _np.timedelta64(5, "D"),  # outside the window
        error=0.5, lat=45.0, lon=236.0, assimilate_this=True,
        localize_radius=None, forward_operator=h,
    )
    filt = EnSRF(state, [ob], config=FilterConfig(localization="GC",
                                                  dtype="float64"))
    post, batch = filt.update()
    assert batch.assimilated.all()
    assert batch.prior_mean[0] == pytest.approx(true_ye.mean(), abs=1e-9)
    # and it actually moved the state
    assert np.abs(np.asarray(post.data) - np.asarray(state.data)).max() > 0


def test_taps_topk_approx_matches_exact():
    """Opt-in approx candidate selection (FilterConfig.taps_topk): the
    4*npt over-selection + exact rescore must reproduce the exact search
    on a moderate grid (the true nearest points sit far inside the
    candidate set)."""
    state = make_demo_state(ny=24, nx=36, ntimes=2)
    s = state.structure
    rng = np.random.default_rng(0)
    n = 64
    lats = rng.uniform(s.lat.min() + 0.5, s.lat.max() - 0.5, n)
    lons = rng.uniform(s.lon.min() + 0.5, s.lon.max() - 0.5, n)
    times = np.repeat(s.times64()[:1], n)
    exact = _taps_for(state, lats, lons, times)
    approx = _taps_for(state, lats, lons, times, topk_method="approx")
    np.testing.assert_array_equal(
        np.sort(np.asarray(exact.rows), axis=1),
        np.sort(np.asarray(approx.rows), axis=1),
    )
    np.testing.assert_allclose(
        np.asarray(exact.weights), np.asarray(approx.weights), atol=1e-12
    )


# ---------------------------------------------------------------------------
# Module-level taps cache (stationary-network amortization across cycles)
# ---------------------------------------------------------------------------


def _cached_taps_for(state, lats, lons, times, var_idx=None, **kw):
    s = state.structure
    n = len(lats)
    vi = np.zeros(n, dtype=np.int32) if var_idx is None else np.asarray(var_idx)
    return fwd.build_taps_cached(
        s,
        np.asarray(lats, dtype=np.float64),
        np.asarray(lons, dtype=np.float64),
        timeutil.to_epoch_seconds(times),
        vi,
        **kw,
    )


def test_taps_cache_hits_on_repeat_and_misses_on_change():
    state = make_demo_state(ny=6, nx=7, ntimes=2)
    s = state.structure
    lats = [s.lat[1, 1], s.lat[3, 4]]
    lons = [s.lon[1, 1], s.lon[3, 4]]
    times = [s.times64()[0], s.times64()[1]]

    n0 = fwd.taps_build_count
    t1 = _cached_taps_for(state, lats, lons, times)
    assert fwd.taps_build_count == n0 + 1
    t2 = _cached_taps_for(state, lats, lons, times)
    assert fwd.taps_build_count == n0 + 1  # hit: no rebuild
    assert t2 is t1
    # Parity with the uncached builder
    ref = _taps_for(state, lats, lons, times)
    np.testing.assert_array_equal(np.asarray(t1.rows), np.asarray(ref.rows))
    np.testing.assert_allclose(
        np.asarray(t1.weights), np.asarray(ref.weights), rtol=0, atol=0
    )

    # Moved network -> miss
    _cached_taps_for(state, [s.lat[2, 2], s.lat[4, 5]],
                     [s.lon[2, 2], s.lon[4, 5]], times)
    assert fwd.taps_build_count == n0 + 2
    # Different build parameters -> miss
    _cached_taps_for(state, lats, lons, times, npt=2)
    assert fwd.taps_build_count == n0 + 3
    # Different structure -> miss (content-keyed, not identity-keyed)
    other = make_demo_state(ny=5, nx=5, ntimes=2)
    os_ = other.structure
    _cached_taps_for(other, [os_.lat[1, 1]], [os_.lon[1, 1]],
                     [os_.times64()[0]])
    assert fwd.taps_build_count == n0 + 4


def test_taps_cache_amortizes_across_filter_objects():
    """Cycle 2+ of a cycling workload (fresh EnSRF object, same structure,
    same obs coordinates, NEW obs values) skips the forward-operator
    rebuild entirely."""
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.observation.observation import ObservationBatch

    state = make_demo_state(ny=6, nx=6, ntimes=2, nmems=8)
    s = state.structure

    def batch(shift):
        n = 3
        return ObservationBatch(
            values=np.asarray([280.0 + shift, 281.0, 279.5]),
            errors=np.ones(n),
            lats=np.asarray([s.lat[1, 1], s.lat[2, 3], s.lat[4, 4]]),
            lons=np.asarray([s.lon[1, 1], s.lon[2, 3], s.lon[4, 4]]),
            times_s=timeutil.to_epoch_seconds(
                np.asarray([s.times64()[0]] * n)
            ),
            obtypes=[s.var_names[0]] * n,
            localize_radius=np.full(n, 1500.0),
            assimilate_flags=np.ones(n, dtype=bool),
            verts=np.full(n, np.nan),
            descriptions=[None] * n,
        )

    n0 = fwd.taps_build_count
    post1, _ = EnSRF(state, batch(0.0), verbose=False, loc="GC").update()
    assert fwd.taps_build_count == n0 + 1
    # next cycle: same network, new values, new filter object -> cache hit
    post2, _ = EnSRF(post1, batch(1.0), verbose=False, loc="GC").update()
    assert fwd.taps_build_count == n0 + 1


# ---------------------------------------------------------------------------
# Separable-grid host-side nearest-point fast path (taps_search="auto")
# ---------------------------------------------------------------------------

def _global_state(ny=61, nx=120, ntimes=2, nmems=8, south_up=True,
                  gaussian_lats=False):
    from efa_xray_tpu.state.ensemble import EnsembleState

    rng = np.random.default_rng(3)
    if gaussian_lats:
        # non-uniform (Gaussian-quadrature-like) latitude spacing
        lat1d = np.degrees(np.arcsin(np.polynomial.legendre.leggauss(ny)[0]))
        lat1d.sort()
    else:
        # pole rows excluded: a grid row AT the pole holds nx copies of one
        # physical point, so nearest-4 membership there is a 120-way exact
        # tie that the two search paths may break differently (both
        # validly) — test_separable_fast_path_pole_row_grid covers poles.
        lat1d = np.linspace(-89.7, 89.7, ny)
    if not south_up:
        lat1d = lat1d[::-1]
    lon1d = np.arange(nx) * (360.0 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(ntimes) * np.timedelta64(6, "h")
    field = 280.0 + rng.normal(0, 5, (ntimes, ny, nx, nmems))
    return EnsembleState.from_vardict(
        {"T2m": field},
        {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)},
    )


def _dense_h(taps, nstate):
    """Dense [nobs, nstate] operator; the order-free equality check."""
    rows = np.asarray(taps.rows)
    w = np.asarray(taps.weights)
    h = np.zeros((rows.shape[0], nstate))
    for i in range(rows.shape[0]):
        np.add.at(h[i], rows[i], w[i])
    return h


def _adversarial_obs(s, rng, n_random=40):
    """Random obs plus pole / dateline-seam / exact-grid-point adversaries."""
    lats = np.concatenate([
        rng.uniform(-89.5, 89.5, n_random),
        [89.97, -89.97, 0.0, 45.0, s.lat[3, 5], s.lat[-1, 0]],
    ])
    lons = np.concatenate([
        rng.uniform(0.0, 360.0, n_random),
        [359.995, 0.004, 180.0, 179.999, s.lon[3, 5], s.lon[-1, 0]],
    ])
    return lats, lons


@pytest.mark.parametrize("south_up", [True, False])
@pytest.mark.parametrize("gaussian_lats", [False, True])
def test_separable_fast_path_matches_device_search(south_up, gaussian_lats):
    state = _global_state(south_up=south_up, gaussian_lats=gaussian_lats)
    s = state.structure
    rng = np.random.default_rng(11)
    lats, lons = _adversarial_obs(s, rng)
    times = [s.times64()[0]] * len(lats)
    t_auto = _taps_for(state, lats, lons, times, search="auto")
    t_dev = _taps_for(state, lats, lons, times, search="device")
    np.testing.assert_allclose(
        _dense_h(t_auto, s.nstate), _dense_h(t_dev, s.nstate), atol=1e-12
    )
    assert np.array_equal(t_auto.qc_ok, t_dev.qc_ok)


def test_separable_fast_path_pole_row_grid():
    """Grids whose first/last rows sit exactly AT the poles (nx duplicate
    physical points per pole row) — selected-point distances must match the
    device search exactly, and ye must match on any field that is constant
    along each latitude row (tie choice between physically identical
    points is then invisible, as it is for real pole-capped fields)."""
    from efa_xray_tpu.state.ensemble import EnsembleState

    ny, nx, nmems = 31, 60, 6
    lat1d = np.linspace(-90.0, 90.0, ny)
    lon1d = np.arange(nx) * (360.0 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.asarray([np.datetime64("2026-08-01T00")])
    rng = np.random.default_rng(7)
    # row-constant field: value depends on latitude (and member) only
    field = (280.0 + 3.0 * np.sin(np.radians(lat1d)))[None, :, None, None]
    field = np.broadcast_to(
        field + rng.normal(0, 1, (1, ny, 1, nmems)), (1, ny, nx, nmems)
    ).copy()
    state = EnsembleState.from_vardict(
        {"T2m": field},
        {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)},
    )
    s = state.structure
    lats = np.asarray([89.999, 89.2, -89.999, -88.0, 0.0])
    lons = np.asarray([13.0, 201.0, 355.0, 6.0, 180.0])
    tt = [s.times64()[0]] * len(lats)
    t_auto = _taps_for(state, lats, lons, tt, search="auto")
    t_dev = _taps_for(state, lats, lons, tt, search="device")
    glat, glon = s.lat.ravel(), s.lon.ravel()
    for taps in (t_auto, t_dev):
        # rows interleave (point, time) taps; ::2 extracts the 4 distinct
        # spatial points (ntimes == 1 here)
        r = (np.asarray(taps.rows) % s.ngrid)[:, ::2]
        d = np.sort(fwd._haversine_np(
            lats[:, None], lons[:, None], glat[r], glon[r]), axis=1)
        if taps is t_auto:
            d_ref = d
        else:
            np.testing.assert_allclose(d, d_ref, atol=1e-9)
    ye_a = np.asarray(fwd.apply_taps_obj(state.to_vect(), t_auto))
    ye_d = np.asarray(fwd.apply_taps_obj(state.to_vect(), t_dev))
    np.testing.assert_allclose(ye_a, ye_d, atol=1e-9)


def test_separable_tie_break_matches_host_and_single_stage_device():
    """Obs EXACTLY equidistant between grid points: every host path and the
    single-stage device top_k must agree on the selected flat indices
    (ascending distance, ties at the lowest flat index).  The two-stage
    chordal device search may legitimately differ here (fp-rounded tie
    resolution among equidistant points — FilterConfig.taps_search note),
    so it is checked only for equal DISTANCES."""
    import jax.numpy as jnp

    lat1 = np.arange(-10.0, 10.1, 5.0)  # 5 rows
    lon1 = np.arange(0.0, 70.1, 10.0)  # 8 cols
    ny, nx = len(lat1), len(lon1)
    glat, glon = np.repeat(lat1, nx), np.tile(lon1, ny)
    # midway between two columns (2-way tie), and midway between four
    # diagonal neighbors on the equator row (4-way tie at npt boundary)
    lats = np.asarray([0.0, 2.5])
    lons = np.asarray([15.0, 15.0])
    for npt in (1, 3, 4):
        idx, cert = fwd._nearest_separable(lat1, lon1, lats, lons, npt)
        assert cert.all()
        full = fwd._host_full_search(glat, glon, lats, lons, npt)
        np.testing.assert_array_equal(idx, full)
        dev = np.asarray(fwd._topk_points(
            jnp.asarray(glat), jnp.asarray(glon),
            jnp.asarray(lats), jnp.asarray(lons), npt, "haversine"))
        np.testing.assert_array_equal(idx, dev)
        mapped = np.asarray(fwd._topk_points_mapped(
            jnp.asarray(glat), jnp.asarray(glon),
            jnp.asarray(lats), jnp.asarray(lons), npt, "haversine", 2,
            "exact"))
        d_host = fwd._haversine_np(lats[:, None], lons[:, None],
                                   glat[idx], glon[idx])
        d_map = fwd._haversine_np(lats[:, None], lons[:, None],
                                  glat[mapped], glon[mapped])
        np.testing.assert_allclose(np.sort(d_host, axis=1),
                                   np.sort(d_map, axis=1), atol=1e-9)


def test_separable_detection_rejects_non_product_grids():
    # curvilinear (rotated) grid
    y, x = np.meshgrid(np.arange(5), np.arange(6), indexing="ij")
    lat = 40.0 + y + 0.1 * x
    lon = 230.0 + x
    assert fwd.separable_grid_axes(lat, lon) is None
    # location list: nx == 1 with scattered points off one meridian
    assert fwd.separable_grid_axes(
        np.asarray([[40.0], [41.0], [47.0]]),
        np.asarray([[230.0], [238.0], [231.0]]),
    ) is None
    # non-monotone longitude axis
    lon2, lat2 = np.meshgrid([350.0, 355.0, 0.0, 5.0], [40.0, 45.0])
    assert fwd.separable_grid_axes(lat2, lon2) is None
    # regular product grid is accepted either way up
    lon3, lat3 = np.meshgrid([10.0, 20.0, 30.0], [50.0, 45.0, 40.0, 35.0])
    axes = fwd.separable_grid_axes(lat3, lon3)
    assert axes is not None and axes[0][0] == 50.0


def test_separable_certificate_fallback_near_pole():
    """A pole-adjacent ob with a deliberately starved candidate window must
    fail the certificate, and the full-search fallback must equal the
    exact answer."""
    lat1 = np.linspace(-89.0, 89.0, 90)  # 2-degree rows, no pole row
    lon1 = np.arange(0.0, 360.0, 30.0)  # 12 coarse columns
    lats = np.asarray([89.9999, -89.9999])
    lons = np.asarray([17.0, 252.0])
    idx, cert = fwd._nearest_separable(lat1, lon1, lats, lons, npt=4,
                                       ncand_rows=2, ncand_cols=4)
    assert not cert.all()  # near the pole every column ties at ~R*dphi
    glat = np.repeat(lat1, len(lon1))
    glon = np.tile(lon1, len(lat1))
    full = fwd._host_full_search(glat, glon, lats, lons, npt=4)
    d_full = np.sort(fwd._haversine_np(
        lats[:, None], lons[:, None], glat[full], glon[full]), axis=1)
    # certificate failures must be repaired to the exact nearest distances
    idx = idx.copy()
    idx[~cert] = full[~cert]
    d_fast = np.sort(fwd._haversine_np(
        lats[:, None], lons[:, None], glat[idx], glon[idx]), axis=1)
    np.testing.assert_allclose(d_fast, d_full, rtol=1e-12)


def test_separable_windowed_search_matches_brute_force():
    """Randomized oracle: the searchsorted-windowed selection must match a
    brute-force full search on every certified ob, across ascending /
    descending axes, Gaussian latitudes, regional longitude spans, and
    out-of-range query longitudes."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        ny = int(rng.integers(3, 80))
        nx = int(rng.integers(3, 160))
        if rng.random() < 0.3:
            lat1 = np.degrees(np.arcsin(np.sort(rng.uniform(-1, 1, ny))))
        else:
            lat1 = np.linspace(-89.5, 89.5, ny)
        if rng.random() < 0.5:
            lat1 = lat1[::-1]
        span = rng.choice([360.0, 40.0])
        lon1 = (np.sort(rng.uniform(0, span, nx)) if span < 360
                else np.arange(nx) * (360.0 / nx))
        if rng.random() < 0.5:
            lon1 = lon1[::-1].copy()
        nobs = 40
        lats = rng.uniform(-90, 90, nobs)
        lons = rng.uniform(-180, 540, nobs)
        idx, cert = fwd._nearest_separable(lat1, lon1, lats, lons, 4)
        glat, glon = np.repeat(lat1, nx), np.tile(lon1, ny)
        full = fwd._host_full_search(glat, glon, lats, lons, 4)
        d_fast = np.sort(fwd._haversine_np(
            lats[:, None], lons[:, None], glat[idx], glon[idx]), axis=1)
        d_full = np.sort(fwd._haversine_np(
            lats[:, None], lons[:, None], glat[full], glon[full]), axis=1)
        bad = cert & ~np.all(np.abs(d_fast - d_full) < 1e-9, axis=1)
        assert not bad.any(), (trial, ny, nx, np.where(bad))


def test_taps_search_device_knob_end_to_end():
    """FilterConfig.taps_search='device' and the default 'auto' produce the
    same posterior through the public API."""
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.observation.observation import ObservationBatch

    state = make_demo_state(ny=8, nx=9, ntimes=2, nmems=10)
    s = state.structure
    n = 6
    rng = np.random.default_rng(5)
    batch = ObservationBatch(
        values=rng.normal(280, 3, n),
        errors=np.ones(n),
        lats=rng.uniform(42.5, 49.5, n),
        lons=rng.uniform(230.5, 243.5, n),
        times_s=timeutil.to_epoch_seconds(np.asarray([s.times64()[0]] * n)),
        obtypes=[s.var_names[0]] * n,
        localize_radius=np.full(n, 1500.0),
        assimilate_flags=np.ones(n, bool),
        verts=np.full(n, np.nan),
        descriptions=[None] * n,
    )
    posts = {}
    for search in ("auto", "device"):
        cfg = FilterConfig(localization="GC", dtype="float64",
                           taps_search=search)
        post, _ = EnSRF(state, batch, config=cfg, verbose=False).update()
        posts[search] = np.asarray(post.data)
    np.testing.assert_allclose(posts["auto"], posts["device"], atol=1e-12)


def test_taps_chord_dot_precision_is_highest():
    """Same regression guard as the LETKF selection: the device
    nearest-point search's chordal [chunk,3]x[3,ngrid] dot must carry
    precision=HIGHEST — a default-precision f32 matmul may round its
    inputs (TF32 on a GPU: ~200 km of ranking resolution near dot=1) and
    the top-m candidate set then misses true nearest points outright
    (benchmarks/taps_search_ab.py)."""
    import jax
    import jax.numpy as jnp

    from test_letkf import _collect_chord_dot_precisions
    from efa_xray_tpu.observation.forward import _topk_points_mapped

    glat = jnp.zeros(512, jnp.float32)
    glon = jnp.zeros(512, jnp.float32)
    jx = jax.make_jaxpr(
        lambda gla, glo, la, lo: _topk_points_mapped(
            gla, glo, la, lo, 4, "haversine", 64)
    )(glat, glon, jnp.zeros(64, jnp.float32), jnp.zeros(64, jnp.float32))
    precs = []
    _collect_chord_dot_precisions(jx.jaxpr, precs)
    assert precs, "no chord dot found in _topk_points_mapped trace"
    for p in precs:
        assert p is not None and all(
            x == jax.lax.Precision.HIGHEST for x in p), p


def test_observation_batch_take_and_spatial_sort():
    """take() permutes every per-ob field; spatial_sort returns a
    Hilbert-ordered copy plus the order to invert diagnostics."""
    from efa_xray_tpu.observation.observation import ObservationBatch
    from efa_xray_tpu.utils import timeutil

    rng = np.random.default_rng(7)
    n = 50
    times = np.repeat(np.datetime64("2026-08-01T00"), n)
    batch = ObservationBatch(
        values=rng.normal(280, 5, n),
        errors=np.ones(n),
        lats=rng.uniform(-80, 80, n),
        lons=rng.uniform(0, 360, n),
        times_s=timeutil.to_epoch_seconds(times),
        obtypes=[f"T{i % 3}" for i in range(n)],
        localize_radius=np.full(n, 1500.0),
        assimilate_flags=rng.random(n) > 0.3,
        verts=np.full(n, np.nan),
        descriptions=[f"ob-{i}" for i in range(n)],
    )
    batch.prior_mean = rng.normal(280, 5, n)  # a filled result slot
    srt, order = batch.spatial_sort()
    assert sorted(order.tolist()) == list(range(n))
    np.testing.assert_array_equal(srt.values, batch.values[order])
    np.testing.assert_array_equal(srt.lats, batch.lats[order])
    np.testing.assert_array_equal(srt.assimilate_flags,
                                  batch.assimilate_flags[order])
    np.testing.assert_array_equal(srt.prior_mean, batch.prior_mean[order])
    assert srt.obtypes == [batch.obtypes[i] for i in order]
    assert srt.descriptions == [batch.descriptions[i] for i in order]
    # round trip back to the caller's order
    back = srt.take(np.argsort(order))
    np.testing.assert_array_equal(back.values, batch.values)
    assert back.obtypes == batch.obtypes
    # sorted order improves spatial locality: mean hop distance shrinks
    def hops(b):
        return np.mean(np.abs(np.diff(b.lats)) + np.abs(np.diff(b.lons)))
    assert hops(srt) < hops(batch)
