"""LETKF solver tests (extension beyond the reference; see
``efa_xray_tpu/assimilation/letkf_core.py`` for the math and references).

Key correctness anchors:

* with localization OFF, the LETKF and the serial EnSRF (``unbiased=True``)
  are the same Kalman analysis — mean and covariance must match exactly;
* the Newton-Schulz inverse-sqrt backend must match the eigendecomposition
  backend;
* localization must confine the update to each observation's footprint;
* the symmetric transform must keep perturbations centered.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.assimilation import letkf_core as lcore
from efa_xray_tpu.assimilation.ensrf import EnSRF
from efa_xray_tpu.assimilation.letkf import LETKF
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.parallel import make_mesh


def _toy(ngrid=60, vt=2, nmems=12, nobs=9, seed=0, radius=2000.0,
         ob_sigma=1.0):
    rng = np.random.default_rng(seed)
    ns = ngrid * vt
    prior = rng.normal(280, 4, (ns, nmems))
    glat = rng.uniform(-60, 60, ngrid)
    glon = rng.uniform(0, 360, ngrid)
    rows = rng.integers(0, ngrid, nobs)
    ye = prior.reshape(vt, ngrid, nmems)[0][rows]
    vals = ye.mean(1) + rng.normal(0, ob_sigma, nobs)
    obs = core.ObsArrays(
        values=jnp.asarray(vals),
        errors=jnp.full(nobs, float(ob_sigma) ** 2),
        lats=jnp.asarray(glat[rows]),
        lons=jnp.asarray(glon[rows]),
        radii=jnp.full(nobs, radius),
        assim=jnp.ones(nobs, bool),
    )
    bm = jnp.asarray(prior.mean(1))
    bp = jnp.asarray(prior - prior.mean(1, keepdims=True))
    tm = jnp.asarray(ye.mean(1))
    tp = jnp.asarray(ye - ye.mean(1, keepdims=True))
    return dict(bm=bm, bp=bp, tm=tm, tp=tp, glat=jnp.asarray(glat),
                glon=jnp.asarray(glon), blat=jnp.asarray(np.tile(glat, vt)),
                blon=jnp.asarray(np.tile(glon, vt)), obs=obs, ngrid=ngrid)


def test_unlocalized_matches_serial_ensrf_mean_and_covariance():
    t = _toy()
    bm1, bp1, *_ = core.ensrf_serial(
        t["bm"], t["bp"], t["tm"], t["tp"], t["blat"], t["blon"], t["obs"],
        localize=False, unbiased=True,
    )
    bm2, bp2, *_ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"],
        ngrid=t["ngrid"], localize=False, sqrt_method="eigh",
    )
    np.testing.assert_allclose(np.asarray(bm1), np.asarray(bm2), atol=1e-10)
    c1 = np.asarray(bp1 @ bp1.T)
    c2 = np.asarray(bp2 @ bp2.T)
    np.testing.assert_allclose(c1, c2, atol=1e-10)


def test_newton_schulz_matches_eigh():
    t = _toy(radius=1500.0)
    kw = dict(ngrid=t["ngrid"], localize=True, k_obs=6)
    bm1, bp1, tm1, tp1, _ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"],
        sqrt_method="eigh", **kw,
    )
    bm2, bp2, tm2, tp2, _ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"],
        sqrt_method="newton_schulz", ns_iters=60, **kw,
    )
    np.testing.assert_allclose(np.asarray(bm1), np.asarray(bm2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(bp1), np.asarray(bp2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(tp1), np.asarray(tp2), atol=1e-9)


def test_localization_confines_update():
    """Grid points beyond 2x the radius from every ob must be untouched."""
    t = _toy(radius=500.0, seed=3)
    bm, bp, *_ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"],
        ngrid=t["ngrid"], localize=True, k_obs=9,
    )
    from efa_xray_tpu.observation.localization import pairwise_distance

    d = np.asarray(
        pairwise_distance(t["blat"], t["blon"], t["obs"].lats, t["obs"].lons)
    )
    far = d.min(axis=1) > 2.0 * 500.0 + 1.0
    assert far.any()  # the toy layout must exercise the far case
    np.testing.assert_allclose(
        np.asarray(bm)[far], np.asarray(t["bm"])[far], atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(bp)[far], np.asarray(t["bp"])[far], atol=1e-12
    )
    near = ~far
    assert np.abs(np.asarray(bm)[near] - np.asarray(t["bm"])[near]).max() > 1e-6


def test_posterior_perturbations_stay_centered():
    t = _toy(seed=4)
    _, bp, _, tp, _ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"],
        ngrid=t["ngrid"], localize=True,
    )
    assert float(jnp.abs(bp.sum(axis=1)).max()) < 1e-10
    assert float(jnp.abs(tp.sum(axis=1)).max()) < 1e-10


def test_patch_sharing_approximates_pointwise():
    # Patch sharing is an approximation for *spatially contiguous* grids:
    # flat-order neighbors must be physical neighbors.  Use a raster row
    # (2-degree spacing) so a 4-point patch spans ~6 degrees against a
    # 4000 km radius.
    t = _toy(ngrid=64, radius=4000.0, seed=5)
    glat = jnp.full(64, 45.0)
    glon = jnp.arange(64, dtype=jnp.float64) * 2.0 + 180.0
    args = (t["bm"], t["bp"], t["tm"], t["tp"], glat, glon, t["obs"])
    bm1, bp1, *_ = lcore.letkf_update(*args, ngrid=t["ngrid"], patch_size=1)
    bm4, bp4, *_ = lcore.letkf_update(*args, ngrid=t["ngrid"], patch_size=4)
    # Patch centroids move weights slightly; the analyses stay close
    # relative to the size of the update itself.
    upd = float(jnp.abs(bm1 - t["bm"]).max())
    diff = float(jnp.abs(bm1 - bm4).max())
    assert upd > 0
    assert diff < 0.2 * upd
    # and exactly equal when every patch member shares a location
    bms, *_ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"],
        jnp.repeat(t["glat"][::4], 4), jnp.repeat(t["glon"][::4], 4),
        t["obs"], ngrid=t["ngrid"], patch_size=4,
    )
    bmp, *_ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"],
        jnp.repeat(t["glat"][::4], 4), jnp.repeat(t["glon"][::4], 4),
        t["obs"], ngrid=t["ngrid"], patch_size=1,
    )
    np.testing.assert_allclose(np.asarray(bms), np.asarray(bmp), atol=1e-10)


def test_assim_mask_removes_influence():
    t = _toy(seed=6)
    obs_off = t["obs"]._replace(assim=jnp.zeros_like(t["obs"].assim))
    bm, bp, tm, tp, diags = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], obs_off,
        ngrid=t["ngrid"], localize=True,
    )
    np.testing.assert_allclose(np.asarray(bm), np.asarray(t["bm"]), atol=1e-10)
    np.testing.assert_allclose(np.asarray(bp), np.asarray(t["bp"]), atol=1e-10)
    assert not bool(np.asarray(diags.assimilated).any())
    assert np.isnan(np.asarray(diags.post_mean)).all()


def test_k_obs_truncation_exact_when_footprint_is_small():
    """With radii small enough that every footprint holds <= k obs, k-NN
    truncation is exact: k=nobs and k=3 must agree."""
    t = _toy(nobs=6, radius=300.0, seed=7)
    args = (t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"])
    bm_full, *_ = lcore.letkf_update(*args, ngrid=t["ngrid"], k_obs=6)
    bm_k3, *_ = lcore.letkf_update(*args, ngrid=t["ngrid"], k_obs=3)
    np.testing.assert_allclose(np.asarray(bm_full), np.asarray(bm_k3),
                               atol=1e-10)


def test_empty_obs_is_identity():
    t = _toy(nobs=0)
    bm, bp, tm, tp, diags = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"],
        ngrid=t["ngrid"],
    )
    np.testing.assert_array_equal(np.asarray(bm), np.asarray(t["bm"]))
    assert diags.prior_mean.shape == (0,)


# ---------------------------------------------------------------------------
# Driver-level (public API) tests
# ---------------------------------------------------------------------------


def test_letkf_api_update_reduces_variance(demo_state):
    obs = make_demo_obs(demo_state, nobs=7, radius=1500.0)
    filt = LETKF(demo_state, obs, inflation=1.05)
    post, batch = filt.update()
    assert post.data.shape == demo_state.data.shape
    assert np.nanmean(batch.post_var) < np.nanmean(batch.prior_var)
    assert batch.assimilated.all()
    # posterior pulls the obs-space estimate toward the measurement
    assert (
        np.abs(batch.values - batch.post_mean).mean()
        < np.abs(batch.values - batch.prior_mean).mean()
    )


def test_letkf_matches_ensrf_unlocalized_api(demo_state):
    obs = make_demo_obs(demo_state, nobs=5)
    cfg_e = FilterConfig(localization=None, dtype="float64",
                         unbiased_variance=True)
    cfg_l = FilterConfig(localization=None, dtype="float64")
    post_e, _ = EnSRF(demo_state, list(obs), config=cfg_e).update()
    post_l, _ = LETKF(demo_state, list(obs), config=cfg_l).update()
    me = np.asarray(post_e.data.mean(axis=-1))
    ml = np.asarray(post_l.data.mean(axis=-1))
    np.testing.assert_allclose(me, ml, atol=1e-9)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs >= 2 devices")
def test_letkf_sharded_matches_single_device():
    # ny*nx = 63 grid points: not divisible by 8 devices (padding case).
    state = make_demo_state(ntimes=2, ny=7, nx=9, nmems=16, seed=9)
    obs = make_demo_obs(state, nobs=9, seed=10, radius=1200.0)
    cfg = FilterConfig(localization="GC", dtype="float64")
    post1, _ = LETKF(state, list(obs), config=cfg).update()
    post2, batch2 = LETKF(state, list(obs), config=cfg,
                          mesh=make_mesh()).update()
    np.testing.assert_allclose(
        np.asarray(post1.data), np.asarray(post2.data), atol=1e-10
    )
    assert np.isfinite(batch2.post_mean[batch2.assimilated]).all()


def test_letkf_sharded_obs_solve_issues_no_collectives():
    """Patches are independent and the tail replicates: the compiled
    sharded LETKF must contain no cross-device collectives (the analog of
    the EnSRF invariant in test_sharded.py)."""
    import re

    from efa_xray_tpu.parallel.sharded import _letkf_sharded_jit

    state = make_demo_state(ntimes=2, ny=8, nx=8, nmems=12, seed=12)
    obs = make_demo_obs(state, nobs=6, seed=13, radius=1200.0)
    filt = LETKF(state, list(obs), config=FilterConfig(dtype="float64"),
                 mesh=make_mesh())
    bm, bp, tm, tp = filt.format_prior_state()
    ob = filt.obs_arrays()
    st = state.structure
    vt = st.nvars * st.ntimes
    g = st.ngrid
    glat, glon = st.grid_latlon_device(jnp.float64)
    ndev = len(jax.devices())
    lowered = _letkf_sharded_jit.lower(
        bm.reshape(vt, g), bp.reshape(vt, g, bp.shape[1]), tm, tp,
        glat, glon, ob.with_default_verts(),
        mesh=make_mesh(), g_local=g // ndev, axis_name="state",
        patch_size=1, k_obs=6, localize=True,
        sqrt_method="newton_schulz", ns_iters=30, chunk=64,
    )
    hlo = lowered.compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in hlo, f"collective {op!r} leaked into the LETKF solve"


# ---------------------------------------------------------------------------
# Vertical (per-level) mode
# ---------------------------------------------------------------------------


def test_letkf_vertical_masks_far_levels():
    """An ob with a tight vertical radius at level A must leave level-B
    rows untouched, and update level-A rows exactly as a horizontal-only
    analysis of the A-level slab would (the ob sits AT level A, so its
    vertical factor there is exactly 1)."""
    t = _toy(ngrid=40, vt=1, nmems=10, nobs=5, seed=11, radius=2000.0)
    # Two level groups sharing the toy's horizontal layout.
    bm2 = jnp.concatenate([t["bm"], t["bm"] + 7.0])
    bp2 = jnp.concatenate([t["bp"], t["bp"] * 0.8])
    body_vert = jnp.concatenate([jnp.full(40, 500.0), jnp.full(40, 850.0)])
    obs_v = t["obs"]._replace(
        verts=jnp.full(5, 500.0), vert_radii=jnp.full(5, 100.0)
    )
    bm, bp, tm, tp, _ = lcore.letkf_update(
        bm2, bp2, t["tm"], t["tp"], t["glat"], t["glon"], obs_v,
        ngrid=40, localize=True, k_obs=5, vertical=True,
        body_vert=body_vert,
    )
    # 850 hPa group: |850-500| = 350 > 2*100 -> zero weight, untouched.
    np.testing.assert_allclose(np.asarray(bm)[40:], np.asarray(bm2)[40:],
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(bp)[40:], np.asarray(bp2)[40:],
                               atol=1e-12)
    # 500 hPa group == horizontal-only analysis of that slab alone.
    bm_h, bp_h, *_ = lcore.letkf_update(
        t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"],
        ngrid=40, localize=True, k_obs=5,
    )
    np.testing.assert_allclose(np.asarray(bm)[:40], np.asarray(bm_h),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(bp)[:40], np.asarray(bp_h),
                               atol=1e-10)


def test_letkf_vertical_api_and_sharded():
    """Driver-level vertical LETKF on a two-level state, single vs mesh."""
    from test_vertical_localization import _ob, make_level_state

    state = make_level_state(nmems=12, ny=6, nx=8, seed=4)
    obs = [_ob(state, vert=500.0, vrad=150.0)]
    cfg = FilterConfig(localization="GC", dtype="float64")
    post1, b1 = LETKF(state, list(obs), config=cfg).update()
    post2, b2 = LETKF(state, list(obs), config=cfg, mesh=make_mesh()).update()
    np.testing.assert_allclose(
        np.asarray(post1.data), np.asarray(post2.data), atol=1e-10
    )
    d = np.asarray(post1.data) - np.asarray(state.data)
    vi_500 = state.structure.var_index("T_500")
    vi_850 = state.structure.var_index("T_850")
    assert np.abs(d[vi_500]).max() > 1e-6  # observed level updated
    np.testing.assert_allclose(d[vi_850], 0.0, atol=1e-12)  # far level inert


def test_letkf_topk_methods_agree_on_cpu():
    """letkf_topk="approx" (lax.approx_max_k) plumbs through the solver;
    on CPU the approximate primitive reduces to exact selection, so the
    analyses must match bitwise — the accelerator recall tradeoff is
    opt-in."""
    from conftest import make_demo_obs, make_demo_state
    from efa_xray_tpu.assimilation.letkf import LETKF

    state = make_demo_state(ntimes=1, ny=10, nx=10, nmems=12, seed=1)
    obs = make_demo_obs(state, nobs=15, seed=2, radius=900.0)
    outs = {}
    for m in ("exact", "approx"):
        cfg = FilterConfig(localization="GC", dtype="float64", letkf_k_obs=8,
                           letkf_chunk=16, letkf_topk=m)
        post, _ = LETKF(state, list(obs), config=cfg, verbose=False).update()
        outs[m] = np.asarray(post.data)
    np.testing.assert_array_equal(outs["exact"], outs["approx"])
    with pytest.raises(ValueError):
        FilterConfig(letkf_topk="bogus")


def _collect_chord_dot_precisions(jaxpr, out):
    """Every dot_general contracting over a size-3 axis (the chordal
    [*, 3] x [3, *] dots), recursing into scan/map/cond sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _rc), _batch = eqn.params["dimension_numbers"]
            lshape = eqn.invars[0].aval.shape
            if any(lshape[d] == 3 for d in lc):
                out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            vals = v if isinstance(v, (tuple, list)) else (v,)
            for item in vals:
                inner = getattr(item, "jaxpr", item)
                if hasattr(inner, "eqns"):
                    _collect_chord_dot_precisions(inner, out)


def test_select_local_obs_matches_f64_oracle():
    """Nearest-k selection must equal exact float64 chord ranking (set
    equality per patch).  On an accelerator this is load-bearing: a
    default-precision f32 matmul may round its inputs (TF32 on a GPU,
    ~200 km of ranking resolution near dot=1) and mis-select patches
    (benchmarks/letkf_select_precision_ab.py); precision=HIGHEST restores
    the oracle set.  Exercises the chunk-padding path (npatch not a
    multiple of chunk)."""
    rng = np.random.default_rng(3)
    npatch, nobs, k = 1000, 300, 16
    plat = np.radians(rng.uniform(-88, 88, npatch))
    plon = np.radians(rng.uniform(0, 360, npatch))
    olat = np.radians(rng.uniform(-88, 88, nobs))
    olon = np.radians(rng.uniform(0, 360, nobs))
    pxyz64 = np.stack([np.cos(plat) * np.cos(plon),
                       np.cos(plat) * np.sin(plon), np.sin(plat)], -1)
    oxyz64 = np.stack([np.cos(olat) * np.cos(olon),
                       np.cos(olat) * np.sin(olon), np.sin(olat)], -1)
    oracle = np.argsort(-(pxyz64 @ oxyz64.T), axis=1, kind="stable")[:, :k]
    idx = np.asarray(lcore.select_local_obs(
        jnp.asarray(pxyz64, jnp.float32), jnp.asarray(oxyz64, jnp.float32),
        k, chunk=256))
    assert idx.shape == (npatch, k)
    mism = sum(frozenset(a) != frozenset(b) for a, b in zip(idx, oracle))
    assert mism == 0


def test_chord_dot_precision_is_highest_in_jaxprs():
    """Regression guard for the reduced-precision mis-ranking: every chordal
    dot in the traced selection AND the full letkf_update must carry
    precision=HIGHEST (CPU runs cannot surface the bug, so the trace is
    the only portable assertion)."""
    import functools

    jx = jax.make_jaxpr(
        lambda p, o: lcore.select_local_obs(p, o, 8, chunk=64)
    )(jnp.zeros((100, 3), jnp.float32), jnp.zeros((50, 3), jnp.float32))
    precs = []
    _collect_chord_dot_precisions(jx.jaxpr, precs)
    assert precs, "no chord dot found in select_local_obs trace"
    for p in precs:
        assert p is not None and all(
            x == jax.lax.Precision.HIGHEST for x in p), p

    t = _toy(nobs=9)
    fn = functools.partial(
        lcore.letkf_update, ngrid=t["ngrid"], patch_size=4, k_obs=5,
        chunk=16)
    jx = jax.make_jaxpr(
        lambda bm, bp, tm, tp, glat, glon, obs: fn(
            bm, bp, tm, tp, glat, glon, obs)
    )(t["bm"], t["bp"], t["tm"], t["tp"], t["glat"], t["glon"], t["obs"])
    precs = []
    _collect_chord_dot_precisions(jx.jaxpr, precs)
    assert precs, "no chord dot found in letkf_update trace"
    for p in precs:
        assert p is not None and all(
            x == jax.lax.Precision.HIGHEST for x in p), p


def test_letkf_solve_precision_plumbs_and_matches_on_cpu():
    """letkf_solve_precision pins the ensemble-space solve chain's matmul
    precision (reduced-precision inputs stall Newton-Schulz at their
    rounding floor; highest converges to the f32 fixed point).  On CPU
    all precisions execute identically, so the analyses must match
    bitwise — the knob's accuracy effect shows only on an accelerator
    (benchmarks/letkf_solve_precision_ab.py)."""
    state = make_demo_state(ntimes=1, ny=10, nx=10, nmems=12, seed=3)
    obs = make_demo_obs(state, nobs=15, seed=4, radius=900.0)
    outs = {}
    for sp in ("default", "high", "highest"):
        cfg = FilterConfig(localization="GC", dtype="float64",
                           letkf_k_obs=8, letkf_chunk=16,
                           letkf_solve_precision=sp)
        post, _ = LETKF(state, list(obs), config=cfg, verbose=False).update()
        outs[sp] = np.asarray(post.data)
    np.testing.assert_array_equal(outs["default"], outs["highest"])
    np.testing.assert_array_equal(outs["default"], outs["high"])
    with pytest.raises(ValueError):
        FilterConfig(letkf_solve_precision="bogus")


def test_letkf_sharded_honors_topk_and_solve_precision():
    """The mesh path must plumb letkf_topk and letkf_solve_precision (it
    previously ignored topk_method silently); sharded == single-device
    for every combination on CPU."""
    state = make_demo_state(ntimes=1, ny=8, nx=16, nmems=10, seed=5)
    obs = make_demo_obs(state, nobs=12, seed=6, radius=1200.0)
    for topk, sp in (("approx", "default"), ("exact", "highest")):
        cfg = FilterConfig(localization="GC", dtype="float64",
                           letkf_k_obs=6, letkf_chunk=8,
                           letkf_topk=topk, letkf_solve_precision=sp)
        p1, _ = LETKF(state, list(obs), config=cfg, verbose=False).update()
        p2, _ = LETKF(state, list(obs), config=cfg, verbose=False,
                      mesh=make_mesh()).update()
        np.testing.assert_allclose(
            np.asarray(p1.data), np.asarray(p2.data), atol=1e-10
        )


# ---------------------------------------------------------------------------
# letkf_topk="host": host-certified EXACT nearest-k selection
# ---------------------------------------------------------------------------


def test_host_candidates_certificate_covers_true_topk():
    """The certified property itself: every patch's brute-force f64
    top-k obs set is contained in its group's candidate set — including
    under adversarial clustering (most obs piled in one corner, so
    candidate-set sizes vary wildly across groups)."""
    from efa_xray_tpu.assimilation.letkf_core import host_select_candidates

    rng = np.random.default_rng(0)
    ny, nx = 24, 36
    lat1 = np.linspace(-80, 80, ny)
    lon1 = np.linspace(0, 350, nx)
    lon, lat = np.meshgrid(lon1, lat1)
    glat, glon = lat.ravel(), lon.ravel()
    # clustered obs: 90% in a 10-degree box, 10% spread out
    nobs = 400
    olat = np.where(rng.uniform(size=nobs) < 0.9,
                    rng.uniform(40, 50, nobs), rng.uniform(-80, 80, nobs))
    olon = np.where(rng.uniform(size=nobs) < 0.9,
                    rng.uniform(100, 110, nobs), rng.uniform(0, 360, nobs))

    for patch, k, chunk in ((1, 8, 64), (4, 16, 96), (8, 33, 50)):
        ngrid = glat.size
        cand, mask, geff = host_select_candidates(
            glat, glon, ngrid, patch, olat, olon, k, chunk=chunk)
        npatch = -(-ngrid // patch)

        def unit(la, lo):
            la, lo = np.radians(la), np.radians(lo)
            return np.stack([np.cos(la) * np.cos(lo),
                             np.cos(la) * np.sin(lo), np.sin(la)], -1)

        gx = unit(glat, glon)
        pad = npatch * patch - ngrid
        if pad:
            gx = np.concatenate([gx, np.repeat(gx[-1:], pad, axis=0)])
        px = gx.reshape(npatch, patch, 3).mean(1)
        px /= np.linalg.norm(px, axis=-1, keepdims=True)
        ox = unit(olat, olon)
        kk = min(k, nobs)
        for p in range(npatch):
            d = np.linalg.norm(ox - px[p], axis=-1)
            true_topk = set(np.argsort(d, kind="stable")[:kk])
            grp = p // geff
            cands = set(cand[grp][mask[grp]])
            assert true_topk <= cands, (patch, k, chunk, p)


def test_host_topk_matches_exact_bitwise_cpu():
    """letkf_topk='host' is EXACT: identical posterior to the on-device
    full top_k across patch sizes, misaligned chunk/group geometry, and
    k > nobs.

    Caveat if this ever fails with a TINY delta: host and exact are two
    different compiled programs; the fuzzer
    (benchmarks/fuzz_host_select.py) found the Newton-Schulz stall exit
    can fire one iteration apart under different XLA fusion (~1e-6 f64
    deltas, both within NS's own accuracy — selections still identical).
    If that starts happening here, assert selection equality + allclose
    instead of bitwise; the SELECTION exactness is the real contract."""
    state = make_demo_state(ntimes=2, ny=18, nx=26, nmems=10, seed=11)
    obs = make_demo_obs(state, nobs=35, seed=12, radius=1100.0)
    for patch, k, chunk in ((1, 12, 100), (8, 16, 48), (4, 999, 64)):
        outs = {}
        for tk in ("exact", "host"):
            cfg = FilterConfig(localization="GC", dtype="float64",
                               letkf_patch_size=patch, letkf_k_obs=k,
                               letkf_chunk=chunk, letkf_topk=tk)
            post, _ = LETKF(state, list(obs), config=cfg,
                            verbose=False).update()
            outs[tk] = np.asarray(post.data)
        np.testing.assert_array_equal(outs["exact"], outs["host"]), (patch, k)


def test_host_topk_mesh_matches_single_device():
    state = make_demo_state(ntimes=1, ny=16, nx=24, nmems=12, seed=13)
    obs = make_demo_obs(state, nobs=25, seed=14, radius=1000.0)
    cfg = FilterConfig(localization="GC", dtype="float64",
                       letkf_patch_size=4, letkf_k_obs=12,
                       letkf_chunk=32, letkf_topk="host")
    p1, _ = LETKF(state, list(obs), config=cfg, verbose=False).update()
    p2, _ = LETKF(state, list(obs), config=cfg, verbose=False,
                  mesh=make_mesh()).update()
    np.testing.assert_allclose(np.asarray(p1.data), np.asarray(p2.data),
                               atol=1e-10)


def test_host_topk_cache_reused_across_filters():
    """Cycle 2+ with the same network skips the host kd-tree build (the
    taps-cache contract, forward.py:build_taps_cached)."""
    import efa_xray_tpu.assimilation.letkf as letkf_mod

    state = make_demo_state(ntimes=1, ny=10, nx=12, nmems=10, seed=15)
    obs = make_demo_obs(state, nobs=12, seed=16, radius=900.0)
    cfg = FilterConfig(localization="GC", dtype="float64",
                       letkf_k_obs=8, letkf_chunk=16, letkf_topk="host")
    before = letkf_mod.sel_build_count
    LETKF(state, list(obs), config=cfg, verbose=False).update()
    assert letkf_mod.sel_build_count == before + 1
    LETKF(state, list(obs), config=cfg, verbose=False).update()
    assert letkf_mod.sel_build_count == before + 1  # cache hit
    obs2 = make_demo_obs(state, nobs=12, seed=99, radius=900.0)
    LETKF(state, list(obs2), config=cfg, verbose=False).update()
    assert letkf_mod.sel_build_count == before + 2  # new network


def test_host_topk_rejects_vertical_localization():
    from test_vertical_localization import _ob, make_level_state

    state = make_level_state()
    ob = _ob(state, vert=500.0, vrad=300.0)
    cfg = FilterConfig(localization="GC", dtype="float64",
                       letkf_topk="host", letkf_k_obs=4, letkf_chunk=8)
    with pytest.raises(ValueError, match="horizontal-only"):
        LETKF(state, [ob], config=cfg, verbose=False).update()


def test_host_candidates_wide_group_fallback():
    """A grid whose row ordering JUMPS around the sphere (shuffled — the
    worst case of a space-curve discontinuity) makes patch groups
    non-local; the builder must fall back to per-patch certificates for
    those groups, keep the candidate width bounded, and stay exact."""
    from efa_xray_tpu.assimilation.letkf_core import host_select_candidates

    rng = np.random.default_rng(21)
    n = 4096
    glat = rng.uniform(-85, 85, n)
    glon = rng.uniform(0, 360, n)  # unsorted: every group is "wide"
    olat = rng.uniform(-85, 85, 500)
    olon = rng.uniform(0, 360, 500)
    k = 16
    cand, mask, geff = host_select_candidates(
        glat, glon, n, 4, olat, olon, k, chunk=128)
    assert cand.shape[1] < 500  # width stayed bounded despite the jumps

    def unit(la, lo):
        la, lo = np.radians(la), np.radians(lo)
        return np.stack([np.cos(la) * np.cos(lo),
                         np.cos(la) * np.sin(lo), np.sin(la)], -1)

    gx = unit(glat, glon)
    px = gx.reshape(-1, 4, 3).mean(1)
    px /= np.linalg.norm(px, axis=-1, keepdims=True)
    ox = unit(olat, olon)
    for p in range(px.shape[0]):
        d = np.linalg.norm(ox - px[p], axis=-1)
        true_topk = set(np.argsort(d, kind="stable")[:k])
        grp = p // geff
        assert true_topk <= set(cand[grp][mask[grp]]), p


def test_letkf_obs_order_hilbert_caller_order_diagnostics():
    """obs_order='hilbert' lives in the Assimilation base: LETKF (and
    EnKF) also return diagnostics in the caller's order.  The LETKF
    analyzes all obs at once, so the posterior must be IDENTICAL under
    any obs permutation (no serial order dependence)."""
    from efa_xray_tpu.assimilation.letkf import LETKF
    from efa_xray_tpu.config import FilterConfig
    from conftest import make_demo_obs, make_demo_state

    state = make_demo_state(nmems=10, seed=3)
    obs = make_demo_obs(state, nobs=11, radius=2000.0, seed=4)
    cfg = FilterConfig(localization="GC", dtype="float64",
                       letkf_k_obs=8, letkf_patch_size=2)
    cfg_h = FilterConfig(localization="GC", dtype="float64",
                         letkf_k_obs=8, letkf_patch_size=2,
                         obs_order="hilbert")
    post, b = LETKF(state, list(obs), config=cfg, verbose=False).update()
    post_h, b_h = LETKF(state, list(obs), config=cfg_h,
                        verbose=False).update()
    np.testing.assert_allclose(np.asarray(post_h.data),
                               np.asarray(post.data),
                               rtol=1e-10, atol=1e-10)
    for f in ("prior_mean", "post_mean", "post_var"):
        np.testing.assert_allclose(
            np.asarray(getattr(b_h, f), dtype=np.float64),
            np.asarray(getattr(b, f), dtype=np.float64),
            rtol=1e-9, atol=1e-10)
