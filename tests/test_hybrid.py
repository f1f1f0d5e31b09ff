"""Hybrid ensemble-static background covariance (serial EnSRF path).

hybrid_alpha = 1 reproduces the pure ensemble filter exactly;
hybrid_alpha = 0 is classic Optimal Interpolation with a Gaspari-Cohn
covariance model, checked against the closed-form scalar OI solution.
An extension — the reference has no static/hybrid covariance at all
(efa_xray/assimilation/ensrf.py works purely from ensemble moments).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.assimilation.ensrf import EnSRF
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.observation.localization import gaspari_cohn_np, haversine


def _toy(nstate=50, nmems=12, nobs=4, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-60, 60, nstate)
    lon = rng.uniform(0, 360, nstate)
    prior = rng.normal(280, 3, (nstate, nmems))
    rows = rng.integers(0, nstate, nobs)
    ye = prior[rows]
    obs = core.ObsArrays(
        values=jnp.asarray(ye.mean(1) + rng.normal(0, 1, nobs), dtype),
        errors=jnp.ones(nobs, dtype),
        lats=jnp.asarray(lat[rows], dtype),
        lons=jnp.asarray(lon[rows], dtype),
        radii=jnp.full(nobs, 3000.0, dtype),
        assim=jnp.ones(nobs, dtype=bool),
    )
    bm = jnp.asarray(prior.mean(1), dtype)
    bp = jnp.asarray(prior - prior.mean(1, keepdims=True), dtype)
    tm = jnp.asarray(ye.mean(1), dtype)
    tp = jnp.asarray(ye - ye.mean(1, keepdims=True), dtype)
    return (bm, bp, tm, tp, jnp.asarray(lat, dtype), jnp.asarray(lon, dtype),
            obs, rows)


def test_alpha_one_is_pure_ensemble():
    bm, bp, tm, tp, blat, blon, obs, _ = _toy()
    ref = core.ensrf_serial(bm, bp, tm, tp, blat, blon, obs, localize=True)
    hyb = core.ensrf_serial(
        bm, bp, tm, tp, blat, blon, obs, localize=True,
        hybrid_alpha=1.0, body_sigma=jnp.full_like(bm, 2.0),
        tail_sigma=jnp.full_like(tm, 2.0), static_length=1000.0,
    )
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(hyb[0]))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(hyb[1]))


def test_alpha_zero_is_optimal_interpolation():
    """One ob, alpha = 0: posterior mean must match the scalar OI solution
    row by row: xa = xb + sig(row) sig(ob) GC(d, L) / (sig(ob)^2 + R) * innov."""
    bm, bp, tm, tp, blat, blon, obs, rows = _toy(nobs=1, seed=3)
    sigma, length, r = 2.5, 1200.0, 1.0
    out = core.ensrf_serial(
        bm, bp, tm, tp, blat, blon, obs, localize=True,
        hybrid_alpha=0.0, body_sigma=jnp.full_like(bm, sigma),
        tail_sigma=jnp.full_like(tm, sigma), static_length=length,
    )
    innov = float(obs.values[0] - tm[0])
    d = np.asarray(haversine((np.asarray(blat), np.asarray(blon)),
                             (float(obs.lats[0]), float(obs.lons[0]))))
    gain = sigma * sigma * gaspari_cohn_np(d, length) / (sigma**2 + r)
    expect = np.asarray(bm) + gain * innov
    np.testing.assert_allclose(np.asarray(out[0]), expect, rtol=1e-9,
                               atol=1e-9)
    # beyond the GC support the state is untouched
    far = d > 2 * length
    if far.any():
        np.testing.assert_array_equal(np.asarray(out[0])[far],
                                      np.asarray(bm)[far])


def test_hybrid_blend_monotone_at_ob_point():
    """At the observed point with an identity pick, the analysis pull is
    finite for every alpha and the hybrid result lies between prior and
    ob.  Needs unbiased=True: the reference's default ddof mismatch
    (ddof-1 covariance over a ddof-0 variance in the gain denominator)
    lets K exceed 1 by up to M/(M-1), so the bound is only exact when the
    ddofs match."""
    bm, bp, tm, tp, blat, blon, obs, rows = _toy(nobs=1, seed=5)
    for a in (0.0, 0.3, 0.7, 1.0):
        out = core.ensrf_serial(
            bm, bp, tm, tp, blat, blon, obs, localize=True, unbiased=True,
            hybrid_alpha=a, body_sigma=jnp.full_like(bm, 2.0),
            tail_sigma=jnp.full_like(tm, 2.0), static_length=1500.0,
        )
        assert np.isfinite(np.asarray(out[0])).all()
        prior_v = float(bm[rows[0]])
        post_v = float(out[0][rows[0]])
        lo, hi = sorted([prior_v, float(obs.values[0])])
        assert lo - 1e-9 <= post_v <= hi + 1e-9


def test_hybrid_via_ensrf_api():
    state = make_demo_state(nmems=14, seed=2)
    obs = make_demo_obs(state, nobs=6, seed=3, radius=1500.0)
    cfg = FilterConfig(localization="GC", dtype="float64", method="serial",
                       hybrid_alpha=0.5, static_b_sigma=1.5,
                       static_b_length=800.0)
    post, batch = EnSRF(state, list(obs), config=cfg, verbose=False).update()
    assert np.isfinite(np.asarray(post.data)).all()
    ok = np.asarray(batch.assimilated, bool)
    d_prior = np.abs(batch.values - batch.prior_mean)[ok]
    d_post = np.abs(batch.values - batch.post_mean)[ok]
    assert d_post.mean() < d_prior.mean()


def test_hybrid_config_validation():
    with pytest.raises(ValueError):
        FilterConfig(hybrid_alpha=0.5)  # missing sigma/length
    with pytest.raises(ValueError):
        # the tail kernels have no static column
        FilterConfig(hybrid_alpha=0.5, static_b_sigma=1.0,
                     static_b_length=500.0, tail_pallas=True)
    with pytest.raises(ValueError):
        FilterConfig(hybrid_alpha=1.5)
    # blocked method + hybrid is now a supported production combination
    FilterConfig(hybrid_alpha=0.5, static_b_sigma=1.0,
                 static_b_length=500.0, method="blocked")


# ---------------------------------------------------------------------------
# Hybrid on the blocked / sharded production paths (VERDICT r2 item 3):
# the static-B column rides the block recurrence, so a hybrid run keeps
# the blocked reformulation and the mesh.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("localize", [True, False])
def test_hybrid_blocked_equals_serial(alpha, localize):
    bm, bp, tm, tp, blat, blon, obs, _ = _toy(nstate=120, nobs=23, seed=7)
    rng = np.random.default_rng(11)
    bsig = jnp.asarray(rng.uniform(1.0, 3.0, bm.shape[0]))
    tsig = jnp.asarray(rng.uniform(1.0, 3.0, tm.shape[0]))
    kw = dict(hybrid_alpha=alpha, body_sigma=bsig, tail_sigma=tsig,
              static_length=1200.0)
    ser = core.ensrf_serial(bm, bp, tm, tp, blat, blon, obs,
                            localize=localize, **kw)
    for block_size, tail_panel in ((8, None), (16, 5), (23, None), (128, 7)):
        blk = core.ensrf_blocked(bm, bp, tm, tp, blat, blon, obs,
                                 localize=localize, block_size=block_size,
                                 tail_panel=tail_panel, **kw)
        for i, name in enumerate(("body_mean", "body_perts", "tail_mean",
                                  "tail_perts")):
            np.testing.assert_allclose(
                np.asarray(blk[i]), np.asarray(ser[i]), atol=1e-9, rtol=0,
                err_msg=f"{name} (block={block_size}, panel={tail_panel})",
            )


def test_hybrid_skipped_obs_blocked_parity():
    """QC-masked obs contribute neither ensemble nor static increments on
    either execution path."""
    bm, bp, tm, tp, blat, blon, obs, _ = _toy(nstate=80, nobs=12, seed=9)
    obs = obs._replace(assim=jnp.asarray(
        np.random.default_rng(1).random(12) > 0.4))
    kw = dict(hybrid_alpha=0.4, body_sigma=jnp.full_like(bm, 2.0),
              tail_sigma=jnp.full_like(tm, 2.0), static_length=900.0)
    ser = core.ensrf_serial(bm, bp, tm, tp, blat, blon, obs, localize=True,
                            **kw)
    blk = core.ensrf_blocked(bm, bp, tm, tp, blat, blon, obs, localize=True,
                             block_size=5, **kw)
    np.testing.assert_allclose(np.asarray(blk[0]), np.asarray(ser[0]),
                               atol=1e-9, rtol=0)
    np.testing.assert_allclose(np.asarray(blk[1]), np.asarray(ser[1]),
                               atol=1e-9, rtol=0)


@pytest.mark.parametrize("method", ["serial", "blocked"])
def test_hybrid_sharded_equals_single_device(method):
    """Hybrid over an 8-device mesh (body_sigma sharded with the rows)
    matches the single-device analysis."""
    from efa_xray_tpu.parallel import make_mesh
    from efa_xray_tpu.parallel.sharded import ensrf_update_sharded

    bm, bp, tm, tp, blat, blon, obs, _ = _toy(nstate=101, nobs=9, seed=13)
    rng = np.random.default_rng(17)
    bsig = jnp.asarray(rng.uniform(1.0, 3.0, bm.shape[0]))
    tsig = jnp.asarray(rng.uniform(1.0, 3.0, tm.shape[0]))
    kw = dict(hybrid_alpha=0.6, body_sigma=bsig, tail_sigma=tsig,
              static_length=1500.0)
    if method == "serial":
        ref = core.ensrf_serial(bm, bp, tm, tp, blat, blon, obs,
                                localize=True, **kw)
    else:
        ref = core.ensrf_blocked(bm, bp, tm, tp, blat, blon, obs,
                                 localize=True, block_size=4, **kw)
    out = ensrf_update_sharded(
        bm, bp, tm, tp, blat, blon, obs, mesh=make_mesh(),
        localize=True, method=method, block_size=4, **kw,
    )
    for i in range(4):
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(ref[i]),
                                   atol=1e-10, rtol=0)


def test_hybrid_via_ensrf_api_blocked_and_mesh():
    """FilterConfig(hybrid, method='blocked') and the mesh path produce the
    same posterior as the serial hybrid through the public API."""
    from efa_xray_tpu.parallel import make_mesh

    state = make_demo_state(nmems=14, seed=2)
    obs = make_demo_obs(state, nobs=6, seed=3, radius=1500.0)

    def run(method, mesh=None):
        cfg = FilterConfig(localization="GC", dtype="float64", method=method,
                           hybrid_alpha=0.5, static_b_sigma=1.5,
                           static_b_length=800.0)
        post, _ = EnSRF(state, list(obs), config=cfg, verbose=False,
                        mesh=mesh).update()
        return np.asarray(post.data)

    serial = run("serial")
    blocked = run("blocked")
    meshed = run("blocked", mesh=make_mesh())
    np.testing.assert_allclose(blocked, serial, atol=1e-9, rtol=0)
    np.testing.assert_allclose(meshed, serial, atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# Hybrid static column IN the Triton body kernel (Pallas interpreter on the
# CPU; compiled through Triton on a CUDA GPU).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("localize", [True, False])
def test_fused_kernel_hybrid_matches_xla_body(alpha, localize):
    from efa_xray_tpu.ops.ensrf_triton import body_update

    rng = np.random.default_rng(0)
    ns, M, no = 200, 10, 24
    lat = rng.uniform(-60, 60, ns)
    lon = rng.uniform(0, 360, ns)
    prior = rng.normal(280, 3, (ns, M)).astype(np.float32)
    rows = rng.integers(0, ns, no)
    ye = prior[rows]
    obs = core.ObsArrays(
        values=jnp.asarray(ye.mean(1) + rng.normal(0, 1, no), jnp.float32),
        errors=jnp.ones(no, jnp.float32),
        lats=jnp.asarray(lat[rows], jnp.float32),
        lons=jnp.asarray(lon[rows], jnp.float32),
        radii=jnp.full(no, 3000.0, jnp.float32),
        assim=jnp.asarray(rng.random(no) > 0.2),
    )
    bm = jnp.asarray(prior.mean(1))
    bp = jnp.asarray(prior - prior.mean(1, keepdims=True))
    tm = jnp.asarray(ye.mean(1))
    tp = jnp.asarray(ye - ye.mean(1, keepdims=True))
    blat = jnp.asarray(lat, jnp.float32)
    blon = jnp.asarray(lon, jnp.float32)
    bsig = jnp.asarray(rng.uniform(1.0, 3.0, ns), jnp.float32)
    tsig = bsig[rows]

    tail = core.tail_scan_blocked(
        tm, tp, obs, localize=localize, fast_geometry=True, panel=8,
        hybrid_alpha=alpha, tail_sigma=tsig, static_length=1500.0)
    bx, px = core.ensrf_blocked_body(
        bm, bp, blat, blon, tail, obs, localize=localize, block_size=8,
        fast_geometry=True, hybrid=True, body_sigma=bsig,
        static_length=1500.0)
    bk, pk = body_update(
        bm, bp, blat, blon, tail, obs, localize=localize, geometry="chordal",
        tile=64, interpret=True, hybrid=True, body_sigma=bsig,
        static_length=1500.0)
    # f32 reassociation (both sides take the static column on the exact
    # great-circle distance)
    np.testing.assert_allclose(np.asarray(bk), np.asarray(bx), atol=5e-4,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(pk), np.asarray(px), atol=5e-4,
                               rtol=0)


def test_hybrid_via_api_pallas_matches_serial():
    """FilterConfig(hybrid, use_pallas=True, fast_geometry=True) routes the
    static column through the body kernel (interpreter) and matches the
    serial hybrid to f32/chordal tolerance."""
    state = make_demo_state(nmems=12, seed=4, dtype="float32")
    obs = make_demo_obs(state, nobs=5, seed=5, radius=1500.0)

    def run(**kw):
        cfg = FilterConfig(localization="GC", dtype="float32",
                           fast_geometry=True, hybrid_alpha=0.5,
                           static_b_sigma=1.5, static_b_length=800.0, **kw)
        filt = EnSRF(state, list(obs), config=cfg, verbose=False)
        filt.interpret = bool(kw.get("use_pallas"))
        post, _ = filt.update()
        return np.asarray(post.data)

    serial = run(method="serial")
    pallas = run(method="blocked", use_pallas=True, block_size=8)
    np.testing.assert_allclose(pallas, serial, atol=2e-3, rtol=0)


def test_hybrid_pallas_config_guard():
    from efa_xray_tpu.ops import select

    with pytest.raises(ValueError):
        # the tail kernels have no static column
        FilterConfig(hybrid_alpha=0.5, static_b_sigma=1.0,
                     static_b_length=500.0, tail_pallas=True)
    # the body kernel carries the static column on both geometries; the
    # auto tail choice then keeps the XLA panel scan
    for fg in (False, True):
        cfg = FilterConfig(hybrid_alpha=0.5, static_b_sigma=1.0,
                           static_b_length=500.0, use_pallas=True,
                           fast_geometry=fg)
        k = select.choose(cfg, interpret=True)
        assert k.body and not k.tail


def test_hybrid_rejected_by_enkf_and_letkf():
    """EnKF/LETKF have no static-B blend; requesting one must be loud, not
    a silent pure-ensemble run (the pre-r3 config guard only covered the
    serial-method restriction, so a hybrid config reaching these solvers
    was ignored)."""
    from efa_xray_tpu.assimilation.enkf import EnKF
    from efa_xray_tpu.assimilation.letkf import LETKF

    state = make_demo_state(nmems=10, seed=6)
    obs = make_demo_obs(state, nobs=3, seed=7, radius=1500.0)
    cfg = FilterConfig(localization="GC", hybrid_alpha=0.5,
                       static_b_sigma=1.0, static_b_length=800.0)
    for cls in (EnKF, LETKF):
        with pytest.raises(ValueError, match="EnSRF solver only"):
            cls(state, list(obs), config=cfg, verbose=False).update()


def test_kernel_hybrid_exact_geometry_matches_xla():
    """Exact-geometry (haversine) localization with the hybrid static
    column in the body kernel matches the XLA body."""
    from efa_xray_tpu.ops.ensrf_triton import body_update

    rng = np.random.default_rng(1)
    ns, M, no = 64, 8, 8
    prior = rng.normal(280, 3, (ns, M))
    rows = rng.integers(0, ns, no)
    ye = prior[rows]
    blat = jnp.asarray(rng.uniform(-60, 60, ns))
    blon = jnp.asarray(rng.uniform(0, 360, ns))
    obs = core.ObsArrays(
        values=jnp.asarray(ye.mean(1) + 1.0),
        errors=jnp.ones(no),
        lats=blat[rows], lons=blon[rows],
        radii=jnp.full(no, 3000.0),
        assim=jnp.ones(no, bool),
    )
    bm = jnp.asarray(prior.mean(1))
    bp = jnp.asarray(prior - prior.mean(1, keepdims=True))
    tm = jnp.asarray(ye.mean(1))
    tp = jnp.asarray(ye - ye.mean(1, keepdims=True))
    bsig = jnp.full(ns, 1.5)
    tail = core.tail_scan_blocked(
        tm, tp, obs, localize=True, panel=4,
        hybrid_alpha=0.5, tail_sigma=bsig[rows], static_length=1500.0)
    ref = core.ensrf_blocked_body(
        bm, bp, blat, blon, tail, obs, localize=True, block_size=4,
        hybrid=True, body_sigma=bsig, static_length=1500.0)
    got = body_update(
        bm, bp, blat, blon, tail, obs, localize=True, geometry="haversine",
        tile=32, interpret=True, hybrid=True, body_sigma=bsig,
        static_length=1500.0)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9,
                                   rtol=1e-9)
