"""Vertical localization (extension; the reference carries ``vert`` unused).

Total weight = horizontal GC x vertical GC on |row_vert - ob_vert| with a
per-ob vertical halfwidth.  Levels live in the variable axis via
``StateStructure.var_verts``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import make_demo_state
from efa_xray_tpu.assimilation.ensrf import EnSRF
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.observation.observation import Observation
from efa_xray_tpu.state.ensemble import EnsembleState
from efa_xray_tpu.state.structure import StateStructure
from efa_xray_tpu.utils import timeutil


def make_level_state(nmems=15, ny=6, nx=8, seed=0):
    """Two-level state: T_500 (500 hPa) and T_850 (850 hPa)."""
    rng = np.random.default_rng(seed)
    lat1d = np.linspace(42.0, 50.0, ny)
    lon1d = np.linspace(230.0, 244.0, nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(2) * np.timedelta64(6, "h")
    base = rng.normal(270, 3, (2, ny, nx, nmems))
    vardict = {"T_500": base + 0.0, "T_850": base + 15.0}
    coorddict = {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)}
    state = EnsembleState.from_vardict(vardict, coorddict, dtype="float64")
    structure = StateStructure.build(
        state.structure.var_names,
        state.structure.times_s,
        state.structure.lat,
        state.structure.lon,
        nmems,
        var_verts=(500.0, 850.0),
    )
    return EnsembleState(state.data, structure)


def _ob(state, vert, vrad, seed=1):
    s = state.structure
    return Observation(
        value=272.0,
        obtype="T_500",
        time=s.times64()[0],
        error=1.0,
        lat=float(s.lat[2, 3]),
        lon=float(s.lon[2, 3]),
        vert=vert,
        assimilate_this=True,
        localize_radius=5000.0,
        vert_localize_radius=vrad,
    )


def test_vertical_localization_masks_far_levels():
    state = make_level_state()
    ob = _ob(state, vert=500.0, vrad=100.0)  # support 200 hPa: excludes 850
    cfg = FilterConfig(localization="GC", dtype="float64")
    post, batch = EnSRF(state, [ob], config=cfg).update()
    d500 = np.abs(np.asarray(post["T_500"]) - np.asarray(state["T_500"]))
    d850 = np.abs(np.asarray(post["T_850"]) - np.asarray(state["T_850"]))
    assert d500.max() > 1e-6  # the observed level moved
    assert d850.max() < 1e-12  # the far level is fully masked
    assert batch.assimilated.all()


def test_vertical_localization_partial_weight():
    state = make_level_state()
    ob = _ob(state, vert=500.0, vrad=300.0)  # support 600 hPa: 850 partially in
    cfg = FilterConfig(localization="GC", dtype="float64")
    post, _ = EnSRF(state, [ob], config=cfg).update()
    d850 = np.abs(np.asarray(post["T_850"]) - np.asarray(state["T_850"]))
    assert d850.max() > 1e-9  # within support -> some update
    d500 = np.abs(np.asarray(post["T_500"]) - np.asarray(state["T_500"]))
    assert d500.max() > d850.max()  # but smaller than the observed level's


def test_vertical_off_without_var_verts():
    """Obs with vertical radii but a state without var_verts: vertical
    localization silently stays off (no vertical coordinate to use)."""
    state = make_demo_state(nmems=10)
    s = state.structure
    ob = Observation(
        value=280.0, obtype=s.var_names[0], time=s.times64()[0], error=1.0,
        lat=45.0, lon=236.0, vert=500.0, assimilate_this=True,
        localize_radius=3000.0, vert_localize_radius=10.0,
    )
    cfg = FilterConfig(localization="GC", dtype="float64")
    post, batch = EnSRF(state, [ob], config=cfg).update()
    assert batch.assimilated.all()
    assert np.abs(np.asarray(post.data) - np.asarray(state.data)).max() > 0


@pytest.mark.parametrize("method", ["serial", "blocked"])
def test_vertical_serial_blocked_agree(method):
    state = make_level_state(seed=7)
    obs = [
        _ob(state, vert=500.0, vrad=250.0),
        _ob(state, vert=850.0, vrad=150.0),
    ]
    obs[1].obtype = "T_850"
    posts = {}
    for m in ("serial", "blocked"):
        cfg = FilterConfig(localization="GC", dtype="float64", method=m,
                           block_size=2)
        post, _ = EnSRF(state, [o for o in obs], config=cfg).update()
        posts[m] = np.asarray(post.data)
    np.testing.assert_allclose(posts["serial"], posts["blocked"], atol=1e-10)


def test_vertical_pallas_interpret_agrees():
    state = make_level_state(seed=9)
    obs = [_ob(state, vert=500.0, vrad=250.0)]
    base = FilterConfig(localization="GC", dtype="float32", use_pallas=False)
    fast = FilterConfig(localization="GC", dtype="float32", use_pallas=True,
                        block_size=1)
    p1, _ = EnSRF(state, [o for o in obs], config=base).update()
    filt = EnSRF(state, [o for o in obs], config=fast)
    filt.interpret = True
    p2, _ = filt.update()
    np.testing.assert_allclose(
        np.asarray(p2.data), np.asarray(p1.data), atol=2e-4
    )


def test_vertical_fused_v4_interpret_agrees():
    """The body kernel's in-kernel vertical GC factor must match the XLA
    path on a gridded two-level state (chordal geometry)."""
    state = make_level_state(seed=11)
    obs = [
        _ob(state, vert=500.0, vrad=250.0),
        _ob(state, vert=850.0, vrad=150.0),
        _ob(state, vert=700.0, vrad=400.0),
    ]
    obs[1].obtype = "T_850"
    base = FilterConfig(localization="GC", dtype="float32", use_pallas=False,
                        fast_geometry=True)
    fused = FilterConfig(localization="GC", dtype="float32", use_pallas=True,
                         fast_geometry=True, block_size=2)
    p1, _ = EnSRF(state, [o for o in obs], config=base).update()
    filt = EnSRF(state, [o for o in obs], config=fused)
    filt.interpret = True
    p2, _ = filt.update()
    np.testing.assert_allclose(
        np.asarray(p2.data), np.asarray(p1.data), atol=2e-4
    )


def test_vertical_chunked_matches_one_shot():
    """The r5 chunked driver (tail-once + chunked body) must carry the
    vertical factors: chunked == one-shot with mixed vertical radii."""
    rng = np.random.default_rng(7)
    state = make_level_state(nmems=12, seed=5)
    s = state.structure
    obs = []
    for i in range(11):
        obs.append(Observation(
            value=float(271.0 + rng.normal(0, 1)),
            obtype="T_500" if i % 2 else "T_850",
            time=s.times64()[i % 2],
            error=1.0,
            lat=float(rng.uniform(43, 49)),
            lon=float(rng.uniform(231, 243)),
            vert=float(rng.choice([500.0, 850.0])),
            assimilate_this=(i % 4 != 0),
            localize_radius=3000.0,
            vert_localize_radius=float(rng.choice([150.0, 400.0, np.inf])),
        ))
    one, b1 = EnSRF(state, obs, config=FilterConfig(
        localization="GC", dtype="float64"), verbose=False).update()
    many, b2 = EnSRF(state, obs, config=FilterConfig(
        localization="GC", dtype="float64", obs_chunk=4),
        verbose=False).update()
    np.testing.assert_allclose(np.asarray(many.data), np.asarray(one.data),
                               rtol=1e-10, atol=1e-10)
    for f in ("prior_mean", "post_mean", "post_var"):
        np.testing.assert_allclose(
            np.asarray(getattr(b2, f), dtype=np.float64),
            np.asarray(getattr(b1, f), dtype=np.float64),
            rtol=1e-10, atol=1e-10)
