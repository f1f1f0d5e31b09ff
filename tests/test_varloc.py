"""Cross-variable localization (DART-style variable localization; an
extension — the reference localizes spatially only,
``efa_xray/assimilation/ensrf.py:99-115``).

``FilterConfig.variable_localization`` maps (observed_var, state_var)
pairs to multiplicative gain factors.  The factor enters the gain
exactly like a Gaspari-Cohn weight (per (row, ob)), so every EnSRF/EnKF
execution path must agree: serial == blocked == panel-tail == mesh, and
the float64 NumPy oracle (extended with the same factor) stays the
ground truth.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import oracle_numpy as oracle
from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.assimilation.enkf import EnKF
from efa_xray_tpu.assimilation.ensrf import EnSRF
from efa_xray_tpu.assimilation.letkf import LETKF
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.parallel import make_mesh


def _two_var_setup(nobs=14, seed=0, nmems=16):
    state = make_demo_state(nvars=2, ntimes=2, ny=6, nx=8, nmems=nmems,
                            seed=seed)
    obs = make_demo_obs(state, nobs=nobs, seed=seed + 1, radius=2000.0)
    return state, obs


def _cfg(spec, **kw):
    return FilterConfig(localization="GC", dtype="float64",
                        variable_localization=spec, **kw)


def test_factor_ones_equals_baseline():
    state, obs = _two_var_setup()
    base, _ = EnSRF(state, list(obs), verbose=False,
                    config=_cfg(None)).update()
    ones, _ = EnSRF(state, list(obs), verbose=False,
                    config=_cfg({"T2m:T2m": 1.0})).update()
    np.testing.assert_allclose(np.asarray(ones.data), np.asarray(base.data),
                               atol=1e-12)


@pytest.mark.parametrize("method", ["serial", "blocked"])
def test_zero_cross_factor_isolates_variable(method):
    """All obs observe var A; the cross factor A->B = 0 must leave every
    var-B row EXACTLY at its prior while var-A still updates."""
    state, obs = _two_var_setup()
    names = state.structure.var_names
    for ob in obs:
        ob.obtype = names[0]
    spec = {f"{names[0]}:{names[1]}": 0.0}
    post, _ = EnSRF(state, list(obs), verbose=False,
                    config=_cfg(spec, method=method)).update()
    prior = np.asarray(state.data)
    got = np.asarray(post.data)
    np.testing.assert_array_equal(got[1], prior[1])  # var B untouched
    assert np.abs(got[0] - prior[0]).max() > 1e-8  # var A updated


def test_serial_blocked_mesh_agree_with_factors():
    state, obs = _two_var_setup(nobs=18, seed=3)
    names = state.structure.var_names
    spec = {f"{names[0]}:{names[1]}": 0.3, f"{names[1]}:{names[0]}": 0.7,
            (names[1], names[1]): 0.9}
    outs = {}
    for label, kw in (("serial", dict(method="serial")),
                      ("blocked", dict(method="blocked")),
                      ("blocked8", dict(method="blocked", block_size=8)),
                      ("panel", dict(method="blocked", tail_panel=4))):
        post, _ = EnSRF(state, list(obs), verbose=False,
                        config=_cfg(spec, **kw)).update()
        outs[label] = np.asarray(post.data)
    post_m, _ = EnSRF(state, list(obs), verbose=False, config=_cfg(spec),
                      mesh=make_mesh()).update()
    outs["mesh"] = np.asarray(post_m.data)
    for label in ("blocked", "blocked8", "panel", "mesh"):
        np.testing.assert_allclose(outs[label], outs["serial"], atol=1e-9,
                                   err_msg=label)


def test_parity_vs_numpy_oracle_with_factors():
    """Core-level float64 parity against the extended oracle."""
    rng = np.random.default_rng(5)
    nv, nt, ng, nm, no = 3, 1, 30, 11, 12
    ns = nv * nt * ng
    prior = 280 + 5 * rng.standard_normal((ns, nm))
    glat = rng.uniform(-60, 60, ng)
    glon = rng.uniform(0, 360, ng)
    row_lat = np.tile(glat, nv * nt)
    row_lon = np.tile(glon, nv * nt)
    row_var = np.repeat(np.arange(nv), nt * ng)
    rows = rng.integers(0, ng, no)
    ovar = rng.integers(0, nv, no).astype(np.int32)
    ye = prior[ovar * nt * ng + rows]
    values = ye.mean(1) + rng.normal(0, 1, no)
    errors = rng.uniform(0.5, 2.0, no)
    radii = np.full(no, 2500.0)
    assim = rng.random(no) < 0.85
    fac = rng.uniform(0.0, 1.0, (nv, nv))

    want, _ = oracle.serial_ensrf(
        prior, ye, values, errors, glat[rows], glon[rows], radii,
        row_lat, row_lon, assim, localize=True,
        varloc=fac, row_var=row_var, ob_var=ovar,
    )
    obs = core.ObsArrays(
        values=jnp.asarray(values), errors=jnp.asarray(errors),
        lats=jnp.asarray(glat[rows]), lons=jnp.asarray(glon[rows]),
        radii=jnp.asarray(radii), assim=jnp.asarray(assim),
    )
    bm = jnp.asarray(prior.mean(1))
    bp = jnp.asarray(prior - prior.mean(1, keepdims=True))
    tm = jnp.asarray(ye.mean(1))
    tp = jnp.asarray(ye - ye.mean(1, keepdims=True))
    got = core.ensrf_serial(
        bm, bp, tm, tp, jnp.asarray(row_lat), jnp.asarray(row_lon), obs,
        localize=True, varloc=jnp.asarray(fac), row_var=jnp.asarray(row_var),
        ob_var=jnp.asarray(ovar),
    )
    post = np.asarray(got[0])[:, None] + np.asarray(got[1])
    rmse = np.sqrt(np.mean((post - want) ** 2))
    assert rmse < 1e-9, rmse


def test_enkf_varloc_isolation_and_blocked_parity():
    state, obs = _two_var_setup(seed=7)
    names = state.structure.var_names
    for ob in obs:
        ob.obtype = names[0]
    spec = {f"{names[0]}:{names[1]}": 0.0}
    prior = np.asarray(state.data)
    outs = {}
    for method in ("serial", "blocked"):
        post, _ = EnKF(state, list(obs), verbose=False, seed=4,
                       config=_cfg(spec, method=method)).update()
        outs[method] = np.asarray(post.data)
        np.testing.assert_array_equal(outs[method][1], prior[1])
    np.testing.assert_allclose(outs["blocked"], outs["serial"], atol=1e-9)
    post_m, _ = EnKF(state, list(obs), verbose=False, seed=4,
                     config=_cfg(spec), mesh=make_mesh()).update()
    np.testing.assert_allclose(np.asarray(post_m.data), outs["blocked"],
                               atol=1e-9)
    np.testing.assert_array_equal(np.asarray(post_m.data)[1], prior[1])


def test_validation_and_solver_guards():
    with pytest.raises(ValueError, match="factors must be numbers"):
        FilterConfig(variable_localization={"A:B": -0.5})
    with pytest.raises(ValueError, match="2-tuples"):
        FilterConfig(variable_localization={3: 1.0})
    with pytest.raises(ValueError, match="OBSVAR:STATEVAR"):
        FilterConfig(variable_localization={"A:B:C": 1.0})
    with pytest.raises(ValueError, match="hybrid"):
        FilterConfig(variable_localization={"A:B": 0.5}, hybrid_alpha=0.5,
                     static_b_sigma=1.0, static_b_length=1000.0)
    state, obs = _two_var_setup()
    with pytest.raises(ValueError, match="letkf_topk"):
        LETKF(state, list(obs), verbose=False,
              config=_cfg({"T2m:T2m": 1.0}, letkf_topk="host")).update()
    with pytest.raises(KeyError, match="unknown variable"):
        EnSRF(state, list(obs), verbose=False,
              config=_cfg({"NOPE:T2m": 0.5})).update()


def test_letkf_varloc_isolation_ones_and_mesh():
    """LETKF variable localization (rho factor, per-(group, patch)
    solves): zero cross factor isolates the untargeted variable exactly,
    F = ones reproduces the shared-solve horizontal baseline, and the
    mesh matches single-device."""
    state, obs = _two_var_setup(seed=23)
    names = state.structure.var_names
    kw = dict(letkf_k_obs=8, letkf_chunk=16)

    base, _ = LETKF(state, list(obs), verbose=False,
                    config=_cfg(None, **kw)).update()
    ones, _ = LETKF(state, list(obs), verbose=False,
                    config=_cfg({f"{names[0]}:{names[0]}": 1.0},
                                **kw)).update()
    np.testing.assert_allclose(np.asarray(ones.data), np.asarray(base.data),
                               atol=1e-10)

    for ob in obs:
        ob.obtype = names[0]
    spec = {f"{names[0]}:{names[1]}": 0.0}
    prior = np.asarray(state.data)
    post, _ = LETKF(state, list(obs), verbose=False,
                    config=_cfg(spec, **kw)).update()
    got = np.asarray(post.data)
    np.testing.assert_allclose(got[1], prior[1], atol=1e-12)
    assert np.abs(got[0] - prior[0]).max() > 1e-8
    post_m, _ = LETKF(state, list(obs), verbose=False,
                      config=_cfg(spec, **kw), mesh=make_mesh()).update()
    np.testing.assert_allclose(np.asarray(post_m.data), got, atol=1e-10)
    # composes with true vertical localization too
    from test_vertical_localization import _ob, make_level_state

    vstate = make_level_state()
    vob = _ob(vstate, vert=500.0, vrad=300.0)
    vspec = {"T_500:T_850": 0.0}
    vpost, _ = LETKF(vstate, [vob], verbose=False,
                     config=_cfg(vspec, letkf_k_obs=4,
                                 letkf_chunk=8)).update()
    vprior = np.asarray(vstate.data)
    np.testing.assert_allclose(np.asarray(vpost.data)[1], vprior[1],
                               atol=1e-12)


def test_varloc_composes_with_spatial_and_no_localization():
    """Factors apply with localization OFF too (pure variable blocking),
    and compose multiplicatively with GC weights when it is on."""
    state, obs = _two_var_setup(seed=9)
    names = state.structure.var_names
    for ob in obs:
        ob.obtype = names[0]
    spec = {f"{names[0]}:{names[1]}": 0.0}
    prior = np.asarray(state.data)
    cfg = FilterConfig(localization=None, dtype="float64",
                       variable_localization=spec)
    for method in ("serial", "blocked"):
        import dataclasses

        post, _ = EnSRF(state, list(obs), verbose=False,
                        config=dataclasses.replace(cfg, method=method)
                        ).update()
        got = np.asarray(post.data)
        np.testing.assert_array_equal(got[1], prior[1])
        assert np.abs(got[0] - prior[0]).max() > 1e-8


def test_grid_kernel_carries_varloc_factor():
    """The body and tail kernels gather the cross-variable factor per
    (row, ob) from the small table: interpreted kernels == XLA blocked
    body with the same factors, on gridded and flat states."""
    state, obs = _two_var_setup(nobs=16, seed=13)
    names = state.structure.var_names
    spec = {f"{names[0]}:{names[1]}": 0.0, f"{names[1]}:{names[0]}": 0.4}
    kw = dict(method="blocked", fast_geometry=True)

    def kernel_filter(st, ob, spec_):
        f = EnSRF(st, list(ob), verbose=False,
                  config=_cfg(spec_, use_pallas=True, **kw))
        f.interpret = True
        return f

    xla, _ = EnSRF(state, list(obs), verbose=False,
                   config=_cfg(spec, **kw)).update()
    filt = kernel_filter(state, obs, spec)
    assert filt._kernels().body and filt._kernels().tail
    pal, _ = filt.update()
    np.testing.assert_allclose(np.asarray(pal.data), np.asarray(xla.data),
                               atol=1e-9)
    # isolation property survives the kernel path: make all obs var-0
    for ob in obs:
        ob.obtype = names[0]
    prior = np.asarray(state.data)
    pal2, _ = kernel_filter(state, obs, spec).update()
    np.testing.assert_allclose(np.asarray(pal2.data)[1], prior[1],
                               atol=1e-12)
    # a FLAT (single-var) state with varloc takes the same kernel
    flat_state = make_demo_state(nvars=1, ntimes=1, ny=6, nx=8, nmems=12,
                                 seed=14)
    flat_obs = make_demo_obs(flat_state, nobs=5, seed=15)
    f2 = kernel_filter(flat_state, flat_obs, {"T2m:T2m": 0.5})
    ref, _ = EnSRF(flat_state, list(flat_obs), verbose=False,
                   config=_cfg({"T2m:T2m": 0.5}, **kw)).update()
    got, _ = f2.update()
    np.testing.assert_allclose(np.asarray(got.data), np.asarray(ref.data),
                               atol=1e-9)
