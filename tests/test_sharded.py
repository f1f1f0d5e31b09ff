"""Multi-device sharding: N-device shard_map run must match single-device.

Runs on 8 virtual CPU devices (conftest sets
``xla_force_host_platform_device_count=8``), standing in for a GPU mesh.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import ensrf_core as core
from efa_xray_tpu.assimilation.ensrf import EnSRF
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.parallel import make_mesh
from efa_xray_tpu.ops.select import Kernels
from efa_xray_tpu.parallel.sharded import ensrf_update_sharded


requires_multi = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >= 2 devices"
)


def _problem(nmems=20, seed=5, ny=7, nx=9):
    """State whose nstate does NOT divide 8, to exercise padding."""
    state = make_demo_state(ntimes=3, ny=ny, nx=nx, nmems=nmems, seed=seed)
    obs = make_demo_obs(state, nobs=11, seed=seed + 1, radius=900.0)
    batch = ObservationBatch.coerce(obs)
    return state, obs, batch


@requires_multi
@pytest.mark.parametrize("method", ["serial", "blocked"])
def test_sharded_matches_single_device(method):
    state, obs, batch = _problem()
    cfg = FilterConfig(localization="GC", method=method, dtype="float64")

    single = EnSRF(state, list(obs), config=cfg)
    post_single, _ = single.update()

    mesh = make_mesh()
    multi = EnSRF(state, list(obs), config=cfg, mesh=mesh)
    post_multi, batch_multi = multi.update()

    np.testing.assert_allclose(
        np.asarray(post_multi.data), np.asarray(post_single.data), atol=1e-10
    )
    np.testing.assert_allclose(
        batch_multi.post_mean, single.obs.post_mean, atol=1e-10
    )


@requires_multi
def test_sharded_diags_match_single():
    state, obs, batch = _problem(seed=11)
    cfg = FilterConfig(localization="GC", dtype="float64")
    single = EnSRF(state, list(obs), config=cfg)
    single.update()
    mesh = make_mesh()
    multi = EnSRF(state, list(obs), config=cfg, mesh=mesh)
    multi.update()
    for field in ("prior_mean", "prior_var", "post_mean", "post_var"):
        np.testing.assert_allclose(
            getattr(multi.obs, field), getattr(single.obs, field), atol=1e-10
        )


@requires_multi
def test_sharded_padding_rows_are_inert():
    """nstate = 3*7*9 = 189, not divisible by 8: the padded rows must not
    perturb real rows' results (checked implicitly by equality above, and
    explicitly here for mean-zero pad rows)."""
    state, obs, batch = _problem()
    ns = state.nstate()
    assert ns % len(jax.devices()) != 0  # the interesting case

    cfg = FilterConfig(localization="GC", dtype="float64")
    mesh = make_mesh()
    filt = EnSRF(state, list(obs), config=cfg, mesh=mesh)
    post, _ = filt.update()
    assert np.isfinite(np.asarray(post.data)).all()


@requires_multi
def test_state_shard_placement():
    state = make_demo_state(ny=8, nx=8, ntimes=2)  # y divides the mesh
    mesh = make_mesh()
    sharded = state.shard(mesh)
    assert len(sharded.data.sharding.device_set) == len(jax.devices())
    # actually sharded (not just replicated): per-device shard is smaller
    shard_shape = sharded.data.sharding.shard_shape(sharded.data.shape)
    assert shard_shape[2] == 8 // len(jax.devices())
    np.testing.assert_allclose(np.asarray(sharded.data), np.asarray(state.data))


@requires_multi
def test_sharded_pallas_matches_single_device():
    """Body and tail kernels under shard_map (interpreter on the CPU
    mesh), exact geometry."""
    from efa_xray_tpu.parallel.sharded import ensrf_update_sharded
    from efa_xray_tpu.assimilation import ensrf_core as core
    import jax.numpy as jnp

    state, obs, batch = _problem(seed=21)
    cfg = FilterConfig(localization="GC", dtype="float32")
    single = EnSRF(state, list(obs), config=cfg)
    post_single, _ = single.update()

    filt = EnSRF(state, list(obs), config=cfg)
    bm, bp, tm, tp = filt.format_prior_state()
    oarr = filt.obs_arrays()
    row_lat, row_lon = state.structure.row_latlon()
    mesh = make_mesh()
    bm2, bp2, _, _, _ = ensrf_update_sharded(
        bm, bp, tm, tp,
        jnp.asarray(row_lat, dtype=jnp.float32),
        jnp.asarray(row_lon, dtype=jnp.float32),
        oarr, mesh=mesh, localize=True, method="blocked", block_size=8,
        kernels=Kernels(body=True, tail=True, interpret=True),
    )
    post = np.asarray(bm2)[:, None] + np.asarray(bp2)
    want = np.asarray(post_single.to_vect())
    np.testing.assert_allclose(post, want, rtol=2e-4, atol=2e-3)


@requires_multi
def test_sharded_fused_v4_matches_single_device():
    """The body kernel under shard_map (with donation, chordal geometry)
    must match the single-device update — the headline composition
    (kernel x mesh)."""
    state, obs, batch = _problem(seed=23)
    cfg = FilterConfig(localization="GC", dtype="float32", fast_geometry=True)
    single = EnSRF(state, list(obs), config=cfg)
    post_single, _ = single.update()

    filt = EnSRF(state, list(obs), config=cfg)
    bm, bp, tm, tp = filt.format_prior_state()
    oarr = filt.obs_arrays()
    row_lat, row_lon = state.structure.row_latlon()
    mesh = make_mesh()
    bm2, bp2, _, _, _ = ensrf_update_sharded(
        bm, bp, tm, tp,
        jnp.asarray(row_lat, dtype=jnp.float32),
        jnp.asarray(row_lon, dtype=jnp.float32),
        oarr, mesh=mesh, localize=True, method="blocked", block_size=8,
        kernels=Kernels(body=True, tail=False, interpret=True),
        fast_geometry=True, donate=True,
    )
    post = np.asarray(bm2)[:, None] + np.asarray(bp2)
    want = np.asarray(post_single.to_vect())
    np.testing.assert_allclose(post, want, rtol=2e-4, atol=2e-3)


@requires_multi
def test_sharded_kernels_issue_no_collectives():
    """The kernel path under the mesh (tail kernels replicated, body
    kernel per shard) is collective-free as well."""
    from efa_xray_tpu.parallel.sharded import _ensrf_sharded_jit
    from efa_xray_tpu.parallel.mesh import STATE_AXIS

    state, obs, batch = _problem(ny=8, nx=8)
    cfg = FilterConfig(localization="GC", dtype="float32")
    filt = EnSRF(state, list(obs), config=cfg)
    bm, bp, tm, tp = filt.format_prior_state()
    oarr = filt.obs_arrays().with_default_verts()
    row_lat, row_lon = state.structure.row_latlon()
    hlo = _ensrf_sharded_jit.lower(
        bm, bp, tm, tp,
        jnp.asarray(row_lat, dtype=bm.dtype),
        jnp.asarray(row_lon, dtype=bm.dtype),
        jnp.zeros_like(bm), oarr, jnp.zeros_like(bm), jnp.zeros_like(tm),
        mesh=make_mesh(), localize=True, method="blocked", block_size=8,
        axis_name=STATE_AXIS, unbiased=False,
        kernels=Kernels(body=True, tail=True, interpret=True),
        fast_geometry=False, vertical=False, tail_panel=8, cull=True,
        spatial_sort=False, hybrid_alpha=1.0, static_length=0.0,
    ).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in hlo, f"collective {op!r} leaked into the obs loop"


@requires_multi
def test_sharded_obs_loop_issues_no_collectives():
    """SURVEY §5.8 invariant, checked in the compiled HLO: the sharded
    update contains NO cross-device collectives at all — obs-space
    quantities live in the replicated tail, state rows update locally.
    """
    from efa_xray_tpu.parallel.sharded import (
        _ensrf_sharded_jit,
        _shard_specs,
    )
    from efa_xray_tpu.parallel.mesh import STATE_AXIS

    state, obs, batch = _problem(ny=8, nx=8)  # divides the mesh: no padding
    cfg = FilterConfig(localization="GC", dtype="float64")
    filt = EnSRF(state, list(obs), config=cfg)
    bm, bp, tm, tp = filt.format_prior_state()
    oarr = filt.obs_arrays().with_default_verts()
    row_lat, row_lon = state.structure.row_latlon()
    mesh = make_mesh()

    lowered = _ensrf_sharded_jit.lower(
        bm, bp, tm, tp,
        jnp.asarray(row_lat, dtype=bm.dtype),
        jnp.asarray(row_lon, dtype=bm.dtype),
        jnp.zeros_like(bm),
        oarr,
        jnp.zeros_like(bm),  # body_sigma placeholder (hybrid off)
        jnp.zeros_like(tm),  # tail_sigma placeholder
        mesh=mesh, localize=True, method="blocked", block_size=8,
        axis_name=STATE_AXIS, unbiased=False,
        kernels=Kernels(body=False, tail=False, interpret=False),
        fast_geometry=False,
        vertical=False, tail_panel=8, cull=True, spatial_sort=True,
        hybrid_alpha=1.0, static_length=0.0,
    )
    hlo = lowered.compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in hlo, f"collective {op!r} leaked into the obs loop"

    # Hybrid static-B column: per-row x per-ob separable, so it must stay
    # collective-free as well (sigma_row shards with the rows).
    lowered_h = _ensrf_sharded_jit.lower(
        bm, bp, tm, tp,
        jnp.asarray(row_lat, dtype=bm.dtype),
        jnp.asarray(row_lon, dtype=bm.dtype),
        jnp.zeros_like(bm),
        oarr,
        jnp.ones_like(bm),
        jnp.ones_like(tm),
        mesh=mesh, localize=True, method="blocked", block_size=8,
        axis_name=STATE_AXIS, unbiased=False,
        kernels=Kernels(body=False, tail=False, interpret=False),
        fast_geometry=False,
        vertical=False, tail_panel=8, cull=True, spatial_sort=True,
        hybrid_alpha=0.5, static_length=1000.0,
    )
    hlo_h = lowered_h.compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in hlo_h, f"collective {op!r} leaked (hybrid)"


def test_mesh_refuses_oversize_batch_and_explicit_chunk(monkeypatch):
    """The sharded driver has no chunked mode: batches beyond the
    hardware-validated 131072-ob one-shot envelope must refuse loudly
    (obs_chunk=0 is the explicit opt-in), and an explicit positive
    obs_chunk must not be silently ignored on a mesh."""
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from conftest import make_demo_obs, make_demo_state

    state = make_demo_state(nmems=8)
    obs = make_demo_obs(state, nobs=6, radius=2000.0)
    mesh = make_mesh()

    cfg = FilterConfig(localization="GC", dtype="float64", obs_chunk=2)
    with pytest.raises(ValueError, match="single-device"):
        EnSRF(state, list(obs), config=cfg, mesh=mesh, verbose=False).update()

    # Fake an oversize batch without allocating 131k+ obs: shrink the
    # envelope constant via the nobs check by patching the batch size
    # through a tiny real batch and asserting the message text instead.
    cfg2 = FilterConfig(localization="GC", dtype="float64")
    filt = EnSRF(state, list(obs), config=cfg2, mesh=mesh, verbose=False)
    big = np.ones(131073, dtype=bool)
    # Exercise the guard directly: the update path reads obs.values.shape.
    orig = filt.obs_arrays

    def oversized():
        oa = orig()
        return oa._replace(values=jnp.zeros(131073, dtype=jnp.float64),
                           errors=jnp.ones(131073, dtype=jnp.float64),
                           lats=jnp.zeros(131073, dtype=jnp.float64),
                           lons=jnp.zeros(131073, dtype=jnp.float64),
                           radii=jnp.full(131073, jnp.inf, dtype=jnp.float64),
                           assim=jnp.asarray(big))

    monkeypatch.setattr(filt, "obs_arrays", oversized)
    with pytest.raises(ValueError, match="131072"):
        filt.update()
