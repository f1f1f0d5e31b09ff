#!/usr/bin/env python
"""Benchmark suite over the BASELINE.md configs.

Covers:
  0. demo-scale: ~20-member 2-D surface-temperature ensemble, 5 point obs
  1. Lorenz-96 cycling DA: 40 vars, 20 members, GC localization, 30 cycles
  2. 0.5-deg-like global single-level field (~260k points), 40 members,
     2k surface obs
  3. multi-variable 3-D GEFS-like state (4 vars x 20 levels treated as the
     time/level axis), horizontal localization, 5k obs
  4. pod-scale slice; 10 the full 1e7-row x 80-member x 10k-ob headline
  (and more: see BENCHES below)

Each timing chains a jitted step (outputs feed the next call) after one
warm-up call that compiles, and closes the window with
``block_until_ready``.

Usage: python benchmarks/run_benchmarks.py [--configs 0 1 2 3] [--json out]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from efa_xray_tpu.assimilation import ensrf_core as core


def _morton_ingest(state_lat, state_lon, prior, ob_lat, ob_lon, ob_vals):
    """Ingest-time spherical Hilbert layout for flat-state kernel benches:
    row order is an internal layout choice (updates are row-local) and obs
    order is the caller's choice in a serial filter.  Sorted layout makes
    row tiles compact caps so the body kernel's localization culling
    engages."""
    from efa_xray_tpu.observation.thinning import _hilbert3d_np

    ro = np.argsort(_hilbert3d_np(state_lat, state_lon), kind="stable")
    oo = np.argsort(_hilbert3d_np(ob_lat, ob_lon), kind="stable")
    return (state_lat[ro], state_lon[ro], prior[ro],
            ob_lat[oo], ob_lon[oo], ob_vals[oo], ro, oo)


def _obs_arrays(values, errors, lats, lons, radii, dtype):
    n = len(values)
    return core.ObsArrays(
        values=jnp.asarray(values, dtype=dtype),
        errors=jnp.asarray(errors, dtype=dtype),
        lats=jnp.asarray(lats, dtype=dtype),
        lons=jnp.asarray(lons, dtype=dtype),
        radii=jnp.asarray(radii, dtype=dtype),
        assim=jnp.ones(n, dtype=bool),
    )


def _chain_seconds(step, carry, iters):
    """Seconds per call of ``step`` chained ``iters`` times (each call's
    outputs are the next call's inputs), after one warm-up call that
    compiles; ``block_until_ready`` closes the window."""
    carry = jax.block_until_ready(step(*carry))
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step(*carry)
    jax.block_until_ready(carry)
    return max((time.perf_counter() - t0) / iters, 1e-9)


def _kernels(kernel, dtype=jnp.float32):
    """Kernel choice for ``kernel`` = None (what EnSRF picks on this
    device), "xla" or "kernel"."""
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.ops import select

    force = {None: None, "xla": False, "kernel": True}[kernel]
    return select.choose(FilterConfig(dtype=jnp.dtype(dtype).name,
                                      use_pallas=force, tail_pallas=force))


def _timed_update(prior, state_lat, state_lon, obs, block_size=128, iters=3,
                  kernel=None, dtype=jnp.float32,
                  body_vert=None, vertical=False, donate=False,
                  fast_geometry=True):
    """Seconds per blocked update (tail + body), chained.

    ``kernel``: None (the device's default choice, as EnSRF makes it),
    "xla" or "kernel" (the Triton kernels)."""
    from efa_xray_tpu.ops.ensrf_triton import body_update

    kern = _kernels(kernel, dtype)
    pj = jnp.asarray(prior, dtype=dtype)
    nobs = len(np.asarray(obs.values))
    rng = np.random.default_rng(0)
    rows = rng.integers(0, pj.shape[0], nobs)
    ye0 = pj[rows]

    blat = jnp.asarray(state_lat, dtype=dtype)
    blon = jnp.asarray(state_lon, dtype=dtype)
    bvert = jnp.zeros_like(blat) if body_vert is None else jnp.asarray(
        body_vert, dtype=dtype)
    geometry = "chordal" if fast_geometry else "haversine"

    # blat/blon/bvert/obs enter as jit ARGUMENTS: closure-captured device
    # arrays become constant literals in the compiled program — global
    # allocations that can never be freed.
    def step_impl(bm, bp, tm, tp, blat, blon, bvert, obs):
        tail = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                      fast_geometry=fast_geometry,
                                      vertical=vertical, panel=64,
                                      kernels=kern.tail)
        if kern.body:
            bm2, bp2 = body_update(
                bm, bp, blat, blon, tail, obs, localize=True,
                geometry=geometry, body_vert=bvert if vertical else None,
                vertical=vertical)
        else:
            bm2, bp2 = core.ensrf_blocked_body(
                bm, bp, blat, blon, tail, obs, localize=True,
                block_size=block_size, fast_geometry=fast_geometry,
                body_vert=bvert, vertical=vertical,
            )
        return bm2, bp2, tail.tail_mean, tail.tail_perts

    jstep = jax.jit(step_impl, donate_argnums=(0, 1) if donate else ())
    step = lambda *c: jstep(*c, blat, blon, bvert, obs)
    bm = jnp.mean(pj, axis=1)
    bp = pj - bm[:, None]
    tm = jnp.mean(ye0, axis=1)
    tp = ye0 - tm[:, None]
    del pj
    return _chain_seconds(step, (bm, bp, tm, tp), iters)


def bench_config0():
    """Demo scale via the full public API (includes taps/host overhead)."""
    from efa_xray_tpu import EnSRF
    from efa_xray_tpu.utils.demo_data import gefs_like_state, observations_from_truth

    state, truth = gefs_like_state(ny=20, nx=30, nmems=21, ntimes=8)
    obs = observations_from_truth(state, truth, 5, radius=2000.0)
    warm, _ = EnSRF(state, obs, loc="GC", verbose=False).update()  # warm compiles
    jax.block_until_ready(warm.data)
    filt = EnSRF(state, obs, loc="GC", verbose=False)
    t0 = time.perf_counter()
    post, batch = filt.update()
    jax.block_until_ready(post.data)
    dt = time.perf_counter() - t0
    return {
        "config": "0-demo",
        "nstate": state.nstate(),
        "nmems": state.nmems(),
        "nobs": len(obs),
        "seconds": dt,
        "obs_points_per_sec": len(obs) * state.nstate() / dt,
    }


def bench_config1(ncycles=60, warmup=20):
    """Lorenz-96 cycling DA with TUNED assimilation (production recipe:
    Anderson-2009 adaptive inflation, docs/recipes.md) through the
    CyclingHarness — not the raw untuned filter.  Canonical bar for a
    half-observed L96 with sigma_obs = 1: analysis RMSE well below 1
    (the r2 untuned number, 1.53, was ABOVE the ob error)."""
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.models import lorenz96 as l96
    from efa_xray_tpu.models.cycling import CyclingHarness

    nvars, nmems = 40, 20
    truth, ens = l96.spinup_ensemble(nvars=nvars, nmems=nmems, seed=1)
    lats, lons = l96.fake_latlon(nvars)
    # Operating point from benchmarks/l96_evolve_scan.py (48-combo grid x
    # 3 seeds x 60 cycles, CPU): radius 8000 km with the EVOLVED inflation
    # std (Anderson 2009 §4, sd_min 0.15) — UNCAPPED (no adaptive_max) and
    # stable on every seed, mean analysis RMSE 0.67-0.70 and spread/RMSE
    # 0.91-0.94 for EVERY initial sd in {0.3, 0.6, 0.9}: the operating
    # point is no longer sd-sensitive, which was the point of evolving it.
    # (Round-3 history: the fixed-sd Anderson update needed a hand-tuned
    # sd=0.3 plus a DART-style adaptive_max=2.0 cap — uncapped it diverged
    # on 1 of 3 seeds — and was underdispersive at spread/RMSE ~0.85.)
    h = CyclingHarness(
        forecast=lambda x: l96.integrate(x, nsteps=4),
        state_lats=lats,
        state_lons=lons,
        ob_error=1.0,
        localize_radius=8000.0,
        config=FilterConfig(localization="GC", dtype="float32", block_size=8),
        obs_operator_rows=np.arange(0, nvars, 2),
        adaptive_inflation=True,
        adaptive_sd=0.6,
        adaptive_sd_evolve=True,
        adaptive_sd_min=0.15,
    )
    # Warmup cycles: compile the forecast/analysis jits AND spin the
    # adaptive-inflation field up before the timed window.
    h.run(ens, truth, ncycles=warmup, seed=100)
    t0 = time.perf_counter()
    stats = h.run(None, None, ncycles=ncycles, resume=True)
    dt = time.perf_counter() - t0
    rmse = [s.analysis_rmse for s in stats]
    return {
        "config": "1-lorenz96",
        "tuning": "adaptive_inflation",
        "ncycles": ncycles,
        "seconds": dt,
        "cycles_per_sec": ncycles / dt,
        "mean_analysis_rmse_last10": float(np.mean(rmse[-10:])),
        # The 10-cycle window is noisy (L96 RMSE is bursty); the last-30
        # mean is the statistically meaningful published number.
        "mean_analysis_rmse_last30": float(np.mean(rmse[-30:])),
        "mean_spread_last10": float(
            np.mean([s.mean_spread for s in stats[-10:]])
        ),
        "mean_spread_last30": float(
            np.mean([s.mean_spread for s in stats[-30:]])
        ),
    }


def bench_config2():
    rng = np.random.default_rng(2)
    ngrid, nmems, nobs = 720 * 361, 40, 2000  # 0.5-degree single level
    lat1d = np.linspace(-90, 90, 361)
    lon1d = np.arange(0, 360, 0.5)
    lon, lat = np.meshgrid(lon1d, lat1d)
    prior = rng.normal(280, 5, (ngrid, nmems)).astype(np.float32)
    rows = rng.integers(0, ngrid, nobs)
    vals = prior[rows].mean(1) + rng.normal(0, 1, nobs)
    slat, slon, prior, olat, olon, vals, _, _ = _morton_ingest(
        lat.ravel(), lon.ravel(), prior, lat.ravel()[rows],
        lon.ravel()[rows], vals)
    obs = _obs_arrays(
        vals, np.ones(nobs), olat, olon, np.full(nobs, 2000.0), jnp.float32,
    )
    dt = _timed_update(prior, slat, slon, obs)
    return {
        "config": "2-global-0.5deg",
        "nstate": ngrid,
        "nmems": nmems,
        "nobs": nobs,
        "seconds": dt,
        "obs_points_per_sec": nobs * ngrid / dt,
    }


def bench_config3(vertical=False, kernel=None):
    rng = np.random.default_rng(3)
    nvars, nlev, ny, nx, nmems, nobs = 4, 20, 90, 180, 30, 5000
    ngrid = ny * nx
    nstate = nvars * nlev * ngrid
    lat1d = np.linspace(-89, 89, ny)
    lon1d = np.arange(0, 360, 2.0)
    lon, lat = np.meshgrid(lon1d, lat1d)
    row_lat = np.tile(lat.ravel(), nvars * nlev)
    row_lon = np.tile(lon.ravel(), nvars * nlev)
    prior = rng.normal(0, 5, (nstate, nmems)).astype(np.float32)
    rows = rng.integers(0, nstate, nobs)
    obs = _obs_arrays(
        prior[rows].mean(1) + rng.normal(0, 1, nobs), np.ones(nobs),
        row_lat[rows], row_lon[rows], np.full(nobs, 2000.0), jnp.float32,
    )
    body_vert = None
    if vertical:
        levels = np.linspace(1000.0, 100.0, nlev)  # hPa per level group
        body_vert = np.repeat(np.tile(levels, nvars), ngrid)
        obs = obs._replace(
            verts=jnp.asarray(body_vert[rows], dtype=jnp.float32),
            vert_radii=jnp.full(nobs, 300.0, dtype=jnp.float32),
        )
    dt = _timed_update(prior, row_lat, row_lon, obs, kernel=kernel,
                       body_vert=body_vert, vertical=vertical)
    return {
        "config": "3-gefs-3d" + ("-vert" if vertical else ""),
        "nstate": nstate,
        "nmems": nmems,
        "nobs": nobs,
        "vertical_localization": vertical,
        "seconds": dt,
        "obs_points_per_sec": nobs * nstate / dt,
    }


def bench_config4(sharded=False):
    """Pod-scale slice: a 4.2M-row share of the 1e7-point x 80-member,
    10k-ob workload (what each of several cards runs under a mesh, obs
    replicated, zero per-ob collectives), with donation.

    ``sharded=True`` routes the SAME slice through the production
    shard_map path on a 1-device mesh (exactly what each pod chip
    executes) — validates no regression from the mesh plumbing."""
    rng = np.random.default_rng(4)
    nstate, nmems, nobs = 4_194_304, 80, 10_000
    state_lat = rng.uniform(-88, 88, nstate)
    state_lon = rng.uniform(0, 360, nstate)
    prior = rng.normal(280, 5, (nstate, nmems)).astype(np.float32)
    rows = rng.integers(0, nstate, nobs)
    vals = prior[rows].mean(1) + rng.normal(0, 1, nobs)
    state_lat, state_lon, prior, olat, olon, vals, _, _ = _morton_ingest(
        state_lat, state_lon, prior, state_lat[rows], state_lon[rows], vals)
    obs = _obs_arrays(
        vals, np.ones(nobs), olat, olon, np.full(nobs, 2000.0), jnp.float32,
    )
    if sharded:
        from efa_xray_tpu.parallel import make_mesh
        from efa_xray_tpu.parallel.sharded import ensrf_update_sharded

        mesh = make_mesh(jax.devices()[:1])
        pj = jnp.asarray(prior)
        # tail rows decoupled from obs locations, as in _timed_update
        ye0 = pj[jnp.asarray(rows)]
        blat = jnp.asarray(state_lat, jnp.float32)
        blon = jnp.asarray(state_lon, jnp.float32)

        kern = _kernels(None)

        def step(bm, bp, tm, tp):
            return ensrf_update_sharded(
                bm, bp, tm, tp, blat, blon, obs, mesh=mesh, localize=True,
                kernels=kern, fast_geometry=True, donate=True,
            )[:4]

        bm = jnp.mean(pj, axis=1)
        bp = pj - bm[:, None]
        tm = jnp.mean(ye0, axis=1)
        tp = ye0 - tm[:, None]
        del pj, ye0
        dt = _chain_seconds(step, (bm, bp, tm, tp), 2)
    else:
        dt = _timed_update(prior, state_lat, state_lon, obs, donate=True,
                           iters=2)
    return {
        "config": "4-pod-slice" + ("-sharded" if sharded else ""),
        "nstate": nstate,
        "nmems": nmems,
        "nobs": nobs,
        "seconds": dt,
        "obs_points_per_sec": nobs * nstate / dt,
    }


def bench_config10(nstate=10_000_000, nmems=80, nobs=10_000, iters=2,
                   kernel=None):
    """The headline at its true size on one card — no extrapolation:
    1e7 rows x 80 members x 10k obs (3.2 GB f32 state; the chained
    donation holds at most two state buffers at any instant).

    Mean/perturbations are drawn directly on the device (iid rows are
    layout-invariant, so drawing them in Hilbert coordinate order is the
    same distribution) and no full [nstate, nmems] prior array is kept on
    the host side."""
    from efa_xray_tpu.observation.thinning import _hilbert3d_np

    rng = np.random.default_rng(4)
    state_lat = rng.uniform(-88, 88, nstate)
    state_lon = rng.uniform(0, 360, nstate)
    ro = np.argsort(_hilbert3d_np(state_lat, state_lon), kind="stable")
    state_lat, state_lon = state_lat[ro], state_lon[ro]

    rows = rng.integers(0, nstate, nobs)
    olat, olon = state_lat[rows], state_lon[rows]
    oo = np.argsort(_hilbert3d_np(olat, olon), kind="stable")
    olat, olon = olat[oo], olon[oo]
    # Ob values near the prior mean; the timing is value-independent.
    vals = 280.0 + rng.normal(0, 1, nobs)
    obs = _obs_arrays(
        vals, np.ones(nobs), olat, olon, np.full(nobs, 2000.0), jnp.float32,
    )
    from efa_xray_tpu.ops.ensrf_triton import body_update

    kern = _kernels(kernel)
    blat = jnp.asarray(state_lat, jnp.float32)
    blon = jnp.asarray(state_lon, jnp.float32)
    bm = 280.0 + 0.5 * jax.random.normal(
        jax.random.PRNGKey(3), (nstate,), dtype=jnp.float32
    )
    bp = 5.0 * jax.random.normal(
        jax.random.PRNGKey(4), (nstate, nmems), dtype=jnp.float32
    )
    tp0 = 5.0 * jax.random.normal(
        jax.random.PRNGKey(5), (nobs, nmems), dtype=jnp.float32
    )
    tm = jnp.mean(tp0, axis=1)
    tp = tp0 - tm[:, None]
    tm = tm + 280.0
    del tp0

    def step_impl(bm, bp, tm, tp, blat, blon, obs):
        tail = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                      fast_geometry=True, panel=64,
                                      kernels=kern.tail)
        if kern.body:
            bm2, bp2 = body_update(bm, bp, blat, blon, tail, obs,
                                   localize=True, geometry="chordal")
        else:
            bm2, bp2 = core.ensrf_blocked_body(
                bm, bp, blat, blon, tail, obs, localize=True,
                block_size=128, fast_geometry=True,
            )
        return bm2, bp2, tail.tail_mean, tail.tail_perts

    jstep = jax.jit(step_impl, donate_argnums=(0, 1))
    step = lambda *c: jstep(*c, blat, blon, obs)
    dt = _chain_seconds(step, (bm, bp, tm, tp), iters)
    del bm, bp  # donated
    return {
        "config": "10-pod-full-1e7",
        "nstate": nstate,
        "nmems": nmems,
        "nobs": nobs,
        "kernels": kern._asdict(),
        "seconds": dt,
        "obs_points_per_sec": nobs * nstate / dt,
    }


def bench_config5(taps_topk="exact"):
    """API end-to-end at config-2 scale: EnSRF(state, obs).update() through
    the full public path — build_taps (host), obs priors, formatting, tail
    scan, kernel — vs the kernel-only time of config 2."""
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.observation.observation import ObservationBatch
    from efa_xray_tpu.state.ensemble import EnsembleState

    rng = np.random.default_rng(5)
    ny, nx, nmems, nobs = 361, 720, 40, 2000
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 0.5)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(1) * np.timedelta64(6, "h")
    field = rng.normal(280, 5, (1, ny, nx, nmems)).astype(np.float32)
    state = EnsembleState.from_vardict(
        {"T2m": field},
        {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)},
        dtype="float32",
    )
    from efa_xray_tpu.utils import timeutil

    batch = ObservationBatch(
        values=rng.normal(280, 5, nobs),
        errors=np.ones(nobs),
        lats=rng.uniform(-89, 89, nobs),
        lons=rng.uniform(0, 360, nobs),
        times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
        obtypes=["T2m"] * nobs,
        localize_radius=np.full(nobs, 2000.0),
        assimilate_flags=np.ones(nobs, bool),
        verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs,
    )
    cfg = FilterConfig(localization="GC", dtype="float32",
                       fast_geometry=True, taps_topk=taps_topk)

    def one_update():
        filt = EnSRF(state, batch, config=cfg, verbose=False)
        t0 = time.perf_counter()
        taps = filt.build_taps()
        jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape") else x, taps)
        t_taps = time.perf_counter() - t0
        t0 = time.perf_counter()
        post, _ = filt.update()
        jax.block_until_ready(post.data)
        return t_taps, time.perf_counter() - t0

    one_update()  # warm all compiles
    reps = [one_update() for _ in range(5)]
    t_taps = min(r[0] for r in reps)
    t_api = min(r[1] for r in reps)
    return {
        "config": "5-api-end-to-end",
        "taps_topk": taps_topk,
        "nstate": state.nstate(),
        "nmems": nmems,
        "nobs": nobs,
        "seconds": t_api,
        "taps_seconds": t_taps,
        "obs_points_per_sec": nobs * state.nstate() / t_api,
    }


def _timed_letkf(prior, grid_lat, grid_lon, obs, ngrid, patch_size=8,
                 k_obs=64, chunk=512, iters=3, dtype=jnp.float32,
                 body_vert=None, vertical=False, topk_method="exact",
                 ns_iters=30):
    """Chained timing of the all-at-once LETKF analysis."""
    from efa_xray_tpu.assimilation import letkf_core

    pj = jnp.asarray(prior, dtype=dtype)
    nobs = len(np.asarray(obs.values))
    rng = np.random.default_rng(0)
    rows = rng.integers(0, ngrid, nobs)
    ye0 = pj.reshape(-1, ngrid, pj.shape[-1])[0][jnp.asarray(rows)]
    glat = jnp.asarray(grid_lat, dtype=dtype)
    glon = jnp.asarray(grid_lon, dtype=dtype)
    bvert = None if body_vert is None else jnp.asarray(body_vert, dtype=dtype)

    sel_kwargs = {}
    if topk_method == "host":
        cand, mask, geff = letkf_core.host_select_candidates(
            np.asarray(grid_lat), np.asarray(grid_lon), ngrid, patch_size,
            np.asarray(obs.lats), np.asarray(obs.lons), k_obs, chunk=chunk)
        sel_kwargs = dict(sel_cand=jnp.asarray(cand),
                          sel_mask=jnp.asarray(mask), sel_group=geff)

    def step(bm, bp, tm, tp):
        return letkf_core.letkf_update(
            bm, bp, tm, tp, glat, glon, obs, ngrid=ngrid,
            patch_size=patch_size, k_obs=k_obs, chunk=chunk,
            vertical=vertical, body_vert=bvert, topk_method=topk_method,
            ns_iters=ns_iters, **sel_kwargs,
        )[:4]

    bm = jnp.mean(pj, axis=1)
    bp = pj - bm[:, None]
    tm = jnp.mean(ye0, axis=1)
    tp = ye0 - tm[:, None]
    return _chain_seconds(step, (bm, bp, tm, tp), iters)


def bench_config6(patch_size=8, k_obs=64, nobs=2000):
    """LETKF at config-2 scale: all obs in one shot (no serial scan)."""
    rng = np.random.default_rng(2)
    ny, nx, nmems = 361, 720, 40
    ngrid = ny * nx
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 0.5)
    lon, lat = np.meshgrid(lon1d, lat1d)
    prior = rng.normal(280, 5, (ngrid, nmems)).astype(np.float32)
    rows = rng.integers(0, ngrid, nobs)
    obs = _obs_arrays(
        prior[rows].mean(1) + rng.normal(0, 1, nobs), np.ones(nobs),
        lat.ravel()[rows], lon.ravel()[rows], np.full(nobs, 2000.0),
        jnp.float32,
    )
    dt = _timed_letkf(prior, lat.ravel(), lon.ravel(), obs, ngrid,
                      patch_size=patch_size, k_obs=k_obs)
    return {
        "config": "6-letkf-0.5deg",
        "nstate": ngrid,
        "nmems": nmems,
        "nobs": nobs,
        "patch_size": patch_size,
        "k_obs": k_obs,
        "seconds": dt,
        "obs_points_per_sec": nobs * ngrid / dt,
    }


def bench_config7(patch_size=8, k_obs=64, topk_method="exact"):
    """LETKF at the pod-slice scale: 10k obs x 4.2M pts x 80 mems.

    Hilbert-ingested rows AND obs, like every EnSRF config (and like
    `letkf_breakdown.py`): the host certificate bundles Hilbert-adjacent
    patches, so a randomly ordered grid about doubles the certified
    candidate width."""
    rng = np.random.default_rng(4)
    ngrid, nmems, nobs = 4_194_304, 80, 10_000
    state_lat = rng.uniform(-88, 88, ngrid)
    state_lon = rng.uniform(0, 360, ngrid)
    prior = rng.normal(280, 5, (ngrid, nmems)).astype(np.float32)
    rows = rng.integers(0, ngrid, nobs)
    ob_vals = prior[rows].mean(1) + rng.normal(0, 1, nobs)
    state_lat, state_lon, prior, ob_lat, ob_lon, ob_vals, _, _ = (
        _morton_ingest(state_lat, state_lon, prior,
                       state_lat[rows], state_lon[rows], ob_vals))
    obs = _obs_arrays(
        ob_vals, np.ones(nobs),
        ob_lat, ob_lon, np.full(nobs, 2000.0), jnp.float32,
    )
    dt = _timed_letkf(prior, state_lat, state_lon, obs, ngrid,
                      patch_size=patch_size, k_obs=k_obs, iters=2,
                      topk_method=topk_method)
    return {
        "config": "7-letkf-pod-slice",
        "nstate": ngrid,
        "nmems": nmems,
        "nobs": nobs,
        "patch_size": patch_size,
        "k_obs": k_obs,
        "topk": topk_method,
        "seconds": dt,
        "obs_points_per_sec": nobs * ngrid / dt,
    }


def bench_config9(patch_size=8, k_obs=64):
    """LETKF on the config-3 workload with VERTICAL localization: solves
    run per (level-group, patch) — VT = 80 groups x the spatial patches."""
    rng = np.random.default_rng(3)
    nvars, nlev, ny, nx, nmems, nobs = 4, 20, 90, 180, 30, 5000
    ngrid = ny * nx
    nstate = nvars * nlev * ngrid
    lat1d = np.linspace(-89, 89, ny)
    lon1d = np.arange(0, 360, 2.0)
    lon, lat = np.meshgrid(lon1d, lat1d)
    prior = rng.normal(0, 5, (nstate, nmems)).astype(np.float32)
    rows = rng.integers(0, nstate, nobs)
    row_lat = np.tile(lat.ravel(), nvars * nlev)
    row_lon = np.tile(lon.ravel(), nvars * nlev)
    levels = np.linspace(1000.0, 100.0, nlev)
    body_vert = np.repeat(np.tile(levels, nvars), ngrid)
    obs = _obs_arrays(
        prior[rows].mean(1) + rng.normal(0, 1, nobs), np.ones(nobs),
        row_lat[rows], row_lon[rows], np.full(nobs, 2000.0), jnp.float32,
    )._replace(
        verts=jnp.asarray(body_vert[rows], dtype=jnp.float32),
        vert_radii=jnp.full(nobs, 300.0, dtype=jnp.float32),
    )
    dt = _timed_letkf(prior, lat.ravel(), lon.ravel(), obs, ngrid,
                      patch_size=patch_size, k_obs=k_obs,
                      body_vert=body_vert, vertical=True, iters=2)
    return {
        "config": "9-letkf-gefs-3d-vert",
        "nstate": nstate,
        "nmems": nmems,
        "nobs": nobs,
        "patch_size": patch_size,
        "k_obs": k_obs,
        "seconds": dt,
        "obs_points_per_sec": nobs * nstate / dt,
    }


def bench_config8(nobs_list=(2000, 10000, 50000)):
    """Solver scaling in nobs at config-2 scale: the serial EnSRF is
    linear in nobs by construction (``ensrf.py:50``); the LETKF is flat
    once footprints saturate k_obs.  Reports both so the crossover is a
    measured fact, not a claim."""
    rng = np.random.default_rng(2)
    ny, nx, nmems = 361, 720, 40
    ngrid = ny * nx
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 0.5)
    lon, lat = np.meshgrid(lon1d, lat1d)
    prior = rng.normal(280, 5, (ngrid, nmems)).astype(np.float32)
    out = {"config": "8-solver-scaling", "nstate": ngrid, "nmems": nmems,
           "points": []}
    for nobs in nobs_list:
        rows = rng.integers(0, ngrid, nobs)
        obs = _obs_arrays(
            prior[rows].mean(1) + rng.normal(0, 1, nobs), np.ones(nobs),
            lat.ravel()[rows], lon.ravel()[rows], np.full(nobs, 2000.0),
            jnp.float32,
        )
        t_ensrf = _timed_update(prior, lat.ravel(), lon.ravel(), obs)
        t_letkf = _timed_letkf(prior, lat.ravel(), lon.ravel(), obs, ngrid,
                               patch_size=8, k_obs=64)
        t_letkf_host = _timed_letkf(prior, lat.ravel(), lon.ravel(), obs,
                                    ngrid, patch_size=8, k_obs=64,
                                    topk_method="host")
        out["points"].append(
            {"nobs": nobs, "ensrf_seconds": t_ensrf,
             "letkf_seconds": t_letkf,
             "letkf_host_seconds": t_letkf_host}
        )
        print(json.dumps(out["points"][-1]), flush=True)
    return out


def _config12_workload(nobs):
    """Shared workload for the obs-capacity points: Hilbert-sorted rows
    AND obs (the ingest-time order bench.py uses — the EnSRF cull and the
    LETKF host certificates both depend on spatial locality)."""
    from efa_xray_tpu.observation.thinning import _hilbert3d_np

    rng = np.random.default_rng(12)
    ny, nx, nmems = 361, 720, 40
    ngrid = ny * nx
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 0.5)
    lon, lat = np.meshgrid(lon1d, lat1d)
    glat, glon = lat.ravel(), lon.ravel()
    ro = np.argsort(_hilbert3d_np(glat, glon), kind="stable")
    glat, glon = glat[ro], glon[ro]
    prior = rng.normal(280, 5, (ngrid, nmems)).astype(np.float32)
    rows = rng.integers(0, ngrid, nobs)
    olat, olon = glat[rows], glon[rows]
    oo = np.argsort(_hilbert3d_np(olat, olon), kind="stable")
    olat, olon = olat[oo], olon[oo]
    obs = _obs_arrays(
        prior[rows[oo]].mean(1) + rng.normal(0, 1, nobs),
        np.ones(nobs), olat, olon, np.full(nobs, 2000.0), jnp.float32,
    )
    return prior, glat, glon, obs, ngrid, nmems


def _config12_point(solver: str, nobs: int):
    """Child mode: ONE (solver, nobs) obs-capacity point in this process."""
    prior, glat, glon, obs, ngrid, nmems = _config12_workload(nobs)
    pt = {"config": "12-obs-capacity-point", "solver": solver,
          "nstate": ngrid, "nmems": nmems, "nobs": nobs}
    try:
        if solver == "ensrf":
            pt["ensrf_seconds"] = _timed_update(
                prior, glat, glon, obs, iters=1, donate=True)
        elif solver == "letkf_host":
            t0 = time.perf_counter()
            pt["letkf_host_seconds"] = _timed_letkf(
                prior, glat, glon, obs, ngrid, patch_size=8, k_obs=64,
                topk_method="host", iters=1)
            pt["letkf_host_wall_incl_build"] = time.perf_counter() - t0
        elif solver == "letkf_approx":
            pt["letkf_approx_seconds"] = _timed_letkf(
                prior, glat, glon, obs, ngrid, patch_size=8, k_obs=64,
                topk_method="approx", iters=1)
        else:
            raise ValueError(f"unknown obscap solver {solver!r}")
    except Exception as e:
        pt[f"{solver}_error"] = repr(e)[:200]
    return pt


def bench_config12(nobs_list=(100_000, 200_000, 500_000), solver=None,
                   nobs_one=None):
    """Obs-capacity scaling: satellite-density batches (100k-500k obs) at
    config-2 scale for both solvers (SURVEY.md §5.7 names large-Nobs a
    hard part; the reference's serial loop is out of the question here).
    Per-point failures are recorded, not fatal — they ARE the capacity
    result.  Each (solver, nobs) point runs in its OWN SUBPROCESS, so a
    point that kills the backend process cannot take the others down."""
    if solver is not None:
        return _config12_point(solver, int(nobs_one))

    import subprocess
    import sys as _s
    import tempfile

    out = {"config": "12-obs-capacity", "points": []}
    for nobs in nobs_list:
        pt = {"nobs": nobs}
        for sv in ("ensrf", "letkf_host", "letkf_approx"):
            with tempfile.NamedTemporaryFile(suffix=".json") as tf:
                cmd = [_s.executable, _os.path.abspath(__file__),
                       "--configs", "12", "--obscap-solver", sv,
                       "--obscap-nobs", str(nobs), "--json", tf.name]
                try:
                    rc = subprocess.run(cmd, timeout=5400,
                                        capture_output=True, text=True)
                except subprocess.TimeoutExpired:
                    pt[f"{sv}_error"] = "subprocess timeout (5400 s)"
                    continue
                if rc.returncode != 0:
                    tail = (rc.stderr or "").strip().splitlines()[-1:]
                    pt[f"{sv}_error"] = (
                        f"subprocess exit {rc.returncode}"
                        + (f": {tail[0][:160]}" if tail else "")
                    )
                    continue
                child = json.load(open(tf.name))[0]
                for k, v in child.items():
                    if k.startswith(sv):
                        pt[k] = v
        out["points"].append(pt)
        print(json.dumps(pt), flush=True)
    return out


def bench_config11(nobs=2000, iters=3):
    """Stochastic EnKF at config-2 scale, serial scan vs the blocked
    two-phase form (round 3; same Gram-corrected machinery as the EnSRF
    with apply rows z = ye - eps; ``enkf.enkf_blocked``)."""
    import functools

    try:
        from benchmarks.breakdown import _chain_time
    except ImportError:  # invoked as `python benchmarks/run_benchmarks.py`
        from breakdown import _chain_time
    from efa_xray_tpu.assimilation import enkf as E

    rng = np.random.default_rng(6)
    ny, nx, nmems = 361, 720, 40
    ngrid = ny * nx
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 0.5)
    lon, lat = np.meshgrid(lon1d, lat1d)
    prior = rng.normal(280, 5, (ngrid, nmems)).astype(np.float32)
    rows = rng.integers(0, ngrid, nobs)
    obs = _obs_arrays(
        prior[rows].mean(1) + rng.normal(0, 1, nobs), np.ones(nobs),
        lat.ravel()[rows], lon.ravel()[rows], np.full(nobs, 2000.0),
        jnp.float32,
    )
    bm = jnp.asarray(prior.mean(1))
    bp = jnp.asarray(prior - prior.mean(1, keepdims=True))
    tm = jnp.asarray(prior[rows].mean(1))
    tp = jnp.asarray(prior[rows] - prior[rows].mean(1, keepdims=True))
    blat = jnp.asarray(lat.ravel(), jnp.float32)
    blon = jnp.asarray(lon.ravel(), jnp.float32)
    eps = E.draw_ob_perturbations(jax.random.PRNGKey(0), obs.errors, nmems)
    out = {"config": "11-enkf-0.5deg", "nstate": ngrid, "nmems": nmems,
           "nobs": nobs}
    for name, fn in (
        ("serial", E.enkf_serial),
        ("blocked", functools.partial(E.enkf_blocked, block_size=128)),
    ):
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def step(b, p, fn=fn):
            r = fn(b, p, tm, tp, blat, blon, obs, eps,
                   localize=True, fast_geometry=True)
            return r[0], r[1]
        try:
            b2, p2 = jnp.array(bm), jnp.array(bp)
            t, _ = _chain_time(
                lambda a, b: step(a, b), (b2, p2), iters=iters)
            out[name + "_seconds"] = t
        except Exception as e:
            out[name + "_seconds"] = None
            out[name + "_error"] = repr(e)[:200]
    if out.get("blocked_seconds"):
        out["obs_points_per_sec"] = nobs * ngrid / out["blocked_seconds"]
    out["backend"] = jax.default_backend()
    return out


BENCHES = {0: bench_config0, 1: bench_config1, 2: bench_config2,
           3: bench_config3, 4: bench_config4, 5: bench_config5,
           6: bench_config6, 7: bench_config7, 8: bench_config8,
           9: bench_config9, 10: bench_config10, 11: bench_config11,
           12: bench_config12}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*",
                    default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--vertical", action="store_true",
                    help="config 3 with vertical localization")
    ap.add_argument("--sharded", action="store_true",
                    help="config 4 through the shard_map path (1-device mesh)")
    ap.add_argument("--kernel", default=None,
                    choices=[None, "kernel", "xla"],
                    help="override kernel selection for config 3")
    ap.add_argument("--letkf-topk", default="exact",
                    choices=["exact", "approx", "host"],
                    help="LETKF obs-selection top-k method for config 7")
    ap.add_argument("--taps-topk", default="exact",
                    choices=["exact", "approx"],
                    help="build_taps candidate-selection method for config 5")
    ap.add_argument("--obscap-solver", default=None,
                    choices=[None, "ensrf", "letkf_host", "letkf_approx"],
                    help="config 12 child mode: run ONE solver point")
    ap.add_argument("--obscap-nobs", type=int, default=None,
                    help="config 12 child mode: the point's nobs")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    results = []
    for c in args.configs:
        kw = {}
        if c == 3:
            kw = dict(vertical=args.vertical, kernel=args.kernel)
        elif c == 4:
            kw = dict(sharded=args.sharded)
        elif c == 7:
            kw = dict(topk_method=args.letkf_topk)
        elif c == 5:
            kw = dict(taps_topk=args.taps_topk)
        elif c == 12 and args.obscap_solver is not None:
            kw = dict(solver=args.obscap_solver, nobs_one=args.obscap_nobs)
        r = BENCHES[c](**kw)
        r["backend"] = jax.default_backend()
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
