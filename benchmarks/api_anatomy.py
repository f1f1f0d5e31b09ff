#!/usr/bin/env python
"""Phase anatomy of the public EnSRF.update() path (BASELINE config 5).

Config 5 (full ``EnSRF(state, obs).update()`` at config-2 scale) costs
more than the raw kernels; this script measures where the difference
goes.

Method: PREFIX timing.  The update path is cut into the phases below; for
each prefix we build a fresh filter (taps LRU stays warm, compiles warm)
and run phases 1..i followed by ``block_until_ready`` on the last
output, take the min over repeats, and report differences.

Phases:
  construct   EnSRF.__init__ (coerce + validate; host only)
  obs_arrays  host QC masks + 8 small host->device transfers
  format      compute_ob_priors (taps apply) + to_vect/mean/perts/astype
  coords      body lat/lon host tile + transfer (structure-static!)
  tail        tail_scan_blocked (obs-space serial solve)
  body        phase-2 body sweep (the "raw kernel" of config 2)
  diags       record_diagnostics (batched device_get)
  posterior   format_posterior_state + adaptive-inflation hook

Usage: python benchmarks/api_anatomy.py [--repeats 5] [--json out]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def build_workload(seed=5, ny=361, nx=720, nmems=40, nobs=2000):
    from efa_xray_tpu.observation.observation import ObservationBatch
    from efa_xray_tpu.state.ensemble import EnsembleState
    from efa_xray_tpu.utils import timeutil

    rng = np.random.default_rng(seed)
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 360.0 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(1) * np.timedelta64(6, "h")
    field = rng.normal(280, 5, (1, ny, nx, nmems)).astype(np.float32)
    state = EnsembleState.from_vardict(
        {"T2m": field},
        {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)},
        dtype="float32",
    )
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
    return state, batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--json", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test shapes (CPU/interpret-mode friendly)")
    args = ap.parse_args()

    from efa_xray_tpu.assimilation import ensrf_core as core
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig

    if args.tiny:
        state, batch = build_workload(ny=36, nx=72, nmems=8, nobs=20)
        cfg = FilterConfig(localization="GC", dtype="float32",
                           fast_geometry=True)
    else:
        state, batch = build_workload()
        cfg = FilterConfig(localization="GC", dtype="float32",
                           fast_geometry=True)
    dtype = jnp.dtype(cfg.dtype)

    def pull(*xs):
        jax.block_until_ready(xs)

    # ---- the phase chain; each returns something device-pullable --------
    def make_filter():
        return EnSRF(state, batch, config=cfg, verbose=False)

    def run_prefix(n):
        """Run phases [0..n); return a waiter for the last output."""
        filt = make_filter()
        if n == 0:
            return lambda: None
        oa = filt.obs_arrays()
        out = lambda: pull(oa.values)
        if n >= 2:
            bm, bp, tm, tp = filt.format_prior_state()
            oa = filt.apply_outlier_check(oa, tm, tp)
            out = lambda: pull(bm, tp)
        if n >= 3:
            # Mirrors the production path: structure-cached device coords
            # (one upload per structure+dtype; see row_latlon_device).
            blat, blon = filt.prior.structure.row_latlon_device(dtype)
            out = lambda: pull(blat, blon)
        if n >= 4:
            kern = filt._kernels()
            tail = core.tail_scan_blocked(
                tm, tp, oa, localize=cfg.localize,
                unbiased=cfg.unbiased_variance, fast_geometry=True,
                panel=cfg.tail_panel, kernels=kern.tail,
            )
            out = lambda: pull(tail.tail_mean)
        if n >= 5:
            # The same phase-2 dispatch as EnSRF.update().
            bm2, bp2 = filt._body_apply(bm, bp, blat, blon, tail, oa,
                                        jnp.zeros_like(blat), False, {}, {})
            out = lambda: pull(bm2, bp2)
        if n >= 6:
            filt.record_diagnostics(tail.diags)  # inherent host pull
        if n >= 7:
            post, _ = filt.format_posterior_state(bm2, bp2)
            out = lambda: pull(post.data)
        return out

    # Prefix n runs phases [0..n]: prefix 0 is construct alone (no pull),
    # prefix 7 is the full chain ending in the posterior rebuild.
    names = ["construct", "obs_arrays", "format", "coords", "tail",
             "body", "diags", "posterior"]

    # Warm every compile in every prefix.
    for n in range(len(names)):
        out = run_prefix(n)
        if out is not None:
            out()

    prefix_t = []
    for n in range(len(names)):
        best = np.inf
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = run_prefix(n)
            if out is not None:
                out()
            best = min(best, time.perf_counter() - t0)
        prefix_t.append(best)

    # Full public path for the cross-check (what config 5 publishes).
    def full():
        filt = make_filter()
        t0 = time.perf_counter()
        post, _ = filt.update()
        pull(post.data)
        return time.perf_counter() - t0

    full()
    t_full = min(full() for _ in range(args.repeats))

    # prefix_t[n] times phases [0..n]; phase n's cost is the consecutive
    # difference (phase 0 = construct = prefix_t[0] itself).
    phases = {names[0]: round(max(prefix_t[0], 0.0), 6)}
    for i in range(1, len(names)):
        dt = prefix_t[i] - prefix_t[i - 1]
        phases[names[i]] = round(max(dt, 0.0), 6)
    result = {
        "config": "api-anatomy-config5",
        "device": jax.devices()[0].device_kind,
        "phases_seconds": phases,
        "prefix_seconds": [round(t, 6) for t in prefix_t],
        "full_update_seconds": round(t_full, 6),
        "note": "prefix timing; prefix n runs phases [0..n] and ends in "
                "block_until_ready (except construct, which makes no device "
                "output); full_update is the real EnSRF.update() wall time "
                "for cross-check",
    }
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
