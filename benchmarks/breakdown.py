#!/usr/bin/env python
"""Measured phase breakdown of the EnSRF update.

Splits the update into its phases on the device, each chained and closed
with ``block_until_ready`` after a warm-up call that compiles:

* ``tail``  — phase-1 hierarchical tail solve (``tail_scan_blocked``),
  XLA and Triton kernels;
* ``body``  — phase-2 body sweep through the Triton kernel
  (``ops/ensrf_triton.body_update``);
* ``total`` — both chained together;
* cull accounting — alive fraction of (row-tile, obs-block) pairs from
  the same ``cull_masks`` the kernel reads.

Workloads: 2048 obs x 1.05M rows x 80 members, the headline size
(10k x 1e7 x 80), and the large-nobs regime (50k obs x 260k rows x 40
members), with a tail-panel sweep there since phase 1 is the
nobs-scaling term.

Usage: python benchmarks/breakdown.py [--workloads headline pod nobs50k]
                                      [--json out.json]
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



def _chain_time(step, carry, iters=3):
    """(seconds per chained call of ``step``, last carry), after one
    warm-up call that compiles; ``block_until_ready`` closes the window."""
    carry = jax.block_until_ready(step(*carry))
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step(*carry)
    jax.block_until_ready(carry)
    return max((time.perf_counter() - t0) / iters, 1e-9), carry


def _make_workload(nstate, nmems, nobs, radius=2000.0, seed=4):
    """Hilbert-ingested synthetic workload, generated on device (see
    run_benchmarks.bench_config10 for why)."""
    from efa_xray_tpu.observation.thinning import _hilbert3d_np

    rng = np.random.default_rng(seed)
    state_lat = rng.uniform(-88, 88, nstate)
    state_lon = rng.uniform(0, 360, nstate)
    ro = np.argsort(_hilbert3d_np(state_lat, state_lon), kind="stable")
    state_lat, state_lon = state_lat[ro], state_lon[ro]
    rows = rng.integers(0, nstate, nobs)
    olat, olon = state_lat[rows], state_lon[rows]
    oo = np.argsort(_hilbert3d_np(olat, olon), kind="stable")
    olat, olon = olat[oo], olon[oo]
    vals = 280.0 + rng.normal(0, 1, nobs)
    obs = core.ObsArrays(
        values=jnp.asarray(vals, jnp.float32),
        errors=jnp.ones(nobs, jnp.float32),
        lats=jnp.asarray(olat, jnp.float32),
        lons=jnp.asarray(olon, jnp.float32),
        radii=jnp.full(nobs, radius, jnp.float32),
        assim=jnp.ones(nobs, dtype=bool),
    )
    bm = 280.0 + 0.5 * jax.random.normal(
        jax.random.PRNGKey(3), (nstate,), dtype=jnp.float32)
    bp = 5.0 * jax.random.normal(
        jax.random.PRNGKey(4), (nstate, nmems), dtype=jnp.float32)
    tp0 = 5.0 * jax.random.normal(
        jax.random.PRNGKey(5), (nobs, nmems), dtype=jnp.float32)
    tm = jnp.mean(tp0, axis=1) + 280.0
    tp = tp0 - jnp.mean(tp0, axis=1)[:, None]
    blat = jnp.asarray(state_lat, jnp.float32)
    blon = jnp.asarray(state_lon, jnp.float32)
    return bm, bp, tm, tp, blat, blon, obs


def measure(nstate, nmems, nobs, name, panel=64, iters=3, panels_sweep=()):
    from efa_xray_tpu.observation.localization import latlon_to_unit
    from efa_xray_tpu.ops.ensrf_triton import (
        BLOCK_OBS, TILE_ROWS, body_update, cull_masks)

    bm, bp, tm, tp, blat, blon, obs = _make_workload(nstate, nmems, nobs)
    out = {"workload": name, "nstate": nstate, "nmems": nmems, "nobs": nobs,
           "panel": panel, "device": jax.devices()[0].device_kind}

    # --- phase 1: tail solve (chained on the tail arrays) ---------------
    def tail_step_fn(p, kernels=False):
        @jax.jit
        def f(tm, tp):
            t = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                       fast_geometry=True, panel=p,
                                       kernels=kernels)
            return t.tail_mean, t.tail_perts
        return f

    def timed_tail(key, p, kernels=False):
        try:
            fn = tail_step_fn(p, kernels)
            out[key], _ = _chain_time(fn, (tm, tp), iters=iters)
        except Exception as e:  # e.g. runtime OOM of one variant
            out[key] = None
            out[key + "_error"] = repr(e)[:200]

    timed_tail("tail_seconds", panel)
    timed_tail("tail_kernel_seconds", panel, kernels=True)
    for p in panels_sweep:
        if p == panel:
            continue
        timed_tail(f"tail_seconds_panel{p}", p)
        timed_tail(f"tail_kernel_seconds_panel{p}", p, kernels=True)

    # --- phase 2: body kernel sweep (fixed tail, chained on the body) ---
    t_body = None
    try:
        tail_sol = jax.block_until_ready(core.tail_scan_blocked(
            tm, tp, obs, localize=True, fast_geometry=True, panel=panel,
            kernels=True))

        @functools_partial_jit(donate=(0, 1))
        def body_step(bm, bp):
            return body_update(bm, bp, blat, blon, tail_sol, obs,
                               localize=True, geometry="chordal")

        t_body, carry = _chain_time(body_step, (bm, bp), iters=iters)
        out["body_seconds"] = t_body
        del carry
    except Exception as e:
        out["body_seconds"] = None
        out["body_error"] = repr(e)[:200]

    # --- total (tail + body, one jit) -----------------------------------
    try:
        bm, bp, tm2, tp2, blat, blon, obs = _make_workload(
            nstate, nmems, nobs)

        @functools_partial_jit(donate=(0, 1))
        def full_step(bm, bp, tm, tp):
            t = core.tail_scan_blocked(tm, tp, obs, localize=True,
                                       fast_geometry=True, panel=panel,
                                       kernels=True)
            bm2, bp2 = body_update(bm, bp, blat, blon, t, obs,
                                   localize=True, geometry="chordal")
            return bm2, bp2, t.tail_mean, t.tail_perts

        out["total_seconds"], _ = _chain_time(
            full_step, (bm, bp, tm2, tp2), iters=iters)
    except Exception as e:
        out["total_seconds"] = None
        out["total_error"] = repr(e)[:200]

    # --- cull accounting -------------------------------------------------
    alive = cull_masks(latlon_to_unit(blat, blon).astype(jnp.float32),
                       latlon_to_unit(obs.lats, obs.lons).astype(jnp.float32),
                       obs.radii, obs.assim, TILE_ROWS, BLOCK_OBS)
    out["cull_alive_pair_fraction"] = float(jnp.mean(alive))
    return out


def functools_partial_jit(donate=()):
    import functools

    def deco(f):
        return jax.jit(f, donate_argnums=donate)

    return deco


WORKLOADS = {
    "headline": dict(nstate=1_048_576, nmems=80, nobs=2048),
    "pod": dict(nstate=10_000_000, nmems=80, nobs=10_000, iters=2),
    "nobs50k": dict(nstate=259_920, nmems=40, nobs=50_000, iters=2,
                    panels_sweep=(128, 256, 512)),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", nargs="*",
                    default=["headline", "pod", "nobs50k"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    results = []
    for w in args.workloads:
        r = measure(name=w, **WORKLOADS[w])
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
