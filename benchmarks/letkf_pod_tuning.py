#!/usr/bin/env python
"""LETKF pod-slice operating-point sweep.

The pod-slice LETKF (4.19M x 80, 10k obs) splits into the exact
nearest-k selection (cut by the host kd-tree certificates) and the
per-patch ensemble-space work — dominated by the batched Newton-Schulz
inverse-sqrt on [M, M] Grams, whose COUNT scales as ngrid / patch_size.  patch_size is therefore
the big remaining lever: doubling it halves the solve count at the cost
of each row sharing its obs set with more neighbors.

This sweep measures (seconds, posterior delta vs the patch-8 exact
reference) over patch_size x selection method, so the recipes can state
the cost/accuracy trade instead of guessing.  Deltas are reported as
maxabs(mean)/spread and rms(mean)/spread — the same normalization the
precision A/Bs use.

Usage: python benchmarks/letkf_pod_tuning.py [--nstate 4194304]
       [--nmems 80] [--nobs 10000] [--json out]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nstate", type=int, default=4_194_304)
    ap.add_argument("--nmems", type=int, default=80)
    ap.add_argument("--nobs", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--patches", type=int, nargs="*", default=[8, 16, 32])
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force the host CPU backend (smoke tests)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from efa_xray_tpu.assimilation import letkf_core
    from efa_xray_tpu.assimilation import ensrf_core as core
    from efa_xray_tpu.observation.thinning import _hilbert3d_np

    rng = np.random.default_rng(7)
    ngrid, nmems, nobs = args.nstate, args.nmems, args.nobs
    glat = rng.uniform(-88.0, 88.0, ngrid)
    glon = rng.uniform(0.0, 360.0, ngrid)
    ro = np.argsort(_hilbert3d_np(glat, glon), kind="stable")
    glat, glon = glat[ro], glon[ro]
    rows = rng.integers(0, ngrid, nobs)
    olat, olon = glat[rows], glon[rows]
    oo = np.argsort(_hilbert3d_np(olat, olon), kind="stable")
    olat, olon = olat[oo], olon[oo]

    dtype = jnp.float32
    bm = 280.0 + 0.5 * jax.random.normal(jax.random.PRNGKey(3), (ngrid,),
                                         dtype=dtype)
    bp = 5.0 * jax.random.normal(jax.random.PRNGKey(4), (ngrid, nmems),
                                 dtype=dtype)
    tp0 = 5.0 * jax.random.normal(jax.random.PRNGKey(5), (nobs, nmems),
                                  dtype=dtype)
    tm = jnp.mean(tp0, axis=1) + 280.0
    tp = tp0 - jnp.mean(tp0, axis=1)[:, None]
    obs = core.ObsArrays(
        values=jnp.asarray(280.0 + rng.normal(0, 1, nobs), dtype=dtype),
        errors=jnp.ones(nobs, dtype=dtype),
        lats=jnp.asarray(olat, dtype=dtype),
        lons=jnp.asarray(olon, dtype=dtype),
        radii=jnp.asarray(np.full(nobs, 2000.0), dtype=dtype),
        assim=jnp.ones(nobs, dtype=bool),
    )
    jlat = jnp.asarray(glat, dtype=dtype)
    jlon = jnp.asarray(glon, dtype=dtype)

    def run(patch, topk):
        sel_kwargs = {}
        host_build = None
        if topk == "host":
            t0 = time.perf_counter()
            cand, mask, geff = letkf_core.host_select_candidates(
                glat, glon, ngrid, patch, olat, olon, args.k,
                chunk=args.chunk)
            host_build = time.perf_counter() - t0
            sel_kwargs = dict(sel_cand=jnp.asarray(cand),
                              sel_mask=jnp.asarray(mask), sel_group=geff)

        def step(bm_, bp_):
            out = letkf_core.letkf_update(
                bm_, bp_, tm, tp, jlat, jlon, obs, ngrid=ngrid,
                patch_size=patch, k_obs=args.k, chunk=args.chunk,
                topk_method=topk, **sel_kwargs,
            )
            return out[0], out[1]

        jax.block_until_ready(step(bm, bp))  # compile
        t0 = time.perf_counter()
        am, ap_ = jax.block_until_ready(step(bm, bp))
        dt = time.perf_counter() - t0
        return max(dt, 1e-9), host_build, am, ap_

    results = {"config": "letkf-pod-tuning", "nstate": ngrid,
               "nmems": nmems, "nobs": nobs, "k": args.k,
               "chunk": args.chunk,
               "backend": jax.default_backend(), "points": []}

    # Reference: patch 8, exact selection (the published config-7 path).
    t_ref, _, am_ref, ap_ref = run(8, "exact")
    spread = float(jnp.sqrt(jnp.mean(ap_ref**2)))
    results["points"].append({"patch": 8, "topk": "exact",
                              "seconds": t_ref})
    print(json.dumps(results["points"][-1]), flush=True)

    for patch in args.patches:
        for topk in (("host",) if patch == 8 else ("exact", "host")):
            t, build, am, ap_ = run(patch, topk)
            dm = jnp.abs(am - am_ref)
            dp = jnp.abs(ap_ - ap_ref)
            pt = {
                "patch": patch, "topk": topk, "seconds": t,
                "host_build_seconds": build,
                "mean_maxabs_delta_over_spread":
                    float(jnp.max(dm)) / spread,
                "mean_rms_delta_over_spread":
                    float(jnp.sqrt(jnp.mean(dm**2))) / spread,
                "perts_maxabs_delta_over_spread":
                    float(jnp.max(dp)) / spread,
            }
            results["points"].append(pt)
            print(json.dumps(pt), flush=True)

    print(json.dumps(results, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
