#!/usr/bin/env python
"""A/B of the LETKF nearest-k selection's matmul precision on a device.

The selection ranks observations by chordal dot products from one
``[P, 3] x [3, No]`` einsum.  A default-precision f32 matmul may round
its inputs (TF32 on a GPU: ~sqrt(2*2^-11) rad ~ 200 km of ranking
resolution for chord dots near 1.0), so an "exact" nearest-k selection
at the default would choose obs sets mis-ranked by hundreds of km.  This
script measures, at a config-6-shaped workload:

* the fraction of patches whose DEFAULT-precision top-k set differs
  from the HIGHEST-precision one, and both against a float64 host
  oracle (exact chord ranking);
* the cost of the fix: dots + top_k timing at both precisions (the K=3
  contraction is expected to be noise next to the top_k).

Run:  python benchmarks/letkf_select_precision_ab.py [--json OUT]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))

from efa_xray_tpu.observation.localization import latlon_to_unit  # noqa: E402


def _selection(pxyz, oxyz, k, precision, chunk=4096):
    npatch = pxyz.shape[0]
    nchunks = -(-npatch // chunk)
    pad = nchunks * chunk - npatch
    p = jnp.pad(pxyz, ((0, pad), (0, 0))).reshape(nchunks, chunk, 3)

    def one(pts):
        dots = jnp.einsum("pc,oc->po", pts, oxyz,
                          preferred_element_type=jnp.float32,
                          precision=precision)
        _, idx = jax.lax.top_k(dots, k)
        return idx

    return jax.lax.map(one, p).reshape(nchunks * chunk, k)[:npatch]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ny", type=int, default=361)
    ap.add_argument("--nx", type=int, default=720)
    ap.add_argument("--nobs", type=int, default=2000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--patch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    lat1 = np.linspace(-90.0, 90.0, args.ny)
    lon1 = np.arange(args.nx) * (360.0 / args.nx)
    lon, lat = np.meshgrid(lon1, lat1)
    glat, glon = lat.ravel(), lon.ravel()
    ngrid = glat.size
    npatch = -(-ngrid // args.patch)
    gpad = npatch * args.patch - ngrid
    # patch centers exactly as letkf_core builds them (mean then normalize)
    gxyz = np.asarray(jnp.stack(
        latlon_to_unit(jnp.asarray(np.concatenate([glat, glat[-1:].repeat(gpad)])),
                       jnp.asarray(np.concatenate([glon, glon[-1:].repeat(gpad)]))),
        axis=-1), dtype=np.float64)
    pxyz64 = gxyz.reshape(npatch, args.patch, 3).mean(axis=1)
    pxyz64 /= np.maximum(np.linalg.norm(pxyz64, axis=-1, keepdims=True), 1e-12)

    olat = rng.uniform(-88.0, 88.0, args.nobs)
    olon = rng.uniform(0.0, 360.0, args.nobs)
    oxyz64 = np.stack([np.cos(np.radians(olat)) * np.cos(np.radians(olon)),
                       np.cos(np.radians(olat)) * np.sin(np.radians(olon)),
                       np.sin(np.radians(olat))], axis=-1)

    # float64 host oracle: exact chord ranking (set comparison)
    dots64 = pxyz64 @ oxyz64.T
    oracle = np.argsort(-dots64, axis=1, kind="stable")[:, :args.k]
    oracle_sets = [frozenset(r) for r in oracle]

    pxyz = jnp.asarray(pxyz64, dtype=jnp.float32)
    oxyz = jnp.asarray(oxyz64, dtype=jnp.float32)

    out = {"config": "letkf-select-precision-ab", "ny": args.ny,
           "nx": args.nx, "nobs": args.nobs, "k": args.k,
           "patch": args.patch, "backend": jax.devices()[0].platform}
    sel = {}
    for name, prec in [("default", jax.lax.Precision.DEFAULT),
                       ("highest", jax.lax.Precision.HIGHEST)]:
        fn = jax.jit(lambda p, o, prec=prec: _selection(p, o, args.k, prec))
        idx = np.asarray(fn(pxyz, oxyz))
        sel[name] = idx
        diff = sum(frozenset(r) != s for r, s in zip(idx, oracle_sets))
        out[f"{name}_vs_f64_set_diff_frac"] = diff / npatch
        t0 = time.perf_counter()
        for _ in range(args.iters):
            jax.block_until_ready(fn(pxyz, oxyz))
        out[f"{name}_seconds"] = (time.perf_counter() - t0) / args.iters
    out["default_vs_highest_set_diff_frac"] = (
        sum(frozenset(a) != frozenset(b)
            for a, b in zip(sel["default"], sel["highest"])) / npatch
    )
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
