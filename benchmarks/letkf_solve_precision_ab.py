#!/usr/bin/env python
"""A/B of the LETKF ensemble-space SOLVE chain's matmul precision.

The LETKF's per-patch solve (``C = Y^T diag(rho/R) Y`` build, the
Newton-Schulz inverse-sqrt iterations, and the ``wbar`` solve) runs on
tiny ``[C, K, M]`` / ``[C, M, M]`` operands; at a reduced-precision
default (TF32 on a GPU) the NS iteration stalls at a ``max |ZY - I|``
floor set by the input rounding instead of the true f32 fixed point
(~1e-5).  ``FilterConfig.letkf_solve_precision`` pins just this chain.
This script measures, on the device:

1. the NS accuracy floor per precision against a float64 host ``eigh``
   oracle, on amat batches built exactly the way the body builds them;
2. the full ``letkf_update`` wall time at solve_precision default vs
   highest (config-6-shaped workload) — the cost of the fix;
3. the posterior mean/perturbation delta default-vs-highest, normalized
   by the posterior spread — how much analysis the floor was costing.

Run:  python benchmarks/letkf_solve_precision_ab.py [--json OUT]
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np

import jax
import jax.numpy as jnp

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from benchmarks.breakdown import _chain_time, _make_workload  # noqa: E402
from efa_xray_tpu.assimilation import letkf_core as lc  # noqa: E402


def _ns_floor(nens, chunk, k, seed=0):
    """NS inverse-sqrt error vs f64 eigh, per precision, on amat built
    like the body builds it (default-precision C einsum included, so the
    probe isolates the ITERATION's precision, which is what the knob
    actually controls for a fixed amat)."""
    rng = np.random.default_rng(seed)
    yl = rng.normal(0.0, 5.0, (chunk, k, nens)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (chunk, k)).astype(np.float32)
    ylj = jnp.asarray(yl)
    ya = ylj * jnp.asarray(a)[..., None]
    amat = (nens - 1) * jnp.eye(nens, dtype=jnp.float32) + jnp.einsum(
        "ckm,ckn->cmn", ya, ylj, preferred_element_type=jnp.float32)
    amat_np = np.asarray(amat, dtype=np.float64)
    w, v = np.linalg.eigh(amat_np)
    ref = np.einsum("cij,cj,ckj->cik", v, 1.0 / np.sqrt(w), v)
    scale = np.max(np.abs(ref))
    out = {}
    for name, prec in (("default", None),
                       ("highest", jax.lax.Precision.HIGHEST)):
        fn = jax.jit(functools.partial(
            lc._invsqrt_newton_schulz, iters=30, precision=prec))
        inv_sqrt, _ = fn(amat)
        err = float(np.max(np.abs(np.asarray(inv_sqrt, np.float64) - ref)))
        out[f"ns_{name}_invsqrt_maxabs_err_rel"] = err / scale
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nstate", type=int, default=259_920)
    ap.add_argument("--nmems", type=int, default=40)
    ap.add_argument("--nobs", type=int, default=2000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--patch", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    out = {"config": "letkf-solve-precision-ab", "nstate": args.nstate,
           "nmems": args.nmems, "nobs": args.nobs, "k": args.k,
           "patch": args.patch, "backend": jax.default_backend()}

    # 1. NS floor probe (tiny, fast)
    out.update(_ns_floor(args.nmems, 64, args.k))
    print(json.dumps({k: v for k, v in out.items() if k.startswith("ns_")}),
          flush=True)

    # 2+3. full update: accuracy compare then timing, per precision
    bm, bp, tm, tp, blat, blon, obs = _make_workload(
        args.nstate, args.nmems, args.nobs)
    posts = {}
    for sp in ("default", "highest"):
        upd = jax.jit(functools.partial(
            lc.letkf_update, ngrid=args.nstate, patch_size=args.patch,
            k_obs=args.k, localize=True, chunk=args.chunk,
            solve_precision=sp))
        r = upd(bm, bp, tm, tp, blat, blon, obs)
        posts[sp] = (np.asarray(r[0], np.float64), np.asarray(r[1], np.float64))

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def step(m, p, _upd=upd):
            r = _upd(m, p, tm, tp, blat, blon, obs)
            return r[0], r[1]

        t, _ = _chain_time(
            lambda a, b: step(a, b), (jnp.array(bm), jnp.array(bp)), iters=args.iters)
        out[f"{sp}_seconds"] = t
        print(json.dumps({f"{sp}_seconds": t}), flush=True)

    spread = float(np.sqrt(np.mean(posts["highest"][1] ** 2)))
    out["mean_maxabs_delta_over_spread"] = float(
        np.max(np.abs(posts["default"][0] - posts["highest"][0]))) / spread
    out["perts_maxabs_delta_over_spread"] = float(
        np.max(np.abs(posts["default"][1] - posts["highest"][1]))) / spread
    out["highest_cost_factor"] = out["highest_seconds"] / out["default_seconds"]
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
