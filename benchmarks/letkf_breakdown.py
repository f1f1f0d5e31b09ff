#!/usr/bin/env python
"""Phase breakdown of the LETKF body sweep on the device.

Measures the SELECT phase in isolation (chunked ``[C, 3] x [3, No]``
dots + top-k per patch, exact vs approx) and the full production
``letkf_update`` under each top-k method — select-time by difference
attributes the selection cost.  The solve/apply remainder is
``full - select`` (the phases fuse inside one jit and cannot be timed
separately without changing what is measured); the Newton-Schulz cap
was settled by a head-to-head (12 vs 30 identical — the stall early
exit fires first).

Usage: python benchmarks/letkf_breakdown.py [--nstate 4194304]
       [--nmems 80] [--nobs 10000] [--k 64] [--patch 8] [--iters 2]
"""

from __future__ import annotations

import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from benchmarks.breakdown import _chain_time, _make_workload
from efa_xray_tpu.assimilation import letkf_core as lc
from efa_xray_tpu.observation.localization import latlon_to_unit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nstate", type=int, default=4_194_304)
    ap.add_argument("--nmems", type=int, default=80)
    ap.add_argument("--nobs", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--patch", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--group", type=int, default=0,
                    help="force the host-candidate bundle size (0 = auto)")
    ap.add_argument("--skip-select", action="store_true",
                    help="skip the selection microbench phase")
    args = ap.parse_args()

    bm, bp, tm, tp, blat, blon, obs = _make_workload(
        args.nstate, args.nmems, args.nobs)
    out = {"nstate": args.nstate, "nmems": args.nmems, "nobs": args.nobs,
           "k": args.k, "patch": args.patch, "chunk": args.chunk,
           "backend": jax.default_backend()}

    obs_xyz = latlon_to_unit(obs.lats, obs.lons).astype(jnp.float32)
    ngrid = args.nstate
    npatch = -(-ngrid // args.patch)
    gx = latlon_to_unit(blat, blon).astype(jnp.float32)
    pxyz = gx[: npatch * args.patch].reshape(npatch, args.patch, 3).mean(1)
    pxyz = pxyz / jnp.linalg.norm(pxyz, axis=-1, keepdims=True)

    # --- select phase ----------------------------------------------------
    for method in () if args.skip_select else ("exact", "approx"):
        sel = jax.jit(functools.partial(
            lc.select_local_obs, k=args.k, chunk=args.chunk,
            topk_method=method))

        try:
            # Chain by feeding a tiny function of the indices back into
            # the patch coordinates so consecutive iterations depend on
            # each other (the standard chained-iterations protocol).
            t_sel, _ = _chain_time(
                lambda px: (px + 1e-12 * sel(px, obs_xyz)[:, :1].astype(
                    jnp.float32),),
                (pxyz,), iters=args.iters)
            out[f"select_{method}_seconds"] = t_sel
        except Exception as e:
            out[f"select_{method}_seconds"] = None
            out[f"select_{method}_error"] = repr(e)[:200]
        print(json.dumps({f"select_{method}":
                          out.get(f"select_{method}_seconds")}), flush=True)

    # --- host-certified candidate build (letkf_topk="host") --------------
    import time as _time

    t0 = _time.perf_counter()
    cand_h, mask_h, geff = lc.host_select_candidates(
        np.asarray(blat), np.asarray(blon), ngrid, args.patch,
        np.asarray(obs.lats), np.asarray(obs.lons), args.k,
        chunk=args.chunk,
        **({} if args.group == 0
           else dict(group=args.group, auto_group=False)))
    out["host_build_seconds"] = _time.perf_counter() - t0
    out["host_cand_width"] = int(cand_h.shape[1])
    out["host_cand_mb"] = round(cand_h.nbytes / 1e6, 2)
    cand_d, mask_d = jnp.asarray(cand_h), jnp.asarray(mask_h)
    print(json.dumps({"host_build_seconds": out["host_build_seconds"],
                      "host_cand_width": out["host_cand_width"]}), flush=True)

    # --- full update at knob settings ------------------------------------
    def full_fn(topk, ns_iters):
        if topk == "host":
            # candidates enter as jit ARGUMENTS — a closure capture would
            # embed hundreds of MB of them as HLO constants at pod scale.
            @functools.partial(jax.jit, donate_argnums=(0, 1))
            def fh(bm, bp, cand, mask):
                r = lc.letkf_update(
                    bm, bp, tm, tp, blat, blon, obs, ngrid=ngrid,
                    patch_size=args.patch, k_obs=args.k, localize=True,
                    ns_iters=ns_iters, chunk=args.chunk, topk_method="host",
                    sel_cand=cand, sel_mask=mask, sel_group=geff)
                return r[0], r[1]
            return lambda a, b: fh(a, b, cand_d, mask_d)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def f(bm, bp):
            r = lc.letkf_update(
                bm, bp, tm, tp, blat, blon, obs, ngrid=ngrid,
                patch_size=args.patch, k_obs=args.k, localize=True,
                ns_iters=ns_iters, chunk=args.chunk, topk_method=topk)
            return r[0], r[1]
        return f

    # ns_iters cap 30: the stall-detection early exit fires well before
    # it, so a lower cap changes nothing.
    variants = (("full_exact", "exact", 30),
                ("full_host", "host", 30),
                ("full_approx", "approx", 30))
    if args.group != 0:  # forced-group probe: only the host variant moves
        variants = (("full_host", "host", 30),)
    for name, topk, ns in variants:
        try:
            bm2, bp2 = jnp.array(bm), jnp.array(bp)
            fn = full_fn(topk, ns)
            t, _ = _chain_time(
                lambda a, b: fn(a, b), (bm2, bp2),
                iters=args.iters)
            out[name + "_seconds"] = t
        except Exception as e:
            out[name + "_seconds"] = None
            out[name + "_error"] = repr(e)[:200]
        print(json.dumps({name: out.get(name + "_seconds")}), flush=True)

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
