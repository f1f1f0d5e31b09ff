#!/usr/bin/env python
"""Attribute the LETKF update's remaining cost: body sweep vs the
obs-space diagnostics tail (per-ob patch solves + transforms).

After `letkf_topk="host"` removed most of the BODY selection cost, this
probe times the body sweep alone
(host candidates) against the full update to size the diagnostics tail
(`select_local_obs(obs, obs)` + `solve_patch_weights` + transforms),
which still selects on device over all No obs per OB.  If the tail is a
large fraction, host-certifying the per-ob selection is the next lever.

Run: python benchmarks/letkf_tail_probe.py
    [--nstate 259920] [--nmems 40] [--nobs 50000]
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

from benchmarks.breakdown import _chain_time, _make_workload  # noqa: E402
from efa_xray_tpu.assimilation import letkf_core as lc  # noqa: E402
from efa_xray_tpu.observation.localization import latlon_to_unit  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nstate", type=int, default=259_920)
    ap.add_argument("--nmems", type=int, default=40)
    ap.add_argument("--nobs", type=int, default=50_000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--patch", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    bm, bp, tm, tp, blat, blon, obs = _make_workload(
        args.nstate, args.nmems, args.nobs)
    ngrid = args.nstate
    out = {"config": "letkf-tail-probe", "nstate": ngrid,
           "nmems": args.nmems, "nobs": args.nobs, "k": args.k,
           "patch": args.patch, "backend": jax.default_backend()}

    cand_h, mask_h, geff = lc.host_select_candidates(
        np.asarray(blat), np.asarray(blon), ngrid, args.patch,
        np.asarray(obs.lats), np.asarray(obs.lons), args.k,
        chunk=args.chunk)
    cand_d, mask_d = jnp.asarray(cand_h), jnp.asarray(mask_h)

    dtype = bp.dtype
    innov = (obs.values.astype(dtype) - tm).astype(dtype)
    rinv = jnp.where(obs.assim, 1.0 / jnp.maximum(
        obs.errors.astype(dtype), jnp.finfo(dtype).tiny), 0.0).astype(dtype)
    obs_xyz = latlon_to_unit(obs.lats, obs.lons).astype(dtype)
    radii = obs.radii.astype(dtype)
    grid_xyz = latlon_to_unit(blat.astype(dtype), blon.astype(dtype)
                              ).astype(dtype)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def body_only(bm_, bp_, cand, mask):
        return lc._analyze_body_chunked(
            bm_, bp_, tp, innov, rinv, obs_xyz, radii, grid_xyz,
            ngrid=ngrid, patch_size=args.patch, k_obs=args.k,
            sqrt_method="newton_schulz", ns_iters=30, chunk=args.chunk,
            topk_method="host", sel_cand=cand, sel_mask=mask,
            sel_group=geff)

    t_body, _ = _chain_time(
        lambda a, b: body_only(a, b, cand_d, mask_d),
        (jnp.array(bm), jnp.array(bp)), iters=args.iters)
    out["body_host_seconds"] = t_body
    print(json.dumps({"body_host_seconds": t_body}), flush=True)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def full(bm_, bp_, cand, mask):
        r = lc.letkf_update(
            bm_, bp_, tm, tp, blat, blon, obs, ngrid=ngrid,
            patch_size=args.patch, k_obs=args.k, localize=True,
            chunk=args.chunk, topk_method="host", sel_cand=cand,
            sel_mask=mask, sel_group=geff)
        return r[0], r[1]

    t_full, _ = _chain_time(
        lambda a, b: full(a, b, cand_d, mask_d),
        (jnp.array(bm), jnp.array(bp)), iters=args.iters)
    out["full_host_seconds"] = t_full
    out["diag_tail_seconds"] = t_full - t_body
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
