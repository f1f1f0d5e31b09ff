#!/usr/bin/env python
"""Multivariate EFA on a rotating shallow-water channel: height
observations correct the WIND field — and the future forecast — through
flow-dependent ensemble covariances.

This is the mechanism the reference's EFA use case is built on (Madaus &
Hakim 2015; the reference demo adjusts a forecast trajectory through
time covariances, ``efa_demo.ipynb`` cell 11) demonstrated on a
dynamical model with a real balance relation: the ensemble's eta<->wind
covariances encode near-geostrophy, so assimilating ONLY height
observations produces wind increments that survive integration instead
of radiating away as gravity waves.

Run: ``python examples/multivariate_swe.py [--cycles 5]``
(CPU, ~2 min: the spinup integration dominates.)
"""

import argparse

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax

# Demo-scale problem: thousands of tiny RK4 steps at 16x32 — the host CPU
# runs it as fast as any accelerator.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.models import swe
from efa_xray_tpu.models.cycling import CyclingHarness


def per_var_rmse(flat_ens, flat_truth, n):
    out = {}
    for i, v in enumerate(swe.VAR_ORDER):
        sl = slice(i * n, (i + 1) * n)
        out[v] = float(
            np.sqrt(np.mean((flat_ens[:, sl].mean(0) - flat_truth[sl]) ** 2))
        )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--ny", type=int, default=16)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nmems", type=int, default=12)
    args = ap.parse_args()
    ny, nx, nm = args.ny, args.nx, args.nmems
    n = ny * nx

    print(f"spinning up a {ny}x{nx} eddying channel, {nm} members ...")
    truth, ens = swe.spinup_ensemble(
        ny=ny, nx=nx, nmems=nm, seed=0, spinup_steps=2500, member_steps=400
    )
    flat_ens = np.asarray(swe.pack(ens, ny, nx))
    flat_truth = np.asarray(swe.pack(truth, ny, nx))

    # --- one analysis: observe eta at every 2nd point, NO wind obs ---
    lat, lon = swe.grid_latlon(ny, nx)
    rows = swe.var_rows("eta", ny, nx, stride=2)
    rng = np.random.default_rng(7)
    ob_error = 1e-4
    yvals = flat_truth[rows] + np.sqrt(ob_error) * rng.standard_normal(
        len(rows)
    )
    h = CyclingHarness(
        forecast=swe.make_flat_forecast(ny, nx, nsteps=10),
        state_lats=lat,
        state_lons=lon,
        ob_error=ob_error,
        localize_radius=4000.0,
        obs_operator_rows=rows,
        config=FilterConfig(rtps_alpha=0.5),
    )
    post, _ = h.analysis_step(
        jnp.asarray(flat_ens), jnp.asarray(yvals), lat[rows], lon[rows]
    )
    post = np.asarray(post)

    bg, an = (per_var_rmse(e, flat_truth, n) for e in (flat_ens, post))
    print("\nsingle analysis, height obs only (ensemble-mean RMSE):")
    for v in swe.VAR_ORDER:
        tag = "observed" if v == "eta" else "NEVER observed"
        print(
            f"  {v:3s} background {bg[v]:.5f} -> analysis {an[v]:.5f}"
            f"  ({an[v] / bg[v]:.2f}x, {tag})"
        )

    # --- forecast impact: integrate background vs analysis forward ---
    nfc = 200
    tr_fc = swe.integrate(truth, ny, nsteps=nfc)
    pri_fc = swe.pack(
        swe.integrate(swe.unpack(jnp.asarray(flat_ens), ny, nx), ny, nfc),
        ny, nx,
    )
    pos_fc = swe.pack(
        swe.integrate(swe.unpack(jnp.asarray(post), ny, nx), ny, nfc),
        ny, nx,
    )
    t_flat = np.asarray(swe.pack(tr_fc, ny, nx))
    fb = per_var_rmse(np.asarray(pri_fc), t_flat, n)
    fa = per_var_rmse(np.asarray(pos_fc), t_flat, n)
    print(f"\nforecast impact after {nfc} steps:")
    for v in swe.VAR_ORDER:
        print(
            f"  {v:3s} from background {fb[v]:.5f} -> from analysis"
            f" {fa[v]:.5f}  ({fa[v] / fb[v]:.2f}x)"
        )

    # --- a few full cycles ---
    print(f"\ncycling ({args.cycles} cycles, height obs only):")
    stats = h.run(flat_ens, flat_truth, args.cycles, seed=3)
    for s in stats:
        print(
            f"  cycle {s.cycle}: bg={s.background_rmse:.4f}"
            f" an={s.analysis_rmse:.4f} spread={s.mean_spread:.4f}"
        )


if __name__ == "__main__":
    main()
