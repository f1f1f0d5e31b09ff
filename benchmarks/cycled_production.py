#!/usr/bin/env python
"""Production cycled DA benchmark at gridded scale (BASELINE config 13).

The number a real user asks first: what does a CYCLE cost, end to end,
with the production feature set on?  Cycles the 2-D Lorenz-96 testbed
(`efa_xray_tpu.models.l96_2d`) at >= 100k grid points through the PUBLIC
API — EnsembleState + ObservationBatch + EnSRF.update() — with:

  * a STATIONARY off-grid observation network (forward-operator taps
    built once and LRU-cached, like any fixed surface network),
  * Anderson-2009 adaptive inflation with the evolved std
    (FilterConfig.adaptive_sd_evolve),
  * innovation-based gross-error QC (outlier_threshold),
  * online observation bias correction (observation.bias.BiasCorrection)
    against a deliberately biased synthetic network,
  * verification every cycle (analysis RMSE / spread / obs-space CRPS).

Per-cycle phase breakdown (forecast / obgen / update / inflation-learn /
verify), each closed with ``block_until_ready``; reports the breakdown
of a LATE cycle (everything compiled and cached) plus RMSE/spread/CRPS
series statistics.

Usage: python benchmarks/cycled_production.py [--cycles 20] [--ny 320]
       [--nx 320] [--nmems 40] [--nobs 2000] [--json out]
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
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--ny", type=int, default=320)
    ap.add_argument("--nx", type=int, default=320)
    ap.add_argument("--nmems", type=int, default=40)
    ap.add_argument("--nobs", type=int, default=8000)
    ap.add_argument("--ob-bias", type=float, default=0.3)
    ap.add_argument("--radius", type=float, default=500.0,
                    help="GC localization halfwidth km.  L96-2d's "
                         "correlation length is INDEX-based (~2-3 grid "
                         "columns), so the radius must scale with grid "
                         "spacing: at 320x320 (125 km zonal spacing) a "
                         "2000 km radius admits ~1500 points per "
                         "footprint of which only ~10 are truly "
                         "correlated, and the 40-member sampling noise "
                         "in the rest accumulates until the forecast "
                         "leaves the attractor (measured: NaN by cycle "
                         "3-4 at radius 2000).")
    ap.add_argument("--damp", type=float, default=0.7,
                    help="DART-style inflation damping factor "
                         "(calibrated: docs/recipes.md inflation table)")
    ap.add_argument("--max", dest="adaptive_max", type=float, default=1.7,
                    help="inflation field cap (inf_upper_bound analog)")
    ap.add_argument("--bias-alpha", type=float, default=0.2,
                    help="online bias-correction learning rate")
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force the host CPU backend (smoke tests)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from efa_xray_tpu.assimilation.adaptive_inflation import AdaptiveInflation
    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.models import l96_2d
    from efa_xray_tpu.observation import forward as _fwd
    from efa_xray_tpu.observation.bias import BiasCorrection
    from efa_xray_tpu.observation.observation import ObservationBatch
    from efa_xray_tpu.postprocess.verification import crps
    from efa_xray_tpu.state.ensemble import EnsembleState
    from efa_xray_tpu.state.structure import StateStructure
    from efa_xray_tpu.utils import timeutil

    ny, nx, nmems, nobs = args.ny, args.nx, args.nmems, args.nobs
    ngrid = ny * nx
    dtype = jnp.float32

    def pull(*xs):
        acc = jnp.sum(xs[0])
        for x in xs[1:]:
            acc = acc + jnp.sum(x)
        return float(acc)

    # --- model + geometry -------------------------------------------------
    truth, ens = l96_2d.spinup_ensemble(ny=ny, nx=nx, nmems=nmems, seed=3)
    truth = truth.astype(dtype)
    ens = ens.astype(dtype)  # [M, ny, nx]
    lat, lon = l96_2d.grid_latlon(ny, nx)
    times = np.datetime64("2026-08-01T00:00:00") + np.arange(1)
    structure = StateStructure.build(["X"], times, lat, lon, nmems)

    # --- stationary off-grid network (taps cached once, like production) --
    rng = np.random.default_rng(11)
    ob_lats = rng.uniform(-58.0, 58.0, nobs)
    ob_lons = rng.uniform(0.0, 360.0, nobs)
    times_s = timeutil.to_epoch_seconds(np.repeat(times[0], nobs))
    taps = _fwd.build_taps(
        structure, ob_lats, ob_lons, times_s,
        np.zeros(nobs, dtype=np.int32),
    )

    cfg = FilterConfig(
        localization="GC", dtype="float32", fast_geometry=True,
        outlier_threshold=4.0,
        adaptive_sd_evolve=True, adaptive_sd_min=0.15,
        # The network is deliberately biased and only partially
        # bias-corrected online, so innovations systematically exceed the
        # expected variance; undamped adaptive inflation ratchets upward
        # on that residual until the L96-2d forecast leaves the attractor
        # (measured: NaN by cycle 2).  DART-style damping PLUS a field cap
        # (inf_upper_bound analog) are both required: points observed
        # only peripherally (gamma << 1) integrate the network's excess
        # innovations multiplicatively — measured x2/cycle at the field
        # max, which outruns any damping factor.  The defaults are the
        # CALIBRATED operating point (damp 0.7 / cap 1.7 at the default
        # 320x320/8k-obs scale: spread/RMSE near 1, where the survival
        # recipe 0.9/4.0 was overdispersive with the field pinned at
        # 1 + damp*(cap-1)); scan table in docs/recipes.md.
        adaptive_damp=args.damp,
        adaptive_max=args.adaptive_max,
    )
    adapt = AdaptiveInflation(
        EnsembleState(jnp.transpose(ens, (1, 2, 0))[None, None], structure),
        ("adaptive", "/nonexistent.nc", (1.0, 0.6)),
    )
    bias = BiasCorrection(alpha=args.bias_alpha)

    def make_batch(values):
        return ObservationBatch(
            values=values,
            errors=np.ones(nobs),
            lats=ob_lats,
            lons=ob_lons,
            times_s=times_s,
            obtypes=["X"] * nobs,
            localize_radius=np.full(nobs, args.radius),
            assimilate_flags=np.ones(nobs, bool),
            verts=np.full(nobs, np.nan),
            descriptions=[None] * nobs,
        )

    phases_hist = []
    rmse_hist, spread_hist, crps_hist, nrej_hist = [], [], [], []
    est_bias_hist = []
    t_taps0 = None
    wall0 = time.perf_counter()

    for c in range(args.cycles):
        ph = {}
        # -- forecast ------------------------------------------------------
        t0 = time.perf_counter()
        truth = l96_2d.integrate(truth, nsteps=4)
        ens = l96_2d.integrate(ens, nsteps=4)
        pull(truth, ens[:, 0, 0])
        ph["forecast"] = time.perf_counter() - t0

        # -- synthetic obs: H(truth) + noise + a constant network bias -----
        t0 = time.perf_counter()
        ye_t = _fwd.apply_taps_obj(truth.reshape(ngrid, 1), taps)[:, 0]
        raw_values = (np.asarray(ye_t, dtype=np.float64)
                      + rng.normal(0.0, 1.0, nobs) + args.ob_bias)
        # online bias correction before assimilation (returns a copy)
        batch = bias.correct(make_batch(raw_values))
        ph["obgen"] = time.perf_counter() - t0

        # -- analysis through the public API -------------------------------
        t0 = time.perf_counter()
        state = EnsembleState(
            jnp.transpose(ens, (1, 2, 0))[None, None], structure
        )
        filt = EnSRF(state, batch, inflation=adapt, config=cfg,
                     verbose=False)
        if c == 0:
            tt = time.perf_counter()
            filt.build_taps()
            t_taps0 = time.perf_counter() - tt
        post, out_batch = filt.update()
        pull(post.data)
        ph["update"] = time.perf_counter() - t0
        # adaptive-inflation learning happens inside update(); attribute
        # the host-side moment write-back separately via the batch pull:
        t0 = time.perf_counter()
        # Learn the TOTAL network bias: raw values against the filter's
        # prior estimate (bias.update's O-B convention needs uncorrected
        # values; out_batch carries the corrected ones).
        import dataclasses as _dc

        bias.update(_dc.replace(out_batch, values=raw_values))
        nrej = int(np.sum(np.asarray(out_batch.qc_outlier)
                          if out_batch.qc_outlier is not None else 0))
        ph["bias_qc"] = time.perf_counter() - t0

        # -- verification ---------------------------------------------------
        t0 = time.perf_counter()
        amean = jnp.mean(post.data[0, 0], axis=-1)
        aspread = jnp.std(post.data[0, 0], axis=-1)
        rmse = float(jnp.sqrt(jnp.mean((amean - truth) ** 2)))
        spread = float(jnp.sqrt(jnp.mean(aspread**2)))
        _, cval = crps(post, batch)
        ph["verify"] = time.perf_counter() - t0

        ens = jnp.transpose(post.data[0, 0], (2, 0, 1))
        rmse_hist.append(rmse)
        spread_hist.append(spread)
        crps_hist.append(cval)
        nrej_hist.append(nrej)
        est_bias_hist.append(bias.offset_for("X"))
        phases_hist.append(ph)
        print(json.dumps({"cycle": c, "rmse": round(rmse, 4),
                          "spread": round(spread, 4),
                          "crps": round(cval, 4), "qc_rejected": nrej,
                          "est_bias": round(bias.offset_for("X"), 4),
                          **{k: round(v, 4) for k, v in ph.items()}}),
              flush=True)

    wall = time.perf_counter() - wall0
    late = phases_hist[-3:]
    late_mean = {k: float(np.mean([p[k] for p in late]))
                 for k in late[0]}
    half = len(rmse_hist) // 2
    result = {
        "config": "13-cycled-production",
        "backend": jax.default_backend(),
        "ngrid": ngrid, "nmems": nmems, "nobs": nobs,
        "ncycles": args.cycles,
        "wall_seconds": wall,
        "taps_build_seconds_first_cycle": t_taps0,
        "late_cycle_phases_seconds": late_mean,
        "late_cycle_total_seconds": float(sum(late_mean.values())),
        "mean_rmse_2nd_half": float(np.mean(rmse_hist[half:])),
        "mean_spread_2nd_half": float(np.mean(spread_hist[half:])),
        "spread_over_rmse_2nd_half": float(
            np.mean(spread_hist[half:]) / np.mean(rmse_hist[half:])),
        "mean_crps_2nd_half": float(np.mean(crps_hist[half:])),
        "ob_bias_true": args.ob_bias,
        "ob_bias_estimated_final": float(est_bias_hist[-1]),
        "localize_radius_km": args.radius,
        "adaptive_damp": args.damp,
        "adaptive_max": args.adaptive_max,
        "bias_alpha": args.bias_alpha,
        "qc_rejected_total": int(np.sum(nrej_hist)),
        "inflation_field_minmax": [
            float(np.min(adapt.mean["X"])), float(np.max(adapt.mean["X"]))],
    }
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
