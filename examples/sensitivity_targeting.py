#!/usr/bin/env python
"""Ensemble sensitivity analysis + observation targeting — the EFA
companion workflow (Madaus & Hakim 2015 pair EFA with ensemble
sensitivity; the reference implements neither tool).

1. Define a scalar forecast metric J: the area-mean of the LAST lead
   time over a verification box (per-member values — trajectory EFA
   means early-lead obs move it through time covariances).
2. Map where J is sensitive: ``dJ/dx = cov(x, J)/var(x)`` over the whole
   state in one device matvec, with a t-test significance mask
   (Torn & Hakim 2008).
3. Score a network of CANDIDATE early-lead observations by predicted
   metric-variance reduction (Ancell & Hakim 2007) and pick the best.
4. Assimilate the winner with the EnSRF and confirm the realized change
   in J matches the prediction (exact for one unlocalized ob + a linear
   metric — the square-root gain identity).

Run: ``python examples/sensitivity_targeting.py [--ncand 200] [--plot]``
"""

import argparse

import numpy as np

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from efa_xray_tpu import EnSRF, Observation
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.postprocess import (
    ensemble_sensitivity,
    observation_impact,
    region_mean_metric,
)
from efa_xray_tpu.utils.demo_data import gefs_like_state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncand", type=int, default=200)
    ap.add_argument("--plot", action="store_true",
                    help="save sensitivity_map.png (matplotlib)")
    from efa_xray_tpu.utils.demo import add_platform_arg, apply_platform

    add_platform_arg(ap)
    args = ap.parse_args()
    apply_platform(args)

    # the realized-vs-predicted identity check below is exact only in
    # f64; enable x64 on CPU (an accelerator run stays f32 — tolerance
    # adapts below)
    import jax

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)

    state, _truth = gefs_like_state(ntimes=8, nmems=21, seed=3,
                                    dtype="float64")
    s = state.structure
    rng = np.random.default_rng(0)

    # 1. the forecast metric: last-lead area mean over a verification box
    box_lat = (38.0, 48.0)
    box_lon = (245.0, 265.0)
    J = region_mean_metric(s.var_names[0], time_index=s.ntimes - 1,
                           lat_range=box_lat, lon_range=box_lon)
    j0 = J(state)
    print(f"metric J: last-lead mean over {box_lat}x{box_lon}; "
          f"prior mean {j0.mean():.2f} K, spread {j0.std(ddof=1):.3f} K")

    # 2. sensitivity map (all leads at once — one matvec)
    sens = ensemble_sensitivity(state, J, confidence=0.95)[s.var_names[0]]
    frac_sig = sens["significant"].mean(axis=(1, 2))
    print("significant-fraction by lead:",
          np.array2string(frac_sig, precision=2))

    # 3. candidate network at the FIRST lead; score and rank
    cands = [
        Observation(
            value=float(285.0 + rng.normal(0, 2)), obtype=s.var_names[0],
            time=s.times64()[0], error=1.0,
            lat=float(rng.uniform(s.lat.min(), s.lat.max())),
            lon=float(rng.uniform(s.lon.min(), s.lon.max())),
            assimilate_this=True, localize_radius=None,
        )
        for _ in range(args.ncand)
    ]
    imp = observation_impact(state, cands, J)
    best = int(imp["dJ_var_pred"].idxmin())
    row = imp.iloc[best]
    print(f"best of {args.ncand} candidates: ob #{best} at "
          f"({row['lat']:.1f}, {row['lon']:.1f}) — predicted "
          f"dVar(J) {row['dJ_var_pred']:+.4f}, dJ {row['dJ_mean_pred']:+.3f}")

    # 4. assimilate the winner; realized-vs-predicted
    cfg = FilterConfig(localization=None, dtype="float64")
    post, _ = EnSRF(state, [cands[best]], config=cfg, verbose=False).update()
    j1 = J(post)
    print(f"realized dJ {j1.mean() - j0.mean():+.3f} "
          f"(predicted {row['dJ_mean_pred']:+.3f}); metric variance "
          f"{np.var(j0, ddof=1):.4f} -> {np.var(j1, ddof=1):.4f} "
          f"(predicted change {row['dJ_var_pred']:+.4f})")
    tol = 1e-9 if np.asarray(j1).dtype == np.float64 else 1e-3
    assert abs(j1.mean() - j0.mean() - row["dJ_mean_pred"]) < tol

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 5))
        m = ax.pcolormesh(s.lon, s.lat, sens["sensitivity"][0],
                          cmap="RdBu_r", shading="auto")
        sig = sens["significant"][0]
        ax.contour(s.lon, s.lat, sig.astype(float), levels=[0.5],
                   colors="k", linewidths=0.7)
        ax.plot(row["lon"], row["lat"], "k*", ms=16, mec="w",
                label="targeted ob")
        ax.plot([box_lon[0], box_lon[1], box_lon[1], box_lon[0], box_lon[0]],
                [box_lat[0], box_lat[0], box_lat[1], box_lat[1], box_lat[0]],
                "g-", lw=2, label="metric box (last lead)")
        ax.legend(loc="lower left")
        ax.set_title("dJ/dx at lead 0 (sig. contoured), targeted ob")
        fig.colorbar(m, ax=ax, label="K per K")
        fig.savefig("sensitivity_map.png", dpi=120, bbox_inches="tight")
        print("wrote sensitivity_map.png")


if __name__ == "__main__":
    main()
