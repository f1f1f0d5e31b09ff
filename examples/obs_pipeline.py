#!/usr/bin/env python
"""Production observation pipeline: ingest -> QC/thin -> sort -> assimilate
-> diagnose -> persist.

The reference workflow constructs per-ob ``Observation`` objects by hand
and offers no preprocessing, diagnostics beyond the raw per-ob table, or
observation persistence (``efa_xray/observation/observation.py:17-36``).
This example shows the batch-first pipeline this framework adds:

1. observations arrive as a pandas DataFrame (the common operational form)
   and become an :class:`ObservationBatch` in one call;
2. superobbing + distance thinning reduce the dense network;
3. spherical Morton sorting picks the assimilation order that maximizes
   the body kernel's localization culling;
4. the filter of choice (EnSRF / EnKF / LETKF) runs with per-ob
   diagnostics recorded;
5. Desroziers (2005) consistency diagnostics check the assigned R;
6. the posterior state AND posterior obs batch persist to
   netCDF4-compatible HDF5.

Run: ``python examples/obs_pipeline.py [--solver ensrf] [--nobs 600]``
"""

import argparse
import tempfile

import numpy as np
import pandas as pd

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from efa_xray_tpu import EnKF, EnSRF, LETKF, obs_assimilation_statistics
from efa_xray_tpu.config import FilterConfig
from efa_xray_tpu.observation.observation import ObservationBatch
from efa_xray_tpu.observation.thinning import (
    sort_spatially,
    superob,
    thin_by_distance,
)
from efa_xray_tpu.postprocess import desroziers_diagnostics
from efa_xray_tpu.utils import ncio
from efa_xray_tpu.utils.demo_data import gefs_like_state


def synthetic_obs_dataframe(state, truth, nobs, r_true=1.0, seed=7):
    """Obs as a DataFrame: the truth field observed with N(0, R) noise,
    plus duplicate clusters (what superobbing and thinning are for)."""
    rng = np.random.default_rng(seed)
    s = state.structure
    truth = truth[0, :, :, 0]  # first time, first var: [ny, nx]
    iy = rng.integers(1, s.ny - 1, nobs)
    ix = rng.integers(1, s.nx - 1, nobs)
    # 20% of obs are near-duplicates of earlier ones (dense clusters)
    dup = rng.random(nobs) < 0.2
    iy[dup] = iy[np.maximum(np.nonzero(dup)[0] - 1, 0)]
    ix[dup] = ix[np.maximum(np.nonzero(dup)[0] - 1, 0)]
    return pd.DataFrame(
        {
            "value": truth[iy, ix] + rng.normal(0, np.sqrt(r_true), nobs),
            "error": r_true,
            "lat": np.asarray(s.lat)[iy, ix],
            "lon": np.asarray(s.lon)[iy, ix],
            "time": np.repeat(s.times64()[0], nobs),
            "obtype": s.var_names[0],
            "localize_radius": 1500.0,
        }
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=["ensrf", "enkf", "letkf"],
                    default="ensrf")
    ap.add_argument("--nobs", type=int, default=600)
    ap.add_argument("--nmems", type=int, default=30)
    from efa_xray_tpu.utils.demo import add_platform_arg, apply_platform

    add_platform_arg(ap)
    args = ap.parse_args()
    apply_platform(args)

    state, truth = gefs_like_state(ny=40, nx=60, nmems=args.nmems, ntimes=1)
    df = synthetic_obs_dataframe(state, truth, args.nobs)

    # 1. ingest
    batch = ObservationBatch.from_dataframe(df)
    print(f"ingested {batch.nobs} obs from DataFrame")

    # 2. preprocess: superob dense clusters, then enforce min separation
    batch = superob(batch, cell_deg=0.75)
    batch = thin_by_distance(batch, min_km=40.0)
    print(f"after superob + thinning: {batch.nobs} obs")

    # 3. assimilation order: spatial Morton sort (maximizes kernel culling)
    batch = sort_spatially(batch)

    # 4. assimilate
    cfg = FilterConfig(localization="GC", fast_geometry=True,
                       spatial_sort=True, dtype="float32")
    solver = {"ensrf": EnSRF, "enkf": EnKF, "letkf": LETKF}[args.solver]
    kwargs = {"seed": 0} if args.solver == "enkf" else {}
    filt = solver(state, batch, inflation=1.05, config=cfg, verbose=False,
                  **kwargs)
    post, out = filt.update()
    ok = np.asarray(out.assimilated, bool)
    print(f"assimilated {int(ok.sum())}/{out.nobs} obs with {args.solver}")

    # 5. diagnostics
    stats = obs_assimilation_statistics(state, post, out)
    dd = desroziers_diagnostics(stats)
    print(dd[["nobs", "R_assigned", "R_estimated", "R_ratio",
              "innov_consistency"]].to_string())

    # 6. persist
    with tempfile.TemporaryDirectory() as td:
        ncio.write_state(f"{td}/posterior.nc", post)
        ncio.write_obs(f"{td}/obs_posterior.nc", out)
        back = ncio.read_obs(f"{td}/obs_posterior.nc")
        assert np.allclose(back.post_mean, out.post_mean)
        print(f"persisted posterior state + obs (round-trip checked)")


if __name__ == "__main__":
    main()
