#!/usr/bin/env python
"""Public-API EnSRF at satellite-density batch sizes with auto chunking.

FilterConfig.obs_chunk=None auto-chunks >131072-ob batches into
65536-ob chunks (one compile for ANY batch size).  This measures the
chunked public path at 200k obs and above, end to end:
EnsembleState + ObservationBatch + EnSRF.update().

Usage: python benchmarks/obscap_chunked.py [--nobs-list 200000 500000]
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
    ap.add_argument("--nobs-list", type=int, nargs="*",
                    default=[200_000, 500_000])
    ap.add_argument("--ny", type=int, default=361)
    ap.add_argument("--nx", type=int, default=720)
    ap.add_argument("--nmems", type=int, default=40)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.observation.observation import ObservationBatch
    from efa_xray_tpu.state.ensemble import EnsembleState
    from efa_xray_tpu.utils import timeutil

    rng = np.random.default_rng(12)
    ny, nx, nmems = args.ny, args.nx, args.nmems
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 360.0 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(1) * np.timedelta64(6, "h")
    field = rng.normal(280, 5, (1, ny, nx, nmems)).astype(np.float32)
    state = EnsembleState.from_vardict(
        {"T2m": field},
        {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)},
        dtype="float32",
    )
    out = {"config": "12b-obs-capacity-chunked", "nstate": state.nstate(),
           "nmems": nmems, "backend": jax.default_backend(), "points": []}
    for nobs in args.nobs_list:
        batch = ObservationBatch(
            values=rng.normal(280, 5, nobs),
            errors=np.ones(nobs),
            lats=rng.uniform(-89, 89, nobs),
            lons=rng.uniform(0, 360, nobs),
            times_s=timeutil.to_epoch_seconds(np.repeat(times[0], nobs)),
            obtypes=["T2m"] * nobs,
            localize_radius=np.full(nobs, 2000.0),
            assimilate_flags=np.ones(nobs, bool),
            verts=np.full(nobs, np.nan),
            descriptions=[None] * nobs,
        )
        # Spatial-locality obs order (the caller's choice in a serial
        # filter): config 12's one-shot capacity table Hilbert-sorts both
        # rows and obs, and the kernels' localization culling only
        # engages on spatially compact obs blocks.
        batch, _ = batch.spatial_sort()
        cfg = FilterConfig(localization="GC", dtype="float32",
                           fast_geometry=True)
        pt = {"nobs": nobs, "obs_chunk": "auto(65536)", "obs_order": "hilbert"}
        try:
            def one():
                filt = EnSRF(state, batch, config=cfg, verbose=False)
                t0 = time.perf_counter()
                post, _ = filt.update()
                _ = float(jnp.sum(post.data))
                return time.perf_counter() - t0

            one()  # warm (one compile regardless of batch size)
            pt["seconds"] = min(one() for _ in range(2))
            pt["obs_points_per_sec"] = nobs * state.nstate() / pt["seconds"]
        except Exception as e:
            pt["error"] = repr(e)[:200]
        out["points"].append(pt)
        print(json.dumps(pt), flush=True)
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
