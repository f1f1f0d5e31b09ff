#!/usr/bin/env python
"""Cold forward-operator build A/B: separable-grid host search vs device.

The module-level taps cache amortizes rebuilds across cycles, but the COLD
``build_taps`` on a fresh observation network can dominate the end-to-end
cost at config-5 scale, and that cost is the full-grid nearest-point
``top_k`` on device.  ``taps_search="auto"`` resolves separable lat x lon
product grids (configs 2/3/5 and every regular real-data grid) with exact
host-side index arithmetic instead: this script measures both paths cold
at config-5 scale (260k-point global 0.5 deg grid, 2000 obs) and at
config-3 obs count (5000 obs), and checks the taps agree.

Run:  python benchmarks/taps_search_ab.py [--json out]
"""

from __future__ import annotations

import argparse
import json
import time

import os
import sys

import numpy as np
import jax

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))

from efa_xray_tpu.observation import forward as fwd  # noqa: E402
from efa_xray_tpu.state.structure import StateStructure
from efa_xray_tpu.utils import timeutil


def _structure(ny=361, nx=720, ntimes=1):
    lat1d = np.linspace(-90, 90, ny)
    lon1d = np.arange(0, 360, 360.0 / nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00") + np.arange(ntimes) * np.timedelta64(6, "h")
    return StateStructure.build(["T2m"], times, lat, lon, nmems=40)


def _pull(taps):
    np.asarray(taps.rows)
    np.asarray(taps.weights)


def one(structure, nobs, seed=5):
    rng = np.random.default_rng(seed)
    lats = rng.uniform(-89, 89, nobs)
    lons = rng.uniform(0, 360, nobs)
    times_s = timeutil.to_epoch_seconds(
        np.repeat(structure.times64()[0], nobs))
    var_idx = np.zeros(nobs, dtype=np.int64)

    out = {"nobs": nobs, "ngrid": structure.ngrid}
    taps = {}
    for search in ("device", "auto"):
        # warm compiles/dispatch caches with a DIFFERENT batch so the
        # timed run is a cold network but not a cold compile
        fwd.build_taps(structure, lats + 0.25, lons, times_s, var_idx,
                       search=search)
        t0 = time.perf_counter()
        taps[search] = fwd.build_taps(
            structure, lats, lons, times_s, var_idx, search=search)
        _pull(taps[search])
        out[f"seconds_{search}"] = time.perf_counter() - t0
    # order-free operator equality on a random member vector
    x = rng.normal(size=(structure.nstate, 3))
    ya = np.asarray(fwd.apply_taps_obj(jax.numpy.asarray(x), taps["auto"]))
    yd = np.asarray(fwd.apply_taps_obj(jax.numpy.asarray(x), taps["device"]))
    out["maxabs_ye_delta"] = float(np.max(np.abs(ya - yd)))
    out["speedup"] = out["seconds_device"] / out["seconds_auto"]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    print(f"backend: {jax.default_backend()}", flush=True)
    s = _structure()
    entries = []
    for nobs in (2000, 5000):
        e = {"config": f"taps-search-ab-{nobs}obs", **one(s, nobs),
             "backend": jax.default_backend()}
        entries.append(e)
        print(json.dumps(e), flush=True)
        assert e["maxabs_ye_delta"] < 1e-9, e
    if args.json:
        with open(args.json, "w") as f:
            json.dump(entries, f, indent=1)


if __name__ == "__main__":
    main()
