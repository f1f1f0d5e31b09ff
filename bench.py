#!/usr/bin/env python
"""Headline benchmark: EnSRF assimilation throughput on one accelerator.

Metric: **obs x state-points assimilated per second** in the EnSRF update.
The workload is the headline configuration (``benchmarks/run_benchmarks.py``
config 4/10): a 1e7-row global state, 80 members, 10k localized point obs
(Gaspari-Cohn halfwidth 2000 km, Hilbert-ordered), float32, the fast
chordal geometry.  The timed step is phase 1 (blocked tail solve) plus
phase 2 (body sweep), each through the implementation that
:func:`efa_xray_tpu.ops.select.choose` picks for the device, with
``block_until_ready`` around every timed call and compilation reported
apart.

``vs_baseline`` is measured, not assumed: the reference implementation's
per-observation NumPy update (covariance contraction + rank-1 outer
update + localization weights, float64 — the ops of
``efa_xray/assimilation/ensrf.py:95,99-115,130,141``) is timed on a row
sample and extrapolated linearly in nstate and nobs.

Needs an accelerator: on a CPU-only host it exits 1 without a result.
Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}
"""

import argparse
import json
import sys
import time


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def reference_per_ob(nstate_sample=1_000_000, nmems=80, nobs_sample=4,
                     seed=0):
    """Seconds per ob of the reference's NumPy update at ``nstate_sample``
    rows (min over a few obs: robust to host contention).  Per-ob cost is
    linear in nstate."""
    import numpy as np

    from efa_xray_tpu.observation.localization import gaspari_cohn_np

    rng = np.random.default_rng(seed)
    xbp = rng.standard_normal((nstate_sample, nmems)) * 5.0
    xbm = np.full(nstate_sample, 280.0)
    lat = np.radians(rng.uniform(-88.0, 88.0, nstate_sample))
    lon = np.radians(rng.uniform(0.0, 360.0, nstate_sample))
    per_ob = []
    for _ in range(nobs_sample):
        olat, olon = np.radians(rng.uniform(-88, 88)), np.radians(rng.uniform(0, 360))
        ye = rng.standard_normal(nmems) * 5.0
        t0 = time.perf_counter()
        ye = ye - ye.mean()
        kdenom = np.var(ye) + 1.0
        kcov = xbp @ ye / (nmems - 1)
        a = (np.sin((olat - lat) / 2) ** 2
             + np.cos(lat) * np.cos(olat) * np.sin((olon - lon) / 2) ** 2)
        d = 2 * 6371.0 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))
        kmat = kcov * gaspari_cohn_np(d, 2000.0) / kdenom
        beta = 1.0 / (1.0 + np.sqrt(1.0 / kdenom))
        _ = xbm + kmat * 1.0
        _ = xbp - np.outer(beta * kmat, ye)
        per_ob.append(time.perf_counter() - t0)
    return min(per_ob)


def device_step_seconds(nstate, nmems, nobs, iters=3, seed=4):
    """(compile seconds, steady seconds per update) of tail + body."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from efa_xray_tpu.assimilation import ensrf_core as core
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.observation.localization import spatial_sort_order
    from efa_xray_tpu.ops import select
    from efa_xray_tpu.ops.ensrf_triton import body_update_donating

    cfg = FilterConfig(localization="GC", dtype="float32", fast_geometry=True)
    kern = select.choose(cfg)
    rng = np.random.default_rng(seed)
    dtype = jnp.float32
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    # Rows in Hilbert order make row tiles compact caps (culling).
    lat = rng.uniform(-88.0, 88.0, nstate)
    lon = rng.uniform(0.0, 360.0, nstate)
    ro = np.asarray(spatial_sort_order(lat, lon))
    blat = jnp.asarray(lat[ro], dtype)
    blon = jnp.asarray(lon[ro], dtype)
    rows = rng.integers(0, nstate, nobs)
    oo = np.asarray(spatial_sort_order(lat[ro][rows], lon[ro][rows]))
    rows = rows[oo]
    obs = core.ObsArrays(
        values=jnp.asarray(280.0 + rng.normal(0, 1.0, nobs), dtype),
        errors=jnp.ones(nobs, dtype),
        lats=blat[rows], lons=blon[rows],
        radii=jnp.full(nobs, 2000.0, dtype),
        assim=jnp.ones(nobs, bool),
    ).with_default_verts()

    def fresh():
        bm = 280.0 + 0.5 * jax.random.normal(keys[0], (nstate,), dtype)
        bp = 5.0 * jax.random.normal(keys[1], (nstate, nmems), dtype)
        return bm, bp, bm[rows], bp[rows]

    def step(bm, bp, tm, tp):
        tail = core.tail_scan_blocked(
            tm, tp, obs, localize=True, fast_geometry=True,
            panel=cfg.tail_panel, kernels=kern.tail)
        if kern.body:
            return body_update_donating(bm, bp, blat, blon, tail, obs,
                                        localize=True, geometry="chordal")
        return core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                       localize=True,
                                       block_size=cfg.block_size,
                                       fast_geometry=True)

    t0 = time.perf_counter()
    jax.block_until_ready(step(*fresh()))
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        args = jax.block_until_ready(fresh())
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        times.append(time.perf_counter() - t0)
    return first - min(times), float(np.median(times)), kern


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nstate", type=int, default=10_000_000)
    p.add_argument("--nobs", type=int, default=10_000)
    p.add_argument("--nmems", type=int, default=80)
    a = p.parse_args()

    import jax

    from efa_xray_tpu.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        log("no accelerator: the benchmark measures device time only")
        return 1
    compile_cache.enable()
    ref = reference_per_ob(nmems=a.nmems) * a.nstate / 1_000_000 * a.nobs
    compile_s, dt, kern = device_step_seconds(a.nstate, a.nmems, a.nobs)
    print(json.dumps({
        "metric": "ensrf_obs_statepoints_per_sec",
        "value": a.nobs * a.nstate / dt,
        "unit": "obs*points/s",
        "vs_baseline": ref / dt,
        "detail": {
            "nstate": a.nstate, "nmems": a.nmems, "nobs": a.nobs,
            "device_seconds": dt,
            "compile_seconds": compile_s,
            "reference_numpy_seconds_extrapolated": ref,
            "kernels": kern._asdict(),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
