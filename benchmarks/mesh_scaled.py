#!/usr/bin/env python
"""Scaled virtual-mesh run of the pod-shaped workload.

Config 10 measures the single-card number; this run exercises the SAME
sharded code path on a scaled pod-shaped workload across an 8-device
mesh — the 8-virtual-CPU-device configuration the test suite uses (the
four-card run on real GPUs is ``python chip_smoke.py --four-cards``).
It records:

* wall time on a 1-device mesh vs an 8-device mesh (NOT a speedup claim:
  the 8 virtual devices share one physical core — the point is that the
  full sharded program, with its zero-per-ob-collective invariant,
  compiles and executes the workload end to end at scale);
* 1-vs-8-device posterior parity (the dryrun's correctness cross-check,
  here at benchmark scale).

Run:  python benchmarks/mesh_scaled.py  (CPU only; ~minutes on one core)
"""

import json
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))


def main(nstate=1_048_576, nmems=80, nobs=2048, block_size=128, seed=7):
    from efa_xray_tpu.assimilation import ensrf_core as core
    from efa_xray_tpu.parallel import make_mesh
    from efa_xray_tpu.parallel.sharded import ensrf_update_sharded

    ndev = len(jax.devices())
    rng = np.random.default_rng(seed)
    dtype = jnp.float32

    body_mean = jnp.asarray(280.0 + 0.5 * rng.standard_normal(nstate), dtype)
    body_perts = jnp.asarray(5.0 * rng.standard_normal((nstate, nmems)), dtype)
    tp0 = 5.0 * rng.standard_normal((nobs, nmems))
    tail_mean = jnp.asarray(tp0.mean(axis=1) + 280.0, dtype)
    tail_perts = jnp.asarray(tp0 - tp0.mean(axis=1, keepdims=True), dtype)
    blat = jnp.asarray(rng.uniform(-88, 88, nstate), dtype)
    blon = jnp.asarray(rng.uniform(0, 360, nstate), dtype)
    ob_rows = rng.integers(0, nstate, nobs)
    obs = core.ObsArrays(
        values=jnp.asarray(280.0 + rng.normal(0, 1, nobs), dtype),
        errors=jnp.ones(nobs, dtype),
        lats=blat[ob_rows],
        lons=blon[ob_rows],
        radii=jnp.full(nobs, 2000.0, dtype),
        assim=jnp.ones(nobs, bool),
    )

    results = {}
    posts = {}
    for n in (1, ndev):
        mesh = make_mesh(jax.devices()[:n])
        run = lambda: ensrf_update_sharded(
            body_mean, body_perts, tail_mean, tail_perts, blat, blon, obs,
            mesh=mesh, localize=True, method="blocked",
            block_size=block_size,
        )
        out = jax.block_until_ready(run())  # compile + warm
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        dt = time.perf_counter() - t0
        results[n] = dt
        posts[n] = (np.asarray(out[0]), np.asarray(out[1]))
        print(f"{n}-device mesh: {dt:.2f} s", flush=True)

    dm = float(np.max(np.abs(posts[1][0] - posts[ndev][0])))
    dp = float(np.max(np.abs(posts[1][1] - posts[ndev][1])))
    scale = float(np.max(np.abs(posts[1][0])))
    print(f"posterior parity 1 vs {ndev} devices: mean {dm:.3g}, perts {dp:.3g}")
    entry = {
        "config": "pod-mesh-8dev-virtual",
        "nstate": nstate,
        "nmems": nmems,
        "nobs": nobs,
        "block_size": block_size,
        "backend": "cpu-8virtual",
        "seconds_mesh1": results[1],
        f"seconds_mesh{ndev}": results[ndev],
        "parity_mean_maxabs_1_vs_8": dm,
        "parity_perts_maxabs_1_vs_8": dp,
        "note": (
            "scaled pod-shaped workload through ensrf_update_sharded on the "
            "8-virtual-CPU-device mesh (one physical core: times show the "
            "sharded program executes at scale, not a speedup); posterior "
            "parity 1-vs-8 devices at f32. The single-card number is "
            "config 10-pod-full-1e7."
        ),
    }
    print(json.dumps(entry))
    assert dm <= 1e-4 * max(scale, 1.0) and dp <= 1e-3, (dm, dp)
    return entry


if __name__ == "__main__":
    import os

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    # XLA_FLAGS must be set before backend init; re-exec pattern not needed
    # when launched fresh: python benchmarks/mesh_scaled.py
    if len(jax.devices()) < 8:
        raise SystemExit(
            "run with XLA_FLAGS=--xla_force_host_platform_device_count=8"
        )
    main()
