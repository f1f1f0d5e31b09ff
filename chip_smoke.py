#!/usr/bin/env python
"""Run the EnSRF main path once on a GPU at full size, and check it.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded headline only

Every phase goes through the entry points a user calls
(``EnsembleState.from_vardict``, ``EnSRF``/``LETKF``/``EnKF(...).update()``,
``CyclingHarness.run``) with data drawn from a seed, and prints its wall
time after ``block_until_ready``, its compile time apart, and each
comparison with its bound and the matmul precision it holds for:

1. ``gpu``-marked tests: the compiled Triton kernels against the Pallas
   interpreter (a pytest child that runs before this process opens the
   card, so that one process at a time holds it).
2. Headline (``benchmarks/run_benchmarks.py`` config 4/10): a 2500 x 4000
   lat-lon grid (1e7 rows), one variable, 80 members, 10k point obs at a
   Gaspari-Cohn halfwidth of 2000 km in Hilbert order, exact geometry.
   The kernel path against the XLA blocked body and tail on the same
   inputs: posterior mean within 1e-3 x increment RMS under
   ``matmul_precision="highest"`` and 1e-2 under the default (TF32);
   perturbations to the same bounds against their own increment RMS.
3. The headline with ``fast_geometry=True``, against phase 2's posterior.
4. ``method="serial"`` against ``"blocked"`` on the full state, 1k obs.
5. A few cycles of the Lorenz-96 harness (config 1).
6. ``LETKF`` and ``EnKF`` on the 0.5-degree global grid (config 2:
   260k points x 40 members, 2k obs).
7. ``FilterConfig(dtype="float64")`` against ``tests/oracle_numpy.py`` at
   demo and config-2 size, within 1e-9.

It exits 1 without a result line when the repository is missing or JAX
finds no GPU, and when any phase fails or misses a bound.  The last line
of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(ny=2500, nx=4000, nmems=80, nobs=10_000, radius=2000.0)
RESULTS = {"phases": {}}  # written by --results


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """Name and power limit of the cards, read by nvidia-smi (a child
    without JAX); fails when there is none."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"no GPU: nvidia-smi did not run ({e})")
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"no GPU: nvidia-smi says {r.stderr.strip()!r}")
    return r.stdout.strip()


class Phase:
    """Wall time of a phase after block_until_ready, with the seconds
    XLA spent compiling inside it (backend compile, kernels included)
    counted apart."""

    compile_s = 0.0
    _listening = False

    def __init__(self, name: str):
        self.name = name
        self.checks = []
        self.record = RESULTS["phases"].setdefault(name, {"checks": {}})
        if not Phase._listening:
            import jax

            def on_event(event, duration, **_):
                if event == "/jax/core/compile/backend_compile_duration":
                    Phase.compile_s += duration

            jax.monitoring.register_event_duration_secs_listener(on_event)
            Phase._listening = True

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = Phase.compile_s
        say(f"== {self.name}")
        return self

    def check(self, label: str, value: float, bound: float) -> None:
        ok = bool(value <= bound)
        self.checks.append(ok)
        self.record["checks"][label] = {"value": value, "bound": bound}
        say(f"   {label}: {value:.3e} <= {bound:.1e} {'ok' if ok else 'MISSED'}")

    def note(self, key: str, seconds: float, text: str) -> None:
        """Print and record one timing (seconds) of the phase."""
        self.record[key] = seconds
        say(f"   {text}: {seconds:.4f} s")

    def __exit__(self, *exc):
        import jax

        wall = time.perf_counter() - self.t0
        comp = Phase.compile_s - self.c0
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        self.record.update(wall_s=wall, compile_s=comp, peak_bytes=peak)
        say(f"   {self.name}: wall {wall:.2f} s (compile {comp:.2f} s, "
            f"rest {wall - comp:.2f} s); peak_bytes_in_use {peak}")
        if exc[0] is None and not all(self.checks):
            fail(f"{self.name}: a bound was missed")
        return False


def timed(fn):
    """(result, seconds) of fn() with the result ready on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def rel_rms(got, want, prior):
    """RMS(got - want) / RMS(want - prior) for the member mean and for
    the perturbations, on device."""
    import jax.numpy as jnp

    def split(a):
        m = jnp.mean(a, axis=-1)
        return m, a - m[..., None]

    gm, gp = split(got)
    wm, wp = split(want)
    pm, pp = split(prior)
    rms = lambda x: jnp.sqrt(jnp.mean(jnp.square(x)))
    return (float(rms(gm - wm) / rms(wm - pm)),
            float(rms(gp - wp) / rms(wp - pp)))


# ---------------------------------------------------------------------------
# Workloads, drawn from a seed
# ---------------------------------------------------------------------------


def grid_state(ny, nx, nmems, seed, dtype="float32"):
    """One variable on a regular lat-lon grid: a smooth background plus
    members made of large-scale waves (so that sample covariances carry
    real structure) and small-scale noise, drawn on the device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from efa_xray_tpu.state.ensemble import EnsembleState

    lat1 = np.linspace(-89.95, 89.95, ny)
    lon1 = np.arange(nx) * (360.0 / nx)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    latr = jnp.radians(jnp.asarray(lat1, jnp.float32))[:, None, None]
    lonr = jnp.radians(jnp.asarray(lon1, jnp.float32))[None, :, None]
    nwave = 6
    amp = jax.random.normal(k1, (nwave, nmems), jnp.float32)
    phase = jax.random.uniform(k2, (nwave, nmems), jnp.float32, 0, 6.2832)
    field = 280.0 + 15.0 * jnp.cos(latr)
    for k in range(nwave):
        field = field + 1.5 * amp[k] * jnp.cos(latr) * jnp.sin(
            (k + 1) * lonr + phase[k] + (k + 1) * latr)
    field = field + 0.5 * jax.random.normal(k3, (ny, nx, nmems), jnp.float32)
    lon, lat = np.meshgrid(lon1, lat1)
    times = np.array([np.datetime64("2026-08-01T00:00:00")])
    return EnsembleState.from_vardict(
        {"T2m": np.asarray(field)[None]},
        {"validtime": times, "lat": lat, "lon": lon,
         "mem": np.arange(nmems)},
        dtype=dtype,
    )


def point_obs(state, nobs, radius, seed, error=1.0):
    """Point obs at random grid points (prior mean + noise), in
    spherical-Hilbert order."""
    import numpy as np

    from efa_xray_tpu.observation.observation import ObservationBatch

    rng = np.random.default_rng(seed)
    st = state.structure
    lat, lon = st.row_latlon()
    rows = rng.choice(lat.shape[0], nobs, replace=False)
    mean = np.asarray(state.data[0, 0].reshape(-1, st.nmems)[rows].mean(1))
    batch = ObservationBatch(
        values=mean + rng.normal(0, 1.5, nobs),
        errors=np.full(nobs, error),
        lats=np.asarray(lat)[rows],
        lons=np.asarray(lon)[rows],
        times_s=np.repeat(np.asarray(st.times_s)[:1], nobs),
        obtypes=["T2m"] * nobs,
        localize_radius=np.full(nobs, radius),
        assimilate_flags=np.ones(nobs, bool),
        verts=np.full(nobs, np.nan),
        descriptions=[None] * nobs,
    )
    return batch.spatial_sort()[0]


def run_filter(cls, state, batch, **cfg):
    """(posterior data, obs batch) of ``cls(state, batch).update()``."""
    from efa_xray_tpu.config import FilterConfig

    config = FilterConfig(localization="GC", **cfg)
    post, obs = cls(state, batch, config=config, verbose=False).update()
    return post.data, obs


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_gpu_tests():
    """pytest -m gpu in a child, before this process opens the card."""
    with_env = dict(os.environ, EFA_TESTS_ON_GPU="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(HERE, "tests")],
        cwd=HERE, env=with_env, capture_output=True, text=True, timeout=900)
    tail = (r.stdout.strip().splitlines() or [""])[-1]
    say(f"== gpu-marked tests: rc {r.returncode}: {tail}")
    if r.returncode != 0 or " passed" not in tail or "skipped" in tail:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        fail("gpu-marked tests did not all run and pass")


def print_memory_analysis(ny, nx, nmems, nobs):
    """compiled.memory_analysis() of the headline body step, compiled
    ahead of time from shapes."""
    import jax
    import jax.numpy as jnp

    from efa_xray_tpu.assimilation import ensrf_core as core
    from efa_xray_tpu.ops.ensrf_triton import body_update_donating

    n = ny * nx
    sds = lambda *s, d=jnp.float32: jax.ShapeDtypeStruct(s, d)
    vec = lambda: sds(nobs)
    tail = core.TailSolution(
        ye=sds(nobs, nmems), gain_coef=vec(), sqrt_coef=vec(),
        tail_mean=vec(), tail_perts=sds(nobs, nmems),
        diags=core.ObsDiagnostics(vec(), vec(), vec(), vec(),
                                  sds(nobs, d=jnp.bool_)))
    obs = core.ObsArrays(vec(), vec(), vec(), vec(), vec(),
                         sds(nobs, d=jnp.bool_), vec(), vec())
    compiled = body_update_donating.lower(
        sds(n), sds(n, nmems), sds(n), sds(n), tail, obs,
        localize=True, geometry="haversine").compile()
    mem = compiled.memory_analysis()
    RESULTS["headline_body_memory_analysis"] = {
        k: getattr(mem, k) for k in ("argument_size_in_bytes",
                                     "output_size_in_bytes",
                                     "alias_size_in_bytes",
                                     "temp_size_in_bytes")}
    say(f"headline body step memory_analysis: {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"peak_bytes_in_use before the phases: "
        f"{stats.get('peak_bytes_in_use')}")


def phase_headline(state, batch):
    """Kernels vs XLA at the headline, exact geometry; returns the default
    kernel posterior for phase 3."""
    import jax

    from efa_xray_tpu.assimilation.ensrf import EnSRF

    prior = state.data
    with Phase("headline, exact geometry, kernels vs XLA") as ph:
        (post, obs), t1 = timed(lambda: run_filter(EnSRF, state, batch))
        (post, obs), t2 = timed(lambda: run_filter(EnSRF, state, batch))
        ph.note("kernel_first_s", t1, "kernel update, first call")
        ph.note("kernel_steady_s", t2, "kernel update, second call")
        if not bool(jax.numpy.isfinite(post).all()):
            fail("non-finite headline posterior")
        for prec, bound in (("highest", 1e-3), (None, 1e-2)):
            label = prec or "default (TF32)"
            if prec:
                (kpost, _), tk = timed(lambda: run_filter(
                    EnSRF, state, batch, matmul_precision=prec))
                ph.note(f"kernel_{prec}_first_s", tk,
                        f"kernel update at {label}, first call")
            else:
                kpost = post
            (xpost, _), tx = timed(lambda: run_filter(
                EnSRF, state, batch, use_pallas=False, tail_pallas=False,
                matmul_precision=prec))
            ph.note(f"xla_{prec or 'default'}_first_s", tx,
                    f"XLA update at {label}, first call")
            em, ep = rel_rms(kpost, xpost, prior)
            ph.check(f"kernel vs XLA mean, {label}, rms err / incr rms",
                     em, bound)
            ph.check(f"kernel vs XLA perts, {label}, rms err / incr rms",
                     ep, bound)
            del xpost
    return post


def phase_fast_geometry(state, batch, exact_post):
    from efa_xray_tpu.assimilation.ensrf import EnSRF

    with Phase("headline, fast_geometry=True, kernels") as ph:
        (post, _), t1 = timed(lambda: run_filter(EnSRF, state, batch,
                                                 fast_geometry=True))
        (post, _), t2 = timed(lambda: run_filter(EnSRF, state, batch,
                                                 fast_geometry=True))
        ph.note("kernel_first_s", t1, "kernel update, first call")
        ph.note("kernel_steady_s", t2, "kernel update, second call")
        em, ep = rel_rms(post, exact_post, state.data)
        ph.check("chordal vs exact geometry mean, default, rms err / incr rms",
                 em, 1e-2)
        ph.check("chordal vs exact geometry perts, default, rms err / incr rms",
                 ep, 1e-2)


def phase_serial_vs_blocked(state, batch):
    import numpy as np

    from efa_xray_tpu.assimilation.ensrf import EnSRF

    sub = batch.take(np.arange(1000))
    with Phase("serial vs blocked, full state, 1k obs, highest") as ph:
        (blk, _), tb = timed(lambda: run_filter(
            EnSRF, state, sub, matmul_precision="highest"))
        (ser, _), ts = timed(lambda: run_filter(
            EnSRF, state, sub, method="serial", matmul_precision="highest"))
        ph.note("blocked_first_s", tb, "blocked (kernels), first call")
        ph.note("serial_first_s", ts, "serial scan, first call")
        em, ep = rel_rms(blk, ser, state.data)
        ph.check("blocked vs serial mean, highest, rms err / incr rms", em,
                 1e-3)
        ph.check("blocked vs serial perts, highest, rms err / incr rms", ep,
                 1e-3)


def phase_lorenz96(ncycles=8):
    import numpy as np

    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.models import lorenz96 as l96
    from efa_xray_tpu.models.cycling import CyclingHarness

    with Phase("Lorenz-96 cycling (config 1)") as ph:
        truth, ens = l96.spinup_ensemble(nvars=40, nmems=20, seed=1)
        lats, lons = l96.fake_latlon(40)
        h = CyclingHarness(
            forecast=lambda x: l96.integrate(x, nsteps=4),
            state_lats=lats, state_lons=lons, ob_error=1.0,
            localize_radius=8000.0,
            config=FilterConfig(localization="GC", dtype="float32"),
            obs_operator_rows=np.arange(0, 40, 2),
            adaptive_inflation=True, adaptive_sd=0.6,
            adaptive_sd_evolve=True, adaptive_sd_min=0.15,
        )
        t0 = time.perf_counter()
        stats = h.run(ens, truth, ncycles=ncycles, seed=100)
        ph.note("cycles_s", time.perf_counter() - t0,
                f"{ncycles} cycles (compiles included)")
        an = np.array([s.analysis_rmse for s in stats])
        bg = np.array([s.background_rmse for s in stats])
        say(f"   analysis rmse {an.mean():.3f}, background rmse {bg.mean():.3f}")
        if not (np.isfinite(an).all() and np.isfinite(bg).all()):
            fail("non-finite Lorenz-96 statistics")
        ph.check("mean analysis rmse / mean background rmse", an.mean() / bg.mean(),
                 1.0)


def innovation_ratio(obs):
    """RMS(y - posterior mean) / RMS(y - prior mean) over assimilated obs."""
    import numpy as np

    ok = np.asarray(obs.assimilated, bool)
    d_post = np.asarray(obs.values - obs.post_mean)[ok]
    d_prior = np.asarray(obs.values - obs.prior_mean)[ok]
    return float(np.sqrt(np.mean(d_post ** 2) / np.mean(d_prior ** 2)))


def phase_letkf_enkf():
    import jax.numpy as jnp

    from efa_xray_tpu.assimilation.enkf import EnKF
    from efa_xray_tpu.assimilation.letkf import LETKF

    state = grid_state(361, 720, 40, seed=2)
    batch = point_obs(state, 2000, 2000.0, seed=3)
    with Phase("LETKF, config 2 (260k x 40, 2k obs)") as ph:
        (post, obs), t1 = timed(lambda: run_filter(LETKF, state, batch))
        (post, obs), t2 = timed(lambda: run_filter(LETKF, state, batch))
        ph.note("letkf_first_s", t1, "LETKF update, first call")
        ph.note("letkf_steady_s", t2, "LETKF update, second call")
        if not bool(jnp.isfinite(post).all()):
            fail("non-finite LETKF posterior")
        ph.check("LETKF innovation rms, posterior / prior", innovation_ratio(obs),
                 0.95)
    with Phase("EnKF, config 2, blocked vs serial, highest") as ph:
        (blk, obs), t1 = timed(lambda: run_filter(
            EnKF, state, batch, matmul_precision="highest"))
        (ser, _), t2 = timed(lambda: run_filter(
            EnKF, state, batch, method="serial", matmul_precision="highest"))
        ph.note("blocked_first_s", t1, "EnKF blocked, first call")
        ph.note("serial_first_s", t2, "EnKF serial, first call")
        ph.check("EnKF innovation rms, posterior / prior", innovation_ratio(obs),
                 0.95)
        em, ep = rel_rms(blk, ser, state.data)
        ph.check("EnKF blocked vs serial mean, highest, rms err / incr rms", em,
                 1e-3)
        ph.check("EnKF blocked vs serial perts, highest, rms err / incr rms",
                 ep, 1e-3)


def phase_float64_oracle():
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracle_numpy as oracle

    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.observation import forward as fwd

    jax.config.update("jax_enable_x64", True)
    for name, (ny, nx, nmems, nobs) in (("demo", (6, 8, 20, 5)),
                                        ("config 2", (361, 720, 40, 2000))):
        state = grid_state(ny, nx, nmems, seed=7, dtype="float64")
        batch = point_obs(state, nobs, 2000.0, seed=8)
        with Phase(f"float64 vs NumPy oracle, {name}") as ph:
            (post, obs), t = timed(lambda: run_filter(
                EnSRF, state, batch, dtype="float64"))
            ph.note("float64_first_s", t, "float64 update, first call")
            st = state.structure
            prior = np.asarray(state.to_vect(), np.float64)
            taps = fwd.build_taps(st, batch.lats, batch.lons, batch.times_s,
                                  batch.var_indices(st))
            ye = np.asarray(fwd.apply_taps_obj(jax.numpy.asarray(prior), taps))
            lat, lon = st.row_latlon()
            want, _ = oracle.serial_ensrf(
                prior, ye, batch.values, batch.errors, batch.lats, batch.lons,
                batch.localize_radius, np.asarray(lat), np.asarray(lon),
                np.asarray(batch.assimilate_flags & np.asarray(taps.qc_ok)),
                localize=True)
            got = np.asarray(post).reshape(-1, nmems)
            rmse = float(np.sqrt(np.mean((got - want) ** 2)))
            ph.check("posterior rmse vs oracle, float64", rmse, 1e-9)


def phase_four_cards():
    """The headline sharded over four cards against the one-card
    posterior of the same inputs, and the compiled sharded program
    checked for collectives."""
    import jax
    import jax.numpy as jnp

    from efa_xray_tpu.assimilation.ensrf import EnSRF
    from efa_xray_tpu.config import FilterConfig
    from efa_xray_tpu.ops import select
    from efa_xray_tpu.parallel import make_mesh
    from efa_xray_tpu.parallel.mesh import STATE_AXIS
    from efa_xray_tpu.parallel.sharded import _ensrf_sharded_jit

    h = HEADLINE
    state = grid_state(h["ny"], h["nx"], h["nmems"], seed=0)
    batch = point_obs(state, h["nobs"], h["radius"], seed=1)
    cfg = FilterConfig(localization="GC", dtype="float32")
    mesh = make_mesh()
    with Phase(f"headline on {mesh.devices.size} cards vs one card") as ph:
        def update(**kw):
            return EnSRF(state, batch, config=cfg, verbose=False,
                         **kw).update()

        (one, _), t1 = timed(update)
        (many, _), t4 = timed(lambda: update(mesh=mesh))
        (many, _), t4b = timed(lambda: update(mesh=mesh))
        ph.note("one_card_first_s", t1, "one card, first call")
        ph.note("cards_first_s", t4, f"{mesh.devices.size} cards, first call")
        ph.note("cards_steady_s", t4b,
                f"{mesh.devices.size} cards, second call")
        em, ep = rel_rms(many.data, one.data, state.data)
        ph.check("sharded vs one card mean, default, rms err / incr rms", em,
                 1e-3)
        ph.check("sharded vs one card perts, default, rms err / incr rms", ep,
                 1e-3)
        filt = EnSRF(state, batch, config=cfg, verbose=False, mesh=mesh)
        bm, bp, tm, tp = filt.format_prior_state()
        lat, lon = state.structure.row_latlon_device(jnp.float32)
        hlo = _ensrf_sharded_jit.lower(
            bm, bp, tm, tp, lat, lon, jnp.zeros_like(bm),
            filt.obs_arrays().with_default_verts(), jnp.zeros_like(bm),
            jnp.zeros_like(tm), mesh=mesh, localize=True, method="blocked",
            block_size=cfg.block_size, axis_name=STATE_AXIS, unbiased=False,
            kernels=select.choose(cfg), fast_geometry=False, vertical=False,
            tail_panel=cfg.tail_panel, cull=True, spatial_sort=False,
            hybrid_alpha=1.0, static_length=0.0,
        ).compile().as_text()
        found = [op for op in ("all-reduce", "all-gather",
                               "collective-permute", "all-to-all",
                               "reduce-scatter") if op in hlo]
        say(f"   collectives in the compiled sharded update: {found or 'none'}")
        ph.check("collective ops in the sharded obs loop", len(found), 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded headline on four cards")
    ap.add_argument("--results", default=None, metavar="PATH",
                    help="also write the measured numbers as JSON to PATH")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    try:
        from efa_xray_tpu.utils import compile_cache
    except ImportError as e:
        fail(f"the efa_xray_tpu package is not beside this script ({e})")

    card = card_line()
    say(card)
    RESULTS["card"] = card
    if not args.four_cards:
        phase_gpu_tests()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX found platform {devs[0].platform!r}")
    if args.four_cards and len(devs) != 4:
        fail(f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    say(f"jax {jax.__version__}; devices {devs}; compile cache "
        f"{compile_cache.enable()}")

    if args.four_cards:
        phase_four_cards()
    else:
        h = HEADLINE
        print_memory_analysis(h["ny"], h["nx"], h["nmems"], h["nobs"])
        t0 = time.perf_counter()
        state = grid_state(h["ny"], h["nx"], h["nmems"], seed=0)
        batch = point_obs(state, h["nobs"], h["radius"], seed=1)
        say(f"headline data drawn and placed in "
            f"{time.perf_counter() - t0:.2f} s")
        exact = phase_headline(state, batch)
        phase_fast_geometry(state, batch, exact)
        del exact
        phase_serial_vs_blocked(state, batch)
        del state, batch
        phase_lorenz96()
        phase_letkf_enkf()
        phase_float64_oracle()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if args.results:
        RESULTS.update(device=device, jax=jax.__version__)
        with open(args.results, "w") as fh:
            json.dump(RESULTS, fh, indent=1)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
