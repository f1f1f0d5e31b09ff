"""Test harness config: virtual 8-device CPU mesh + float64.

Multi-device sharding tests run on host-platform CPU devices
(``xla_force_host_platform_device_count``) so no real card is needed;
float64 is enabled so parity tests against the NumPy oracle can hit 1e-6
RMSE tolerances (production runs use float32 — the library is
dtype-generic).  Tests marked ``gpu`` skip here; ``python chip_smoke.py``
runs them on a CUDA GPU.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

# chip_smoke.py runs the gpu-marked tests on the card with
# EFA_TESTS_ON_GPU=1; everything else runs on the CPU.
if os.environ.get("EFA_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from efa_xray_tpu.state.ensemble import EnsembleState
from efa_xray_tpu.utils import timeutil


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-executable caches after each test module.

    The suite compiles several hundred distinct XLA programs in one
    process; with all of them held live the CPU backend has been observed
    to segfault inside ``backend_compile`` late in the run (reproducibly
    at the same test, never when the module runs alone).  Bounding the
    live-executable set per module avoids it, at the price of recompiling
    the shared helpers a few times."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()


def make_demo_state(
    nvars=1,
    ntimes=3,
    ny=6,
    nx=8,
    nmems=20,
    seed=0,
    var_names=None,
    dtype="float64",
):
    """Small synthetic 2-D ensemble (GEFS-demo-scale; BASELINE config 0)."""
    rng = np.random.default_rng(seed)
    names = var_names or [f"T{i}_2m" if i else "T2m" for i in range(nvars)]
    lat1d = np.linspace(42.0, 50.0, ny)
    lon1d = np.linspace(230.0, 244.0, nx)
    lon, lat = np.meshgrid(lon1d, lat1d)
    times = np.datetime64("2026-08-01T00:00:00") + np.arange(ntimes) * np.timedelta64(
        6, "h"
    )
    field = (
        280.0
        + 5.0 * np.sin(np.radians(lat))[None, :, :, None]
        + 2.0 * np.cos(np.radians(lon))[None, :, :, None]
        + rng.normal(0, 1.5, (ntimes, ny, nx, nmems))
        + np.linspace(0, 2, ntimes)[:, None, None, None]
    )
    vardict = {}
    for i, name in enumerate(names):
        vardict[name] = field + i * 10.0 + rng.normal(0, 0.5, field.shape)
    coorddict = {"validtime": times, "lat": lat, "lon": lon, "mem": np.arange(nmems)}
    return EnsembleState.from_vardict(vardict, coorddict, dtype=dtype)


def make_demo_obs(state, nobs=5, seed=1, radius=2000.0, error=1.0, all_assim=True):
    """Synthetic point obs inside the state's space/time domain."""
    from efa_xray_tpu.observation.observation import Observation

    rng = np.random.default_rng(seed)
    s = state.structure
    obs = []
    t0, t1 = s.times_s[0], s.times_s[-1]
    for i in range(nobs):
        lat = rng.uniform(s.lat.min() + 0.5, s.lat.max() - 0.5)
        lon = rng.uniform(s.lon.min() + 0.5, s.lon.max() - 0.5)
        tsec = int(rng.uniform(t0, t1))
        obs.append(
            Observation(
                value=float(280.0 + rng.normal(0, 2.0)),
                obtype=s.var_names[i % s.nvars],
                time=timeutil.to_datetime64(tsec),
                error=error,
                lat=float(lat),
                lon=float(lon),
                assimilate_this=all_assim or (i % 2 == 0),
                localize_radius=radius,
                description=f"synthetic-{i}",
            )
        )
    return obs


@pytest.fixture
def demo_state():
    return make_demo_state()


@pytest.fixture
def demo_obs(demo_state):
    return make_demo_obs(demo_state)
